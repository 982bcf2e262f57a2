"""A float64 replay, on the CPU, of the order of work of the attention pair's
kernels (`digat_tpu_torch/csrc/msa_attention.cu`), against the plain
versions `_attention_plain` and `attention_bwd_plain`:

  * the forward's online softmax over tiles of `TILE` keys, a lane per
    query row in chunks of 32 rows: -inf past L, -1e9 for masked keys, the
    running max, sum and accumulator rescaled tile by tile;
  * the backward at L <= 32: pass 1 (scores and the row max, then
    e = exp(s - m), the sum, dp and t, then p, ds and dq) and pass 2 (dk and
    dv over the rows in order);
  * the backward at L > 32: part 1 (each row's max, sum and t online over
    key tiles, then dq with the scores recomputed) and part 2, the
    transposed pass (dk and dv by key, over the rows in order).

At L in {1, 31, 32, 33, 50, 150}, with a sequence whose keys are all masked;
max |replay - plain| <= 1e-12 * max(1, max |plain|) in float64, where only
summation order differs. Also the row stride of shared memory (one bank per
lane), and the choices the wrapper shares with the C side: the width
instantiation and load path (`launch_plan`), the warps of a block and the
caps. The wide instance (`csrc/msa_attention_wide.cu`, dk 65-128) and the
bf16 register-row instance (`csrc/msa_attention_bf16.cuh`, dk <= 64 at
bf16) have their own replays and geometry after them."""

import math

import numpy as np
import pytest
import torch

from digat_tpu_torch.ops import build
from digat_tpu_torch.ops import msa_attention as MA

TILE = 16  # keys per step of the forward's online softmax (kTile in the .cu)
CHUNK = 32  # query rows per pass (one per lane), and the longest L that stores its scores
N, HEADS, DK = 3, 2, 5
LENGTHS = [1, 31, 32, 33, 50, 150]


def _case(L, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(N, L, HEADS * DK))) for _ in range(4))
    mask = rng.random((N, L)) < 0.7
    mask[:, 0] = True
    mask[0] = False  # all keys masked
    return q, k, v, do, torch.from_numpy(mask)


def _units(t):
    """[N, L, H * dk] -> [N * H, L, dk]: one row of the batch per warp."""
    L = t.shape[1]
    return t.reshape(N, L, HEADS, DK).permute(0, 2, 1, 3).reshape(N * HEADS, L, DK)


def _packed(u):
    L = u.shape[1]
    return u.reshape(N, HEADS, L, DK).permute(0, 2, 1, 3).reshape(N, L, HEADS * DK)


def _limit(ref):
    return 1e-12 * max(1.0, float(ref.abs().max()))


def replay_forward(q, k, v, keep, scale):
    """The forward kernel's order of work on units [U, L, dk]; keep [U, L]."""
    U, L, _ = q.shape
    out = torch.zeros_like(q)
    for i0 in range(0, L, CHUNK):
        rows = q[:, i0:i0 + CHUNK]  # the lanes' query rows
        R = rows.shape[1]
        m = torch.full((U, R), -math.inf, dtype=q.dtype)
        total = torch.zeros((U, R), dtype=q.dtype)
        acc = torch.zeros_like(rows)
        for j0 in range(0, L, TILE):
            s = torch.full((U, R, TILE), -math.inf, dtype=q.dtype)  # past L: -inf
            for jj in range(min(TILE, L - j0)):
                j = j0 + jj
                x = (rows * k[:, j, None, :]).sum(-1) * scale
                s[..., jj] = torch.where(keep[:, j, None], x, torch.full_like(x, MA.MASK_FILL))
            m_new = torch.maximum(m, s.max(-1).values)
            assert torch.isfinite(m_new).all()  # tile 0 holds key 0
            corr = torch.exp(m - m_new)
            total, acc, m = total * corr, acc * corr[..., None], m_new
            for jj in range(min(TILE, L - j0)):
                e = torch.exp(s[..., jj] - m_new)
                total = total + e
                acc = acc + e[..., None] * v[:, j0 + jj, None, :]
        out[:, i0:i0 + R] = acc * (1 / total)[..., None]
    return out


@pytest.mark.parametrize("L", LENGTHS)
def test_forward_online_softmax_over_key_tiles(L):
    q, k, v, _, mask = _case(L, seed=L)
    keep = mask.repeat_interleave(HEADS, 0)
    got = _packed(replay_forward(_units(q), _units(k), _units(v), keep, 1 / math.sqrt(DK)))
    want = MA._attention_plain(q, k, v, HEADS, mask)
    assert float((got - want).abs().max()) <= _limit(want)


def replay_short_pass1(q, k, v, do, keep, scale):
    """Pass 1 of the backward kernel for L <= 32 (a lane per query row):
    returns (p, ds) as [U, L keys, L rows] (the tiles P and S), t [U, L]
    and dq."""
    U, L, _ = q.shape
    P = torch.zeros((U, L, L), dtype=q.dtype)
    S = torch.zeros_like(P)
    m = torch.full((U, L), -math.inf, dtype=q.dtype)
    for j in range(L):
        x = (q * k[:, j, None, :]).sum(-1) * scale
        P[:, j] = torch.where(keep[:, j, None], x, torch.full_like(x, MA.MASK_FILL))
        m = torch.maximum(m, P[:, j])
    total = torch.zeros((U, L), dtype=q.dtype)
    tu = torch.zeros_like(total)
    for j in range(L):
        e = torch.exp(P[:, j] - m)
        dp = (do * v[:, j, None, :]).sum(-1)
        P[:, j], S[:, j] = e, dp
        total, tu = total + e, tu + e * dp
    inv = 1 / total
    t = tu * inv
    dq = torch.zeros_like(q)
    for j in range(L):
        p = P[:, j] * inv
        ds = torch.where(keep[:, j, None], p * (S[:, j] - t) * scale, torch.zeros_like(p))
        P[:, j], S[:, j] = p, ds
        dq = dq + ds[..., None] * k[:, j, None, :]
    return P, S, t, dq


def replay_short_backward(q, k, v, do, keep, scale):
    """Pass 1, then pass 2 (a lane per key, the rows in order): (dq, dk, dv)."""
    P, S, _, dq = replay_short_pass1(q, k, v, do, keep, scale)
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for r in range(q.shape[1]):
        dk = dk + S[:, :, r, None] * q[:, r, None, :]
        dv = dv + P[:, :, r, None] * do[:, r, None, :]
    return dq, dk, dv


def _scores(a, b, keep_b, scale):
    """Scores of rows a [U, R, dk] against keys b [U, dk] (kept where keep_b
    [U]): [U, R], the mask fill where the key is masked."""
    x = (a * b[:, None, :]).sum(-1) * scale
    return torch.where(keep_b[:, None], x, torch.full_like(x, MA.MASK_FILL))


def replay_long_part1(q, k, v, do, keep, scale):
    """Part 1 of the backward kernel for L > 32, a lane per query row: the
    row's max m, sum z and t online over tiles of TILE keys, then dq with
    the scores recomputed. Returns (m, 1 / z, t, dq), each row's over [U, L]."""
    U, L, _ = q.shape
    m = torch.full((U, L), -math.inf, dtype=q.dtype)
    z, tu = torch.zeros_like(m), torch.zeros_like(m)
    for j0 in range(0, L, TILE):
        js = range(j0, min(j0 + TILE, L))
        s = torch.stack([_scores(q, k[:, j], keep[:, j], scale) for j in js], -1)
        dp = torch.stack([(do * v[:, j, None, :]).sum(-1) for j in js], -1)
        m_new = torch.maximum(m, s.max(-1).values)
        corr = torch.exp(m - m_new)
        z, tu, m = z * corr, tu * corr, m_new
        for jj in range(len(js)):
            e = torch.exp(s[..., jj] - m_new)
            z, tu = z + e, tu + e * dp[..., jj]
    inv = 1 / z
    t = tu * inv
    dq = torch.zeros_like(q)
    for j in range(L):
        if keep[:, j].any():  # the kernel skips a masked key (ds 0)
            p = torch.exp(_scores(q, k[:, j], keep[:, j], scale) - m) * inv
            ds = p * ((do * v[:, j, None, :]).sum(-1) - t) * scale
            ds = torch.where(keep[:, j, None], ds, torch.zeros_like(ds))
            dq = dq + ds[..., None] * k[:, j, None, :]
    return m, inv, t, dq


def replay_long_part2(q, k, v, do, keep, scale, m, inv, t):
    """Part 2, the transposed pass: a lane per key j, over the rows i in
    order, s, p, dp and ds again from row i's m, 1 / sum and t; dk_j += ds
    q_i, dv_j += p do_i."""
    dk, dv = torch.zeros_like(q), torch.zeros_like(q)
    for r in range(q.shape[1]):
        x = _scores(k, q[:, r], torch.ones_like(keep[:, 0]), scale)
        x = torch.where(keep, x, torch.full_like(x, MA.MASK_FILL))  # [U, keys]
        p = torch.exp(x - m[:, r, None]) * inv[:, r, None]
        ds = p * ((v * do[:, r, None, :]).sum(-1) - t[:, r, None]) * scale
        ds = torch.where(keep, ds, torch.zeros_like(ds))
        dk = dk + ds[..., None] * q[:, r, None, :]
        dv = dv + p[..., None] * do[:, r, None, :]
    return dk, dv


def _softmax_parts(qu, ku, vu, du, keep, scale):
    """The softmax a, t and ds formed whole: [U, rows, keys], [U, rows]."""
    s = torch.einsum("uid,ujd->uij", qu, ku) * scale
    a = torch.softmax(torch.where(keep[:, None, :], s, torch.full_like(s, MA.MASK_FILL)), -1)
    dp = torch.einsum("uid,ujd->uij", du, vu)
    t = (a * dp).sum(-1)
    ds = torch.where(keep[:, None, :], a * (dp - t[..., None]) * scale, torch.zeros_like(a))
    return a, t, ds


@pytest.mark.parametrize("L", LENGTHS)
def test_backward_pass1_gives_t_ds_and_dq(L):
    """The first pass of the backward: t, p and ds (L <= 32, as stored in P
    and S) or t and each row's max and sum (L > 32) against the softmax and
    dp formed whole, and dq against autograd through the plain forward; the
    all-masked sequence's dq is 0."""
    q, k, v, do, mask = _case(L, seed=100 + L)
    keep = mask.repeat_interleave(HEADS, 0)
    qu, ku, vu, du = (_units(t) for t in (q, k, v, do))
    scale = 1 / math.sqrt(DK)
    a, t_ref, ds_ref = _softmax_parts(qu, ku, vu, du, keep, scale)
    if L <= CHUNK:
        P, S, t, dq = replay_short_pass1(qu, ku, vu, du, keep, scale)
        pairs = [(P, a.transpose(1, 2)), (S, ds_ref.transpose(1, 2)), (t, t_ref)]
    else:
        m, inv, t, dq = replay_long_part1(qu, ku, vu, du, keep, scale)
        s = torch.einsum("uid,ujd->uij", qu, ku) * scale
        s = torch.where(keep[:, None, :], s, torch.full_like(s, MA.MASK_FILL))
        pairs = [(torch.exp(s - m[..., None]) * inv[..., None], a), (t, t_ref)]
    for got, want in pairs:
        assert float((got - want).abs().max()) <= _limit(want)
    want = MA.attention_bwd_plain(q, k, v, mask, do, HEADS, DK)[0]
    assert float((_packed(dq) - want).abs().max()) <= _limit(want)
    assert not dq[:HEADS].any()


@pytest.mark.parametrize("L", LENGTHS)
def test_backward_pass2_sums_dk_dv_in_row_order(L):
    q, k, v, do, mask = _case(L, seed=200 + L)
    keep = mask.repeat_interleave(HEADS, 0)
    units = [_units(t) for t in (q, k, v, do)]
    scale = 1 / math.sqrt(DK)
    if L <= CHUNK:
        got = replay_short_backward(*units, keep, scale)
    else:
        m, inv, t, dq = replay_long_part1(*units, keep, scale)
        got = (dq, *replay_long_part2(*units, keep, scale, m, inv, t))
    for g, want in zip(got, MA.attention_bwd_plain(q, k, v, mask, do, HEADS, DK)):
        assert float((_packed(g) - want).abs().max()) <= _limit(want)
    assert not got[1][:HEADS].any()  # no gradient reaches a masked key


def test_row_stride_gives_conflict_free_float4_rows():
    """Rows kv_stride(W) floats apart: 8 lanes (a quarter warp's float4
    loads) reading 8 consecutive rows touch 32 distinct banks."""
    for W in MA.WIDTHS:
        KS = MA._row_stride(W)
        assert KS % 4 == 0 and KS >= W
        for first in range(0, 32, 8):
            banks = [(row * KS + c) % 32 for row in range(first, first + 8) for c in range(4)]
            assert len(set(banks)) == 32, W


@pytest.mark.parametrize("pointers,rs,hs,dk,plan", [
    ([4096, 8192, 12288, 16384], 400, 20, 20, (20, True)),  # packed dk 20
    ([4096, 8192, 12288, 16384], 640, 32, 20, (20, True)),  # E's layout, dkp 32
    ([4096, 8192, 12288, 16384], 1280, 64, 20, (20, True)),  # dkp 64
    ([4100, 8192, 12288, 16384], 400, 20, 20, (20, False)),  # a view 1 float in
    ([4096, 8192, 12288, 16392], 400, 20, 20, (20, False)),  # an output 2 floats in
    ([4096, 8192, 12288, 16384], 24, 6, 6, (8, False)),  # dk 6: rows 24 bytes apart
    ([4096, 8192, 12288, 16384], 21, 7, 7, (8, False)),  # dk 7
    ([4096, 8192, 12288, 16384], 402, 20, 20, (20, False)),  # a row stride of 402 floats
    ([4096, 8192, 12288, 16384], 100, 25, 25, (32, False)),  # dk 25
    ([4096, 8192, 12288, 16384], 128, 32, 25, (32, True)),
    ([4096, 8192, 12288, 16384], 128, 64, 64, (64, True)),  # the widest head
    ([4096, 8192, 12288, 16384], 96, 48, 33, (48, True)),
    ([4096, 8192, 12288, 16384], 160, 80, 80, (128, True)),  # the wide instance
    ([4096, 8192, 12288, 16384], 130, 65, 65, (128, False)),
])
def test_launch_plan_picks_the_instantiation_the_c_side_runs(pointers, rs, hs, dk, plan):
    """The C entry points run the instantiation of width W = the first of
    `WIDTHS` >= dk, with float4 loads where rs, hs and every pointer are
    16-byte aligned (rs % 4, hs % 4, pointer % 16 all 0) and scalar ones
    otherwise; `launch_plan` is that rule."""
    assert MA.launch_plan(pointers, rs, hs, dk) == plan
    assert MA.WIDTHS == (8, 16, 20, 24, 32, 48, 64, 128)


def test_heads_wider_than_the_widest_width_raise(monkeypatch):
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    assert MA.head_width(64) == 64 and MA.head_width(65) == MA.head_width(128) == 128
    x = torch.zeros(2, 4, 2 * 129)
    with pytest.raises(ValueError, match=r"head width 129 is wider than the widest the kernels "
                                         r"take \(128\)"):
        MA.attention_fwd(x, x, x, None, 2, 129)
    with pytest.raises(ValueError, match="widest"):
        MA.attention_bwd(x, x, x, None, x, 2, 129)


@pytest.mark.parametrize("L,dk,backward,regs,warps", [
    (32, 20, False, 128, 4), (32, 20, False, 0, 3), (32, 20, True, 103, 4),
    (32, 8, True, 66, 3), (50, 64, False, 255, 2), (150, 20, False, 110, 5),
    (50, 20, True, 103, 2), (150, 20, True, 103, 5), (300, 20, True, 103, 8),
    (32, 128, False, 0, 4), (160, 80, True, 0, 4)])
def test_block_sizes_and_caps(L, dk, backward, regs, warps):
    """A block of independent warps takes as many as keep the most resident
    on an H100 SM (233,472 bytes, 65,536 registers); beyond L 32 a block
    takes min(8, ceil(L / 32)) warps on one head. At the cap a block
    fits the 227 KB a block may have; one past it, one warp's share does not.
    The wide instance (dk 65-128) runs blocks of 4 warps and has no cap: its
    block's shared memory is the same at every L past 32."""
    sm = 233_472
    assert MA.block_shape(L, dk, backward, sm, regs)[0] == warps
    cap = MA.max_length(dk, backward)
    if cap is None:
        assert MA.head_width(dk) == MA.WIDE
        need = MA._smem_bytes(max(L, 33), dk, backward)
        assert need <= MA.MAX_SMEM_BYTES
        assert MA._smem_bytes(100_000, dk, backward) == need
        return
    shape = MA.block_shape(cap, dk, backward, sm, regs)
    assert shape[0] >= 1 and shape[1] <= MA.MAX_SMEM_BYTES
    assert MA._smem_bytes(cap + 1, dk, backward) > MA.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# The wide instance (csrc/msa_attention_wide.cu, dk 65-128): its order of work
# replayed in float64. Own rows in 16-row warp tiles, the other side streamed
# in tiles of T rows (16 at fp32, 32 at bf16); the forward's online softmax per tile, rows
# past L and keys past L as the kernel takes them; the backward's three
# passes: the row statistics (m, 1 / sum, t online over key tiles), the
# column pass (dk, dv by key tile over query tiles, from the statistics) and
# the dq pass. A product's 8-key tile is taken in the order 2t, 2t + 1 ->
# t, t + 4 on both sides (`_PI`), as the kernel feeds the tensor cores.
# ---------------------------------------------------------------------------
_PI = np.array([0, 2, 4, 6, 1, 3, 5, 7])  # A column c holds key _PI[c] of an 8-key tile
WIDE_DK = 80


def _wide_case(L, seed, dk=WIDE_DK):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(N, L, HEADS * dk)) for _ in range(4))
    mask = rng.random((N, L)) < 0.7
    mask[:, 0] = True
    mask[0] = False
    return q, k, v, do, mask


def _wide_units(t, dk=WIDE_DK):
    L = t.shape[1]
    return t.reshape(N, L, HEADS, dk).transpose(0, 2, 1, 3).reshape(N * HEADS, L, dk)


def _wide_packed(u, dk=WIDE_DK):
    L = u.shape[1]
    return u.reshape(N, HEADS, L, dk).transpose(0, 2, 1, 3).reshape(N, L, HEADS * dk)


def _tile_product(a, b):
    """a [16, T] @ b [T, W] over the T streamed rows in 8-row tiles, each in
    the order `_PI` (the product's value does not depend on it)."""
    out = np.zeros((a.shape[0], b.shape[1]))
    for c0 in range(0, a.shape[1], 8):
        idx = c0 + _PI
        out += a[:, idx] @ b[idx]
    return out


def _padded(rows, L, T):
    """rows [L, d] zero-padded to a whole number of T-row tiles."""
    return np.concatenate([rows, np.zeros((-L % T, rows.shape[1]))])


def replay_wide_forward(q, k, v, keep, scale, T):
    L = q.shape[0]
    Q, K, V = (_padded(x, L, 16 if x is q else T) for x in (q, k, v))
    out = np.zeros_like(q)
    for r0 in range(0, L, 16):
        o, m, l = np.zeros((16, q.shape[1])), np.full(16, -np.inf), np.zeros(16)
        for j0 in range(0, L, T):
            j = np.arange(j0, j0 + T)
            s = Q[r0:r0 + 16] @ K[j0:j0 + T].T * scale
            s = np.where(j >= L, -np.inf, np.where(np.concatenate([keep, np.zeros(T, bool)])[j],
                                                   s, MA.MASK_FILL))
            m_new = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - m_new)
            p = np.exp(s - m_new[:, None])
            l = l * corr + p.sum(axis=1)
            o = o * corr[:, None] + _tile_product(p, V[j0:j0 + T])
            m = m_new
        rows = min(16, L - r0)
        out[r0:r0 + rows] = (o / l[:, None])[:rows]
    return out


def replay_wide_backward(q, k, v, do, keep, scale, T):
    L = q.shape[0]
    kp = np.concatenate([keep, np.zeros(T, bool)])
    Q, K, V, D = (_padded(x, L, T) for x in (q, k, v, do))
    # pass 1: the row statistics, online over key tiles
    stats = np.zeros((L + T, 3))  # m, 1 / sum, t; rows past L zero (p = 0)
    for r0 in range(0, L, 16):
        m, l, tu = np.full(16, -np.inf), np.zeros(16), np.zeros(16)
        qr, dr = _padded(q[r0:r0 + 16], min(16, L - r0), 16), _padded(do[r0:r0 + 16],
                                                                      min(16, L - r0), 16)
        for j0 in range(0, L, T):
            j = np.arange(j0, j0 + T)
            s = np.where(j >= L, -np.inf, np.where(kp[j], qr @ K[j0:j0 + T].T * scale,
                                                   MA.MASK_FILL))
            dp = dr @ V[j0:j0 + T].T
            m_new = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - m_new)
            e = np.exp(s - m_new[:, None])
            l, tu, m = l * corr + e.sum(axis=1), tu * corr + (e * dp).sum(axis=1), m_new
        rows = min(16, L - r0)
        stats[r0:r0 + rows] = np.stack([m, 1 / l, tu / l], axis=1)[:rows]
    # pass 2: dk and dv by key tile, over the query tiles
    dk, dv = np.zeros_like(k), np.zeros_like(v)
    for j0 in range(0, L, 16):
        kr, vr = _padded(k[j0:j0 + 16], min(16, L - j0), 16), _padded(v[j0:j0 + 16],
                                                                      min(16, L - j0), 16)
        kept = kp[j0:j0 + 16]  # keys past L: not kept, not written
        gk, gv = np.zeros((16, k.shape[1])), np.zeros((16, k.shape[1]))
        for i0 in range(0, L, T):
            st = stats[i0:i0 + T]
            s = np.where(kept[:, None], kr @ Q[i0:i0 + T].T * scale, MA.MASK_FILL)
            p = np.exp(s - st[None, :, 0]) * st[None, :, 1]
            ds = np.where(kept[:, None], p * (vr @ D[i0:i0 + T].T - st[None, :, 2]) * scale, 0)
            gv += _tile_product(p, D[i0:i0 + T])
            gk += _tile_product(ds, Q[i0:i0 + T])
        rows = min(16, L - j0)
        dk[j0:j0 + rows], dv[j0:j0 + rows] = gk[:rows], gv[:rows]
    # pass 3: dq from the statistics
    dq = np.zeros_like(q)
    for r0 in range(0, L, 16):
        rows = min(16, L - r0)
        qr, dr = _padded(q[r0:r0 + 16], rows, 16), _padded(do[r0:r0 + 16], rows, 16)
        st = _padded(stats[r0:r0 + rows], rows, 16)
        g = np.zeros((16, q.shape[1]))
        for j0 in range(0, L, T):
            j = np.arange(j0, j0 + T)
            s = np.where(j >= L, -np.inf, np.where(kp[j], qr @ K[j0:j0 + T].T * scale,
                                                   MA.MASK_FILL))
            p = np.exp(s - st[:, 0:1]) * st[:, 1:2]
            ds = np.where((j < L) & kp[j], p * (dr @ V[j0:j0 + T].T - st[:, 2:3]) * scale, 0)
            g += _tile_product(ds, K[j0:j0 + T])
        dq[r0:r0 + rows] = g[:rows]
    return dq, dk, dv


@pytest.mark.parametrize("T", sorted(MA.WIDE_TILES.values()))
@pytest.mark.parametrize("L", [1, 12, 16, 17, 32, 33, 64, 160])
def test_wide_forward_order_of_work(L, T):
    q, k, v, _, mask = _wide_case(L, seed=L + 7)
    scale = 1 / math.sqrt(WIDE_DK)
    units = [_wide_units(t) for t in (q, k, v)]
    keep = np.repeat(mask, HEADS, axis=0)
    got = _wide_packed(np.stack([replay_wide_forward(*(u[i] for u in units), keep[i], scale, T)
                                 for i in range(N * HEADS)]))
    want = MA._attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), HEADS,
                               torch.from_numpy(mask))
    assert float((torch.from_numpy(got) - want).abs().max()) <= _limit(want)


@pytest.mark.parametrize("T", sorted(MA.WIDE_TILES.values()))
@pytest.mark.parametrize("L", [1, 12, 16, 17, 32, 33, 64, 160])
def test_wide_backward_order_of_work(L, T):
    q, k, v, do, mask = _wide_case(L, seed=L + 11)
    scale = 1 / math.sqrt(WIDE_DK)
    units = [_wide_units(t) for t in (q, k, v, do)]
    keep = np.repeat(mask, HEADS, axis=0)
    per = [replay_wide_backward(*(u[i] for u in units), keep[i], scale, T)
           for i in range(N * HEADS)]
    got = [_wide_packed(np.stack([p[a] for p in per])) for a in range(3)]
    want = MA.attention_bwd_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                  torch.from_numpy(mask), torch.from_numpy(do), HEADS, WIDE_DK)
    for g, w in zip(got, want):
        assert float((torch.from_numpy(g) - w).abs().max()) <= _limit(w)
    assert not got[0][0].any() and not got[1][0].any()  # the all-masked sequence


@pytest.mark.parametrize("L,wpu,upb,rows", [(1, 1, 4, 16), (16, 1, 4, 16), (17, 2, 2, 32),
                                            (32, 2, 2, 32), (33, 4, 1, 64), (160, 4, 1, 64)])
def test_wide_geometry(L, wpu, upb, rows):
    """4 warps a block at every L: one unit beyond L 32, two at 17-32, four
    at <= 16; shared memory as csrc/msa_attention_wide.cu counts it (fp32
    rows 132 floats apart, bf16 rows 136 bf16 apart, tiles of 16 streamed
    fp32 rows or 32 bf16, every part a multiple of 16 bytes)."""
    assert MA._wide_geometry(L) == (wpu, upb, rows)
    assert MA.block_shape(L, WIDE_DK, True, 233_472)[0] == MA.WIDE_WARPS == wpu * upb
    for itemsize, row, T in ((4, 4 * 132, 16), (2, 2 * 136, 32)):
        assert row % 16 == 0 and MA.WIDE_TILES[itemsize] == T
        stream = (2 if L > T else 1) * 2 * T * row
        assert MA._wide_block_bytes(L, "fwd", itemsize) == upb * (rows * row + 2 * T + stream)
        assert MA._wide_block_bytes(L, "rows", itemsize) == \
            upb * (2 * rows * row + 2 * T + stream)
        assert MA._smem_bytes(L, 100, True, itemsize) == \
            MA._wide_block_bytes(L, "cols", itemsize) == \
            upb * (2 * rows * row + 24 * T + rows + stream)
        assert MA.block_shape(L, 100, False, 233_472, itemsize=itemsize)[1] == \
            MA._wide_block_bytes(L, "fwd", itemsize) <= MA.MAX_SMEM_BYTES


# ---------------------------------------------------------------------------
# The bf16 register-row instance (csrc/msa_attention_bf16.cuh, heads of dk <=
# 64 at compute_dtype bfloat16): its order of work replayed in float64 on
# bf16 values. Rows in 16-row tiles, dk zero-padded to 16, keys (or the
# column pass's rows) in tiles of 32; the probabilities and ds enter their
# products as a bf16 hi and lo (`_split`: hi = bf16(x), lo = bf16(x - hi),
# each rounded to nearest even from fp32); the forward's online softmax per
# 32-key tile; the backward at L <= 32 forms each score once, beyond it
# recomputes them (the row statistics online over key tiles, dq, then the
# column pass from the statistics).
#
# Tolerance. The only rounding the replay keeps is the split: |x - hi| <=
# 2^-8 |x| and |x - hi - lo| <= 2^-8 |x - hi|, so hi + lo is x to 2^-16 |x|,
# and a product sum_j x_j y_j is off by at most 2^-16 sum_j |x_j| |y_j|. For
# the forward sum_j p_j = 1, so out is off by at most 2^-16 max |v| (1.5e-5
# of it); dq, dk and dv by 2^-16 times sums of |ds| |row| or |p| |row|. On
# these normal inputs every output is within 1e-4 * max(1, max |plain|) (the
# limit asserted, `_bf16_limit`).
# ---------------------------------------------------------------------------
BF16_LENGTHS = [1, 12, 16, 17, 31, 32, 33, 50, 160]
BF16_DKS = [7, 20, 25, 64]
BF16_TILE_KEYS = MA.BF16_TILE  # keys of a tile of scores


def _to_bf16(x):
    """x rounded to bf16 (nearest even) from fp32, as float64."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).double().numpy()


def _split(x):
    """hi + lo of the kernels' two-pass products: hi = bf16(x), lo = bf16(x - hi)."""
    x32 = np.asarray(x, np.float32)
    hi = _to_bf16(x32)
    return hi + _to_bf16(x32 - hi.astype(np.float32))


def _bf16_case(L, dk, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_to_bf16(rng.normal(size=(N, L, HEADS * dk))) for _ in range(4))
    mask = rng.random((N, L)) < 0.7
    mask[:, 0] = True
    mask[0] = False  # all keys masked
    return q, k, v, do, mask


def _bf16_limit(ref):
    return 1e-4 * max(1.0, float(ref.abs().max()))


def _pad(x, rows, cols):
    """x [r, c] zero-padded to [rows, cols]."""
    out = np.zeros((rows, cols))
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _up(x, m):
    return -(-x // m) * m


def replay_bf16_forward(q, k, v, keep, scale):
    """The forward on one head [L, dk]: per 16-row tile, over 32-key tiles,
    the scores, -inf past L and -1e9 masked, the online max, sum and
    accumulator, p v with p as hi + lo."""
    L, dk = q.shape
    dkp, T = _up(dk, 16), BF16_TILE_KEYS
    Q, K, V = _pad(q, _up(L, 16), dkp), _pad(k, _up(L, T), dkp), _pad(v, _up(L, T), dkp)
    kp = np.concatenate([keep, np.zeros(T, bool)])
    out = np.zeros((_up(L, 16), dkp))
    for r0 in range(0, L, 16):
        o, m, l = np.zeros((16, dkp)), np.full(16, -np.inf), np.zeros(16)
        for j0 in range(0, L, T):
            j = np.arange(j0, j0 + T)
            s = Q[r0:r0 + 16] @ K[j0:j0 + T].T
            s = np.where(j >= L, -np.inf, np.where(kp[j], s * scale, MA.MASK_FILL))
            m_new = np.maximum(m, s.max(axis=1))
            assert np.isfinite(m_new).all()  # tile 0 holds key 0
            corr = np.exp(m - m_new)
            e = np.exp(s - m_new[:, None])
            l = l * corr + e.sum(axis=1)
            o = o * corr[:, None] + _split(e) @ V[j0:j0 + T]
            m = m_new
        out[r0:r0 + 16] = o / l[:, None]
    return out[:L, :dk]


def replay_bf16_backward_short(q, k, v, do, keep, scale):
    """The backward at L <= 32 on one head: s and dp formed once over all
    keys, the row max, 1 / sum and t, then p and ds (kept as hi + lo for the
    transposed products), dq = ds k, dk = ds^T q, dv = p^T do."""
    L, dk = q.shape
    Lp, dkp = _up(L, 16), _up(dk, 16)
    Q, K, V, D = (_pad(x, Lp, dkp) for x in (q, k, v, do))
    j = np.arange(Lp)
    live, kept = j < L, (j < L) & np.concatenate([keep, np.zeros(Lp - L, bool)])
    s = np.where(live, np.where(kept, Q @ K.T * scale, MA.MASK_FILL), -np.inf)
    dp = np.where(live, D @ V.T, 0.0)
    e = np.exp(s - s.max(axis=1, keepdims=True))
    inv = 1 / e.sum(axis=1, keepdims=True)
    t = (e * dp).sum(axis=1, keepdims=True) * inv
    p = e * inv
    ds = np.where(kept, p * (dp - t) * scale, 0.0)
    P, S = _split(p), _split(ds)
    return (S @ K)[:L, :dk], (S.T @ Q)[:L, :dk], (P.T @ D)[:L, :dk]


def replay_bf16_backward_recompute(q, k, v, do, keep, scale):
    """The backward past L 32 on one head (the resident kernel up to L 64
    and the streamed one beyond compute the same sums): per 16-row tile the
    row max, sum and t online over 32-key tiles; dq over the key tiles again,
    ds from p = exp(s - m) / sum; then per 16-key tile over 32-row tiles, p
    and ds from each row's statistics, dv += p^T do, dk += ds^T q."""
    L, dk = q.shape
    dkp, T = _up(dk, 16), BF16_TILE_KEYS
    R = _up(L, T)
    Q, K, V, D = (_pad(x, R, dkp) for x in (q, k, v, do))
    rows = np.arange(R)
    live = rows < L
    kept = live & np.concatenate([keep, np.zeros(R - L, bool)])
    stats = np.zeros((R, 3))  # m, 1 / sum, t; rows past L 0 (their p is 0)
    dq = np.zeros((R, dkp))
    for r0 in range(0, L, 16):
        m, l, tu = np.full(16, -np.inf), np.zeros(16), np.zeros(16)
        for j0 in range(0, L, T):
            j = slice(j0, j0 + T)
            s = np.where(live[j], np.where(kept[j], Q[r0:r0 + 16] @ K[j].T * scale,
                                           MA.MASK_FILL), -np.inf)
            dp = np.where(live[j], D[r0:r0 + 16] @ V[j].T, 0.0)
            m_new = np.maximum(m, s.max(axis=1))
            corr = np.exp(m - m_new)
            e = np.exp(s - m_new[:, None])
            l, tu, m = l * corr + e.sum(axis=1), tu * corr + (e * dp).sum(axis=1), m_new
        st = np.stack([m, 1 / l, tu / l], axis=1)
        st[r0 + np.arange(16) >= L] = 0
        stats[r0:r0 + 16] = st
        g = np.zeros((16, dkp))
        for j0 in range(0, L, T):
            j = slice(j0, j0 + T)
            with np.errstate(over="ignore"):  # a masked key's, selected away as on the card
                p = np.exp(Q[r0:r0 + 16] @ K[j].T * scale - st[:, :1]) * st[:, 1:2]
            ds = np.where(kept[j], p * (D[r0:r0 + 16] @ V[j].T - st[:, 2:3]) * scale, 0.0)
            g += _split(ds) @ K[j]
        dq[r0:r0 + 16] = g
    dk_, dv_ = np.zeros((R, dkp)), np.zeros((R, dkp))
    for j0 in range(0, L, 16):
        own = slice(j0, j0 + 16)
        gk, gv = np.zeros((16, dkp)), np.zeros((16, dkp))
        for i0 in range(0, L, T):
            i = slice(i0, i0 + T)
            x = np.where(kept[own, None], K[own] @ Q[i].T * scale, MA.MASK_FILL)
            p = np.where(live[i], np.exp(x - stats[i, 0]) * stats[i, 1], 0.0)
            ds = np.where(kept[own, None] & live[i],
                          p * (V[own] @ D[i].T - stats[i, 2]) * scale, 0.0)
            gv += _split(p) @ D[i]
            gk += _split(ds) @ Q[i]
        dk_[own], dv_[own] = gk, gv
    return dq[:L, :dk], dk_[:L, :dk], dv_[:L, :dk]


def _bf16_heads(x, dk):
    """[N, L, H dk] -> [N, H, L, dk]."""
    return x.reshape(N, x.shape[1], HEADS, dk).transpose(0, 2, 1, 3)


def _bf16_packed(u, dk):
    return u.transpose(0, 2, 1, 3).reshape(N, u.shape[2], HEADS * dk)


@pytest.mark.parametrize("dk", BF16_DKS)
@pytest.mark.parametrize("L", BF16_LENGTHS)
def test_bf16_forward_order_of_work(L, dk):
    """The bf16 forward's tiles, online softmax and hi + lo split against
    `_attention_plain` on bf16 values (upcast, fp32 there, float64 here)."""
    q, k, v, _, mask = _bf16_case(L, dk, seed=L * 7 + dk)
    scale = 1 / math.sqrt(dk)
    heads = [_bf16_heads(x, dk) for x in (q, k, v)]
    got = np.zeros((N, HEADS, L, dk))
    for n in range(N):
        for h in range(HEADS):
            got[n, h] = replay_bf16_forward(*(x[n, h] for x in heads), mask[n], scale)
    want = MA._attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                               torch.from_numpy(mask))
    err = float((torch.from_numpy(_bf16_packed(got, dk)) - want).abs().max())
    assert err <= _bf16_limit(want), err


@pytest.mark.parametrize("dk", BF16_DKS)
@pytest.mark.parametrize("L", BF16_LENGTHS)
def test_bf16_backward_order_of_work(L, dk):
    """The bf16 backward (L <= 32: each score once; beyond: recomputed from
    the row statistics) against `attention_bwd_plain`; the all-masked
    sequence passes no gradient to q or k."""
    q, k, v, do, mask = _bf16_case(L, dk, seed=L * 11 + dk)
    scale = 1 / math.sqrt(dk)
    heads = [_bf16_heads(x, dk) for x in (q, k, v, do)]
    replay = replay_bf16_backward_short if L <= MA.SHORT_L else replay_bf16_backward_recompute
    got = [np.zeros((N, HEADS, L, dk)) for _ in range(3)]
    for n in range(N):
        for h in range(HEADS):
            for a, g in zip(got, replay(*(x[n, h] for x in heads), mask[n], scale)):
                a[n, h] = g
    want = MA.attention_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(mask), torch.from_numpy(do), HEADS, dk)
    for g, w in zip(got, want):
        err = float((torch.from_numpy(_bf16_packed(g, dk)) - w).abs().max())
        assert err <= _bf16_limit(w), err
    assert not got[0][0].any() and not got[1][0].any()


@pytest.mark.parametrize("hs,heads,vector,g", [
    (20, 20, True, 2), (25, 16, True, 8), (25, 3, True, 3), (8, 4, True, 1), (16, 8, True, 1),
    (24, 4, True, 1), (32, 20, True, 1), (48, 2, True, 1), (64, 20, True, 1), (7, 8, True, 8),
    (20, 20, False, 1), (25, 16, False, 1), (20, 1, True, 1), (100, 4, True, 2)])
def test_bf16_head_group(hs, heads, vector, g):
    """A group's columns start and end on 16 bytes: g = 8 / gcd(hs, 8) heads
    (at most `heads`) with 16-byte copies, one head with element copies; a
    span row of g hs rounded up to 8 elements, shared rows 16 bytes off a
    multiple of 32, so that the fragment loads below hit distinct banks
    (the same group in every kernel)."""
    got = MA.bf16_geometry("short", 32, heads, hs, vector)
    assert got[0] == g and got[1] == -(-heads // g)
    assert all(MA.bf16_geometry(kind, L, heads, hs, vector)[:4] == got[:4]
               for kind, L in (("fwd", 32), ("mid", 50), ("fwd_long", 160), ("long", 160)))
    if vector:
        assert (g * hs * 2) % 16 == 0 or g == heads
    se, sr = got[2], got[3]
    assert se == -(-g * hs // 8) * 8 and sr in (se, se + 8) and (2 * sr) % 32 == 16

    def conflict_free(elements):
        """32 lanes' 16-bit elements: each bank serves one 32-bit word."""
        words = {}
        for e in elements:
            words.setdefault(e // 2 % 32, set()).add(e // 2)
        return all(len(w) == 1 for w in words.values())

    for h in range(g):  # every head's shift in the span
        c0 = h * hs
        for e in range(2):  # A pairs: row g, column 2t (+ 1); B: rows 2t (+ 1), column g
            assert conflict_free([gg * sr + c0 + 2 * t + e for gg in range(8) for t in range(4)])
            assert conflict_free([(2 * t + e) * sr + c0 + gg for gg in range(8) for t in range(4)])


@pytest.mark.parametrize("pointers,rs,hs,dk,plan", [
    ([4096, 8192, 12288, 16384], 400, 20, 20, (32, True)),  # the titles: groups of 2 heads
    ([4096, 8192, 12288, 16384], 400, 25, 25, (32, True)),  # 16 x 25: groups of 8
    ([4096, 8192, 12288, 16392], 400, 20, 20, (32, False)),  # an output 8 bytes in
    ([4098, 8192, 12288, 16384], 400, 20, 20, (32, False)),  # q one element in
    ([4096, 8192, 12288, 16384], 100, 20, 20, (32, False)),  # 5 heads: 200-byte rows
    ([4096, 8192, 12288, 16384], 75, 25, 25, (32, False)),  # 3 heads of 25
    ([4096, 8192, 12288, 16384], 640, 32, 20, (32, True)),  # E's layout, dkp 32
    ([4096, 8192, 12288, 16384], 24, 8, 6, (16, True)),  # dk 6 in heads of 8
    ([4096, 8192, 12288, 16384], 21, 7, 7, (16, False)),
    ([4096, 8192, 12288, 16384], 128, 64, 64, (64, True)),
    ([4096, 8192, 12288, 16384], 96, 48, 33, (48, True)),
    ([4096, 8192, 12288, 16384], 160, 80, 80, (128, True)),  # the wide instance's rule
    ([4096, 8192, 12288, 16388], 160, 80, 80, (128, False)),
])
def test_bf16_launch_plan(pointers, rs, hs, dk, plan):
    """bf16 (itemsize 2) at dk <= 64: the width dk rounded up to 16 and
    16-byte copies where rs is a multiple of 8 elements and every pointer is
    16-byte aligned; the wide instance keeps its four-element rule."""
    assert MA.launch_plan(pointers, rs, hs, dk, 2) == plan


@pytest.mark.parametrize("L,heads,hs,backward,kind,g,qr,warps,stages", [
    (32, 20, 20, False, "fwd", 2, 32, 2, 3), (32, 20, 20, True, "short", 2, 32, 4, 3),
    (50, 20, 20, False, "fwd", 2, 64, 4, 3), (50, 20, 20, True, "mid", 2, 64, 4, 3),
    (160, 16, 25, False, "fwd_long", 8, 32, 8, 1), (160, 16, 25, True, "long", 8, 16, 8, 1),
    (32, 16, 25, True, "short", 8, 32, 4, 2), (33, 16, 25, True, "mid", 8, 48, 4, 2),
    (64, 16, 25, True, "mid", 8, 64, 4, 1), (64, 16, 25, False, "fwd", 8, 64, 4, 3),
    (12, 4, 8, True, "short", 1, 16, 1, 3), (100, 2, 64, False, "fwd_long", 1, 112, 4, 1),
    (300, 20, 20, True, "long", 2, 32, 4, 1)])
def test_bf16_block_shapes(L, heads, hs, backward, kind, g, qr, warps, stages):
    """The kernel, group, own rows, warps and units in flight of a bf16
    register-row launch with 16-byte copies, and its shared memory as
    csrc/msa_attention_bf16.cuh counts it (a part per operand row of 2 sr
    bytes, every part a multiple of 16 bytes)."""
    assert MA.bf16_kind(L, backward) == kind
    geom = MA.bf16_geometry(kind, L, heads, hs, True)
    assert (geom[0], geom[4], geom[5]) == (g, qr, warps)
    assert MA.bf16_stages(kind, L, heads, hs, True) == stages
    row, lp, T = 2 * geom[3], -(-L // 16) * 16, MA.BF16_TILE
    want = {"fwd": stages * (3 * lp * row + lp),
            "short": stages * (4 * lp * row + lp) + lp * row + g * 4 * lp * (lp + 8) * 2,
            "mid": stages * (4 * lp * row + lp) + lp * row + 3 * g * lp * 4,
            "fwd_long": qr * row + 2 * (2 * T * row + T),
            "long": 2 * qr * row + 4 * T * row + 12 * g * -(-L // T) * T + -(-L // T) * T}
    got = MA._bf16_smem_bytes(kind, L, heads, hs, True, stages)
    assert got == want[kind] <= MA.MAX_SMEM_BYTES and got % 16 == 0
    if stages < MA.BF16_STAGES and kind in ("fwd", "short", "mid"):
        assert MA._bf16_smem_bytes(kind, L, heads, hs, True, stages + 1) > MA.MAX_SMEM_BYTES


@pytest.mark.parametrize("dk,heads,hs", [(20, 20, 20), (25, 16, 25), (64, 1, 64), (7, 8, 7)])
def test_bf16_caps(dk, heads, hs, monkeypatch):
    """The bf16 forward takes any L (its keys stream past L 64); the
    backward's shared memory grows with L by its row statistics, which caps
    L: one past the cap does not fit a block and raises with the cap."""
    assert MA.max_length(dk, backward=False, itemsize=2, heads=heads, hs=hs) is None
    cap = MA.max_length(dk, True, 2, heads, hs)
    assert MA.BF16_RESIDENT < cap
    assert MA._bf16_need(cap, heads, hs, True) <= MA.MAX_SMEM_BYTES
    assert MA._bf16_need(cap + 1, heads, hs, True) > MA.MAX_SMEM_BYTES
    assert MA._bf16_need(100_000, heads, hs, False) <= MA.MAX_SMEM_BYTES
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    x = torch.zeros(1, cap + 1, heads * hs, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"longest it takes is {cap}"):
        MA.attention_bwd(x, x, x, None, x, heads, dk)
