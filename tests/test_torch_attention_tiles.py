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
caps."""

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
    (32, 128, False, 0, 1), (160, 80, True, 0, 1)])
def test_block_sizes_and_caps(L, dk, backward, regs, warps):
    """A block of independent warps takes as many as keep the most resident
    on an H100 SM (233,472 bytes, 65,536 registers); beyond L 32 a block
    takes min(8, ceil(L / 32)) warps on one head. At the cap a block
    fits the 227 KB a block may have; one past it, one warp's share does not."""
    sm = 233_472
    assert MA.block_shape(L, dk, backward, sm, regs)[0] == warps
    cap = MA.max_length(dk, backward)
    shape = MA.block_shape(cap, dk, backward, sm, regs)
    assert shape[0] >= 1 and shape[1] <= MA.MAX_SMEM_BYTES
    assert MA._smem_bytes(cap + 1, dk, backward) > MA.MAX_SMEM_BYTES
