"""Kernel A's bf16 instance (csrc/msa_encoder.cu, msa_encoder_pooled_bf16) in
its order of work, replayed on the CPU in fp32 and in float64, against
`msa_encoder_pooled_plain` and the JAX kernel in interpret mode at bf16.

The instance's order of work:

  * q|k|v: one pass of exact bf16 products (x after the word dropout,
    rounded once to bf16, against the bf16 Wq|Wk|Wv), each 16-deep step
    summed into a 64-deep k-tile's fresh fp32 sums, each tile's sums added
    to the running sums rounding to nearest (kRN), then the bias;
  * attention in fp32, a lane per query row: the scores over the head's
    columns in order, times 1 / sqrt(dk), the row's softmax with its sum
    over the keys in order, h = relu(sum_j p_ij v_j) over the keys in order;
  * h as three bf16 planes (hi, mid, lo), the pool's u = three bf16 passes
    (lo, mid, hi) against the bf16 W1 over 64-deep k-tiles with kRN;
  * the logits' parts, one a 128-wide tile column: within it each of a
    row's four lanes sums tanh(u + b1) v over its columns (four of every
    sixteen), then the lanes' sums pair up as (l0 + l1) + (l2 + l3); the
    parts are added in column order;
  * the pool's masked softmax (-1e9 fill) and sum_l alpha_l h_l in order.

The float64 replay keeps every sum exact to float64 and h as one term; it
checks the order's structure (tiles, parts, planes) against the plain
version without fp32's rounding; the pool reads h as hi + mid + lo, which
is h's fp32 value (tests/test_torch_bf16_split.py). The shared-memory
layout of the new attention stage (a block per title and four heads, each
head's q, k or v rows a TMA box from a 16-byte start, the head's columns
shifted by its first column's offset from a float4, each lane's four
elements of a 16-byte column of the group's h gathered from its head's
row) is replayed as index arithmetic. Tolerances: the fp32 replay within the card's gate,
1e-4 * max(1, max |ref|), of the plain version and of the JAX kernel; the
float64 replay within 1e-6 * max(1, max |plain|) of the plain version,
whose pool runs in fp32 after rounding h to fp32; each product within
2^-20 of the sum of its terms' magnitudes of float64 (fp32-class)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.ops.pallas.msa_attention_grouped import unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder
from digat_tpu_torch.ops import msa_encoder as ME
from tests.test_torch_bf16_split import split3, wg_logit_parts
from tests.test_torch_support import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = torch.bfloat16
GATE = 1e-4
KT, STEP, TILE_N = 64, 16, 128  # k-tile depth, wgmma depth, logits' tile columns
DIN, HEADS, DK, A = 36, 4, 8, 200  # A over two logit tiles (128 + 72)
LENGTHS = [1, 7, 16, 20, 32]


def kRN_product(terms, b, ft):
    """sum over the passes (terms small first, each against the exact b) of
    terms[p] [M, K] @ b [K, N]: per KT-deep k-tile every pass's STEP-deep
    products (exact, in float64) added into fresh sums of type ft, then the
    tile's sums added to the running sums."""
    M, K = terms[0].shape
    run = torch.zeros(M, b.shape[1], dtype=ft)
    b64 = b.double()
    for k0 in range(0, K, KT):
        tile = torch.zeros_like(run)
        for t in reversed(terms):
            for k in range(k0, min(K, k0 + KT), STEP):
                ks = slice(k, min(K, k + STEP))
                tile = tile + (t[:, ks].double() @ b64[ks]).to(ft)
        run = run + tile
    return run


def replay_a_bf16(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate=0.0, seed=0, site=0,
                  ft=torch.float32):
    """Kernel A's bf16 instance in its order of work, in ft (float32: h's
    three bf16 planes; float64: h as one exact term)."""
    N, L, Din = x.shape
    D = wq.shape[1]
    dk = D // heads
    M = N * L
    xd = ME.drop_titles_plain(x, rate, seed, site).reshape(M, Din).to(BF16)
    wqkv = torch.cat([wq.t(), wk.t(), wv.t()]).to(BF16)  # [3D, Din]
    bqkv = torch.cat([bq.float(), torch.zeros(D), bv.float()]).to(ft)
    qkv = (kRN_product([xd], wqkv.t(), ft) + bqkv).reshape(N, L, 3, heads, dk)
    q, k, val = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [N, heads, L, dk]
    scale = torch.tensor(1.0 / np.sqrt(dk), dtype=ft)
    s = torch.zeros(N, heads, L, L, dtype=ft)
    for c in range(dk):  # the scores over the head's columns in order
        s = s + q[..., :, None, c] * k[..., None, :, c]
    s = s * scale
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    total = torch.zeros(N, heads, L, 1, dtype=ft)
    for j in range(L):
        total = total + e[..., j:j + 1]
    p = e * (1.0 / total)
    o = torch.zeros(N, heads, L, dk, dtype=ft)
    for j in range(L):
        o = o + p[..., j:j + 1] * val[..., j:j + 1, :]
    h = torch.relu(o).permute(0, 2, 1, 3).reshape(M, D)
    terms = list(split3(h)) if ft == torch.float32 else [h]
    u = kRN_product(terms, w1.to(BF16), ft)
    lg = torch.zeros(M, dtype=ft)
    for part in wg_logit_parts(u, b1, v, TILE_N):
        lg = lg + part
    lg = torch.where(mask.reshape(M), lg, torch.tensor(-1e9, dtype=ft)).reshape(N, L)
    alpha = torch.softmax(lg, dim=-1)
    out = torch.zeros(N, D, dtype=ft)
    hl = h.reshape(N, L, D)
    for l in range(L):
        out = out + alpha[:, l:l + 1] * hl[:, l]
    return out


def _case(N, L, seed, heads=HEADS, dk=DK):
    """bf16 titles and weights (the model's compute copy), a mask with an
    all-pad title: JAX params and the port's arguments."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    msa = jax.tree.map(lambda w: w.astype(jnp.bfloat16), JL.mha_init(ks[0], heads, DIN, dk, dk))
    pool = jax.tree.map(lambda w: w.astype(jnp.bfloat16), JL.attn_pool_init(ks[1], heads * dk, A))
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(N, L, DIN)).astype(np.float32)).astype(jnp.bfloat16)
    mask = rng.random((N, L)) < 0.75
    mask[0] = False

    def t(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(np.array(a.astype(jnp.float32))).to(BF16)
        return torch.from_numpy(np.array(a))

    args = (t(x), torch.from_numpy(mask), t(msa["W_Q"]["w"]), t(msa["W_Q"]["b"]),
            t(msa["W_K"]["w"]), t(msa["W_V"]["w"]), t(msa["W_V"]["b"]),
            t(pool["affine1"]["w"]), t(pool["affine1"]["b"]), t(pool["affine2"]["w"][:, 0]))
    return (msa, pool, x, jnp.asarray(mask)), args


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("L", LENGTHS)
def test_replay_matches_plain(L, rate):
    """fp32 and float64 replays against the plain version on the same bf16
    inputs, with and without the word dropout."""
    _, args = _case(5, L, seed=L + int(10 * rate))
    plain = ME.msa_encoder_pooled_plain(*args, HEADS, rate, 7, 2).double()
    scale = max(1.0, float(plain.abs().max()))
    got32 = replay_a_bf16(*args, HEADS, rate, 7, 2, ft=torch.float32).double()
    assert float((got32 - plain).abs().max()) <= GATE * scale
    got64 = replay_a_bf16(*args, HEADS, rate, 7, 2, ft=torch.float64)
    assert float((got64 - plain).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("L", LENGTHS)
def test_replay_matches_jax_kernel_at_bf16(L):
    """The replays against the JAX kernel at bf16 in interpret mode (no
    dropout: the two frameworks draw other bits)."""
    (msa, pool, x, mask), args = _case(6, L, seed=100 + L)
    out, _ = jax_msa_encoder(x, mask, msa, pool, HEADS, DK, tile=8, interpret=True)
    want = torch.from_numpy(np.array(unpad_heads(out, HEADS, DK))).double()
    scale = max(1.0, float(want.abs().max()))
    for ft in (torch.float32, torch.float64):
        got = replay_a_bf16(*args, HEADS, ft=ft).double()
        assert float((got - want).abs().max()) <= GATE * scale


def test_qkv_one_pass_over_64_deep_tiles():
    """q|k|v at the production's Din 300 (five 64-deep tiles, the last 44
    deep): one bf16 pass with kRN within 2^-20 of the sum of magnitudes of
    float64 and within the gate."""
    g = np.random.default_rng(5)
    x = torch.from_numpy(g.standard_normal((256, 300)).astype(np.float32)).to(BF16)
    w = torch.from_numpy((g.standard_normal((300, 1200)) / np.sqrt(300)).astype(np.float32))
    w = w.to(BF16)
    got = kRN_product([x], w, torch.float32).double()
    ref = x.double() @ w.double()
    assert float((got - ref).abs().max()) <= GATE * max(1.0, float(ref.abs().max()))
    mag = x.double().abs() @ w.double().abs()
    assert float(((got - ref).abs() / mag).max()) <= 2.0 ** -20


def test_three_plane_logits_within_the_gate():
    """The pool logits from h's three bf16 planes (three passes over D 400,
    64-deep tiles) and their parts per 128-wide column, A 256: within the
    gate of float64 and 2^-20 of the logits' magnitudes."""
    g = np.random.default_rng(6)
    h = torch.from_numpy(np.maximum(g.standard_normal((256, 400)), 0).astype(np.float32))
    w1 = torch.from_numpy((g.standard_normal((400, 256)) / 20).astype(np.float32)).to(BF16)
    b1 = torch.from_numpy((0.1 * g.standard_normal(256)).astype(np.float32))
    v = torch.from_numpy((g.standard_normal(256) / 16).astype(np.float32))
    u = kRN_product(list(split3(h)), w1, torch.float32)
    parts = wg_logit_parts(u, b1, v, TILE_N)
    assert parts.shape == (2, 256)
    got = (torch.zeros(256) + parts[0] + parts[1]).double()
    u64 = h.double() @ w1.double()
    t64 = torch.tanh(u64 + b1.double()) * v.double()
    ref = t64.sum(dim=1)
    assert float((got - ref).abs().max()) <= GATE * max(1.0, float(ref.abs().max()))
    assert float(((got - ref).abs() / t64.abs().sum(dim=1)).max()) <= 2.0 ** -20
    # each part is its column block's sum
    blocks = torch.stack([t64[:, :128].sum(dim=1), t64[:, 128:].sum(dim=1)])
    assert float((parts.double() - blocks).abs().max()) <= 2.0 ** -20 * float(t64.abs().sum())


def group_row_quads(dk):
    """csrc/msa_encoder.cu's float4s of a head row in the attention stage's
    boxes: dk and the largest shift of a head's first column off a float4."""
    return (dk + (3 if dk % 2 else dk % 4) + 3) // 4


def group_stride(dk):
    """The boxes' width and row stride: an odd number of float4s."""
    g = group_row_quads(dk)
    return 4 * (g if g % 2 else g + 1)


def group_layout(heads, dk):
    """msa_attn_fwd_group_kernel's index arithmetic for each block of (title,
    four heads): the TMA boxes' first columns, each head's shift in its
    rows, and the shared-memory offsets (head * 32 * RS + shift + column)
    that each lane's float4 columns of a group row are gathered from."""
    RS = group_stride(dk)
    HS = 32 * RS
    kR = 1 if group_row_quads(dk) <= 7 else 2
    D = heads * dk
    groups = []
    for h0 in range(0, heads, 4):
        nh = min(4, heads - h0)
        W = nh * dk
        assert W % 4 == 0 and (h0 * dk) % 4 == 0  # 16-byte columns from 16-byte starts
        boxes = {(t, h0 + hh): (t * D + (h0 + hh) * dk) & ~3 for t in range(3) for hh in range(nh)}
        mis = {h0 + hh: ((h0 + hh) * dk) % 4 for hh in range(nh)}
        cols = {}
        for lane in range(32):
            for r in range(kR):
                c4 = lane + 32 * r
                if c4 < W // 4:
                    for e in range(4):
                        c = 4 * c4 + e
                        hh = c // dk
                        cols[c] = hh * HS + mis[h0 + hh] + c - hh * dk
        groups.append((h0, nh, W, boxes, mis, cols))
    return RS, groups


@pytest.mark.parametrize("heads,dk", [(16, 25), (10, 20), (6, 30), (2, 32), (4, 64), (4, 8),
                                      (12, 25), (8, 6), (2, 62), (4, 61), (4, 26)])
def test_attention_group_layout(heads, dk):
    """Each head's box starts on a float4 and holds its q, k or v columns at
    the head's shift (the same in q, k and v), within rows of an odd number
    of float4s; every column of a group's rows is gathered once from its
    head's row; the plane stores are 8-byte aligned; the block's shared
    memory fits the card's 227 KB; the instance's registers hold the row."""
    D = heads * dk
    assert D % 4 == 0  # the kernels' shapes
    assert group_row_quads(dk) <= 16  # group_unit: the long unit takes the rest
    RS, groups = group_layout(heads, dk)
    assert RS % 4 == 0 and (RS // 4) % 2 == 1 and RS <= 256
    assert 4 * 3 * 4 * 32 * RS + 128 + 8 <= 227 * 1024
    seen = set()
    for h0, nh, W, boxes, mis, cols in groups:
        for (t, h), start in boxes.items():
            first = t * D + h * dk
            assert start % 4 == 0 and first - start == mis[h] and mis[h] + dk <= RS
            assert mis[h] + dk <= 4 * group_row_quads(dk)
        assert sorted(cols) == list(range(W))
        for c, off in cols.items():
            hh, pos = divmod(off, 32 * RS)
            col = pos - mis[h0 + hh]
            assert (hh, col) == (c // dk, c % dk) and 0 <= col < dk
            seen.add((h0 + hh, col))
        for c4 in range(W // 4):
            assert (h0 * dk + 4 * c4) % 4 == 0  # four bf16 of a plane: 8 bytes
    assert seen == {(h, c) for h in range(heads) for c in range(dk)}


def test_planes_sum_back_to_h_exactly():
    """The pool reads h as (hi + mid) + lo in fp32: h's own value, bit for
    bit, for every |h| in [2^-100, 2^100] (lo is then a normal bf16; below,
    within 2^-24 |h|), over random mantissas at every exponent and ReLU
    outputs of unit scale."""
    g = torch.Generator().manual_seed(1)
    scales = torch.exp2(torch.randint(-100, 100, (2**18,), generator=g).float())
    x = torch.cat([(torch.randn(2**18, generator=g) * scales).abs().clamp(min=2.0**-100),
                   torch.relu(torch.randn(2**18, generator=g))])
    hi, mid, lo = split3(x)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
