"""Kernel A's chain of launches (digat_tpu_torch/csrc/msa_encoder.cu), stage
by stage as the kernel runs it, replayed in plain torch on the CPU.

1. word dropout of x by the Philox bits of `ops.dropout` (what the
   kernels draw; kernel A' draws them again);
2. q|k|v = xd [Wq|Wk|Wv]^T + [bq | 0 | bv], one product over Din;
3. per (title, head) unit: scores, the softmax from four warps' maxima and
   sums over their 8 key slots each (a title of L < 32 leaves the slots
   past L at -inf: a warp with none left sums 0), h = relu(P v) written
   over q;
4. the pool logits as per-warp-column parts: tanh(h W1^T + b1) times v
   summed over each 32 columns, in tiles of 128 columns (4 parts a tile,
   the parts past A empty), u never kept;
5. a warp per title: the parts summed in order, the masked softmax (-1e9
   fill, all-pad uniform over the L positions, slots past L weight 0),
   out = sum_l alpha_l h_l in order.

The replay is held against `msa_encoder_pooled_plain` (fp32, 1e-5) with and
without dropout at L 32, 16, 7 and 1, against the JAX `msa_encoder_pooled`
through its XLA
composition and its Pallas kernel in interpret mode (fp32, 1e-5), and, with
the two products replaced by the 3xTF32 split of `tc_gemm.cuh` emulated as
tests/test_torch_tf32x3.py does, at A's product shapes (K 300 and K 400)
against the float64 plain version inside the card gate
(1e-4 * max(1, max |ref|)). The emulation adds each m16n8k8 product into
its fp32 accumulator rounding toward zero, as the tensor cores do, and
A's products (`kRN`) add each 32-deep k-tile's sums into the running sums
rounding to nearest; a test records why: summed toward zero throughout,
3xTF32 lands several times further from the exact product than an fp32
product does, and with kRN about as far."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.ops.pallas.msa_attention_grouped import group_size, unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder
from digat_tpu_torch.ops import msa_encoder as ME
from tests.test_torch_tf32x3 import split

L = 32
SLOTS = 32  # title slots of an attention unit: one lane per position
WARPS = 4  # warps of an attention unit; each takes 8 key slots in the row pass
POOL_BN = 128  # the pool product's tile width; 4 warp columns of 32 a tile
GATE = 1e-4


def matmul(a, b):
    return a @ b


def round_toward_zero(x):
    """float64 -> float32, rounding toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tc_3xtf32(a, b, rn_tiles: bool):
    """a [M, K] @ b [K, N] as tc_gemm.cuh sums it: operands split into TF32
    hi and lo, each m16n8k8 step's lo*hi, hi*lo and hi*hi (8 deep, exact)
    added to the fp32 accumulator rounding toward zero; with `rn_tiles`
    (kRN) each 32-deep k-tile sums into fresh accumulators that are then
    added to the running sums rounding to nearest."""
    ah, al = split(a)
    bh, bl = split(b)
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    acc = total
    for k0 in range(0, a.shape[1], 32):
        if rn_tiles:
            acc = np.zeros_like(total)
        for k in range(k0, min(a.shape[1], k0 + 32), 8):
            s = slice(k, k + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                step = x[:, s].astype(np.float64) @ y[s].astype(np.float64)
                acc = round_toward_zero(acc.astype(np.float64) + step)
        if rn_tiles:
            total = total + acc
        else:
            total = acc
    return total


def product_tf32x3(a, b):
    """a [M, K] @ b [K, N] as kernel A's products sum it (kRN, float32)."""
    return torch.from_numpy(tc_3xtf32(a.numpy(), b.numpy(), rn_tiles=True))


def chain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate=0.0, seed=0, site=0,
          product=matmul):
    N, L, Din = x.shape
    D, A = wq.shape[1], w1.shape[1]
    dk = D // heads
    M = N * L
    scale = 1.0 / math.sqrt(float(dk))
    # 1. dropout
    xd = ME.drop_titles_plain(x, rate, seed, site).reshape(M, Din)
    # 2. the Q|K|V product with its bias [bq | 0 | bv]
    wqkv = torch.cat([wq.t(), wk.t(), wv.t()])  # [3D, Din], as the kernel reads it
    qkv = product(xd, wqkv.t().contiguous()) + torch.cat([bq, torch.zeros_like(bq), bv])
    q, k, val = (qkv[:, i * D:(i + 1) * D].reshape(N, L, heads, dk).permute(0, 2, 1, 3)
                 for i in range(3))  # [N, heads, L, dk]
    # 3. per unit: four warps' maxima and sums of each row over their key
    # slots (-inf past L), then P and h
    s = torch.einsum("nhic,nhjc->nhij", q, k) * scale
    absent = torch.full((N, heads, L, SLOTS - L), -math.inf, dtype=s.dtype)
    sw = torch.cat([s, absent], -1).reshape(N, heads, L, WARPS, SLOTS // WARPS)
    mw = sw.max(-1).values  # [N, heads, L, WARPS]
    empty = mw == -math.inf  # a warp with no key left
    lw = torch.where(empty, 0.0, torch.exp(sw - torch.where(empty, 0.0, mw)[..., None]).sum(-1))
    m = mw.max(-1).values
    l_sum = (lw * torch.exp(mw - m[..., None])).sum(-1)
    p = torch.exp(s - m[..., None]) * (1.0 / l_sum)[..., None]
    h = torch.relu(torch.einsum("nhij,nhjc->nhic", p, val)).permute(0, 2, 1, 3).reshape(M, D)
    qkv = qkv.clone()
    qkv[:, :D] = h  # h over q; the pool product reads it with rows 3D apart
    # 4. the pool logits' parts, one a warp column of 32
    u = torch.tanh(product(qkv[:, :D].contiguous(), w1) + b1)
    parts = -(-A // POOL_BN) * 4
    lgpart = torch.zeros(parts, M, dtype=x.dtype)
    for c0 in range(0, A, 32):
        lgpart[c0 // 32] = u[:, c0:c0 + 32] @ v[c0:c0 + 32]
    # 5. a warp per title: the parts in order, the masked softmax, the sum
    lg = lgpart[0].clone()
    for pp in range(1, parts):
        lg = lg + lgpart[pp]
    lg = torch.where(mask.to(torch.bool), lg.reshape(N, L), torch.full((N, L), -1e9,
                                                                        dtype=x.dtype))
    alpha = torch.softmax(lg, -1)
    hn = qkv[:, :D].reshape(N, L, D)
    out = torch.zeros(N, D, dtype=x.dtype)
    for pos in range(L):
        out = out + alpha[:, pos, None] * hn[:, pos]
    return out


def _args(N, Din, heads, dk, A, seed, dtype=torch.float32, L=L):
    rng = np.random.default_rng(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)
                                            ).to(dtype)
    x = r(N, L, Din)
    mask = torch.from_numpy(rng.random((N, L)) < 0.75)
    mask[0] = False  # an all-pad title: uniform pool
    return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
            r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
            r(A, sc=A ** -0.5))


@pytest.mark.parametrize("N,Din,heads,dk,A,rate", [
    (5, 24, 4, 8, 16, 0.0), (5, 24, 4, 8, 16, 0.2), (3, 300, 16, 25, 256, 0.2),
    (2, 64, 1, 64, 512, 0.0), (4, 16, 2, 25, 160, 0.2)])
def test_chain_matches_plain(N, Din, heads, dk, A, rate):
    args = _args(N, Din, heads, dk, A, seed=N + dk + A)
    got = chain(*args, heads, rate, 41, 3)
    want = ME.msa_encoder_pooled_plain(*args, heads, rate, 41, 3)
    assert got.shape == want.shape == (N, heads * dk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("N,Din,heads,dk,A,L", [
    (5, 100, 10, 20, 64, 16), (6, 24, 4, 8, 16, 7), (4, 300, 16, 25, 256, 20),
    (3, 16, 2, 25, 160, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_chain_matches_plain_short_titles(N, Din, heads, dk, A, L, rate):
    """Titles of L < 32 on the first L slots: the matrix cells' L 16 at
    their widths, odd L 7 and 20, and L 1; title 0 all pad, pooled with
    weight 1 / L."""
    args = _args(N, Din, heads, dk, A, seed=N + dk + A + L, L=L)
    got = chain(*args, heads, rate, 41, 3)
    want = ME.msa_encoder_pooled_plain(*args, heads, rate, 41, 3)
    assert got.shape == want.shape == (N, heads * dk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if rate == 0.0:  # the all-pad title: the mean of its L rows of h
        x, _, wq, bq, wk, wv, bv = args[:7]
        h = ME.msa_encoder_pooled_plain(x[:1], torch.ones(1, L, dtype=torch.bool), wq, bq, wk,
                                        wv, bv, torch.zeros_like(args[7]), args[8], args[9],
                                        heads)
        np.testing.assert_allclose(got[0].numpy(), h[0].numpy(), rtol=0, atol=1e-5)


def _jax_case(n, din, heads, dk, A, seed, L=L):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    msa = JL.mha_init(ks[0], heads, din, dk, dk)
    pool = JL.attn_pool_init(ks[1], heads * dk, A)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, L, din)).astype(np.float32)
    mask = rng.random((n, L)) < 0.75
    mask[0] = False
    return msa, pool, x, mask


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(6, 24, 4, 8, 16), (9, 20, 4, 5, 12)],
                         ids=lambda s: "x".join(map(str, s)))
def test_chain_matches_jax(shape, interpret):
    n, din, heads, dk, A = shape
    assert group_size(heads, L, dk) > 0
    msa, pool, x, mask = _jax_case(n, din, heads, dk, A, seed=n)
    padded, _ = jax_msa_encoder(jnp.asarray(x), jnp.asarray(mask), msa, pool, heads, dk,
                                tile=8, interpret=interpret)
    want = np.asarray(unpad_heads(padded, heads, dk))
    t = lambda a: torch.from_numpy(np.array(a))
    got = chain(t(x), t(mask), t(msa["W_Q"]["w"]), t(msa["W_Q"]["b"]), t(msa["W_K"]["w"]),
                t(msa["W_V"]["w"]), t(msa["W_V"]["b"]), t(pool["affine1"]["w"]),
                t(pool["affine1"]["b"]), t(pool["affine2"]["w"][:, 0]), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_chain_at_3xtf32_meets_the_gate(rate):
    """The production widths (Din 300, 16 x 25 heads, A 256) on 8 titles:
    the Q|K|V product at K 300 and the pool's at K 400, each at 3xTF32,
    against the float64 plain version."""
    args = _args(8, 300, 16, 25, 256, seed=11)
    got = chain(*args, 16, rate, 7, 0, product=product_tf32x3)
    ref = ME.msa_encoder_pooled_plain(*(t.double() if t.is_floating_point() else t
                                        for t in args), 16, rate, 7, 0)
    err = float((got.double() - ref).abs().max())
    assert err <= GATE * max(1.0, float(ref.abs().max())), err


@pytest.mark.parametrize("what,M,K,N", [("Q|K|V", 256, 300, 1200), ("pool", 256, 400, 256)])
def test_tensor_core_rounding_and_krn(what, M, K, N):
    """Why A's products add each k-tile's sums rounding to nearest: summed
    toward zero all the way (114 roundings at K 300), the RMS error against
    float64 is over 4 times an fp32 product's; with kRN it is within 1.5
    times an fp32 product's."""
    rng = np.random.default_rng(K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rms = lambda x: float(np.sqrt(np.mean((x - ref) ** 2)))
    fp32 = rms(a @ b)
    toward_zero = rms(tc_3xtf32(a, b, rn_tiles=False))
    krn = rms(tc_3xtf32(a, b, rn_tiles=True))
    assert toward_zero > 4 * fp32, (what, toward_zero, fp32)
    assert krn <= 1.5 * fp32, (what, krn, fp32)


# the parity matrix's widths (scripts/parity/run_parity.py GEOMETRY): word
# 100, L 16, 10 x 20 heads, attention 64, history 16, SAG 3 neighbours and 2
# hops, depth 3
MATRIX = dict(word_embedding_dim=100, max_title_length=16, MSA_head_num=10, MSA_head_dim=20,
              attention_dim=64, max_history_num=16, SAG_neighbors=3, SAG_hops=2,
              graph_depth=3, vocabulary_size=80, category_num=6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _encoder_args(msa, pool, x, mask):
    return (_t(x), _t(mask), _t(msa["W_Q"]["w"]), _t(msa["W_Q"]["b"]), _t(msa["W_K"]["w"]),
            _t(msa["W_V"]["w"]), _t(msa["W_V"]["b"]), _t(pool["affine1"]["w"]),
            _t(pool["affine1"]["b"]), _t(pool["affine2"]["w"][:, 0]))


@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_plain_encoder_matches_jax_at_matrix_widths(interpret):
    """At L 16, Din 100, 10 x 20 heads and A 64 the JAX package runs its
    fused kernel (group_size > 0); the port's plain forward and backward
    (what kernels A and A' are held to on the card) match it, the forward
    within 1e-5 and the gradients within 1e-4 * (max |grad| + 1e-3), as
    tests/test_torch_train_kernels.py holds them at L 32."""
    heads, dk = 10, 20
    assert group_size(heads, 16, dk) > 0
    msa, pool, x, mask = _jax_case(6, 100, heads, dk, 64, seed=16, L=16)
    dp = np.random.default_rng(2).normal(size=(6, heads * dk)).astype(np.float32)

    def enc(m, p, xx):
        out, _ = jax_msa_encoder(xx, jnp.asarray(mask), m, p, heads, dk, tile=8,
                                 interpret=interpret)
        return unpad_heads(out, heads, dk)

    args = _encoder_args(msa, pool, x, mask)
    want = np.asarray(enc(msa, pool, jnp.asarray(x)))
    got = ME.msa_encoder_pooled_plain(*args, heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    gm, gp, gx = jax.grad(lambda m, p, xx: jnp.sum(enc(m, p, xx) * dp), argnums=(0, 1, 2))(
        msa, pool, jnp.asarray(x))
    want_g = [np.asarray(a) for a in (gx, gm["W_Q"]["w"], gm["W_Q"]["b"], gm["W_K"]["w"],
                                      gm["W_V"]["w"], gm["W_V"]["b"], gp["affine1"]["w"],
                                      gp["affine1"]["b"], gp["affine2"]["w"][:, 0])]
    for g, w in zip(ME.msa_encoder_bwd_plain(*args, _t(dp), heads), want_g):
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) < 1e-4 * (scale + 1e-3), scale


def test_model_matches_jax_at_matrix_geometry_fp64():
    """The whole MSA-DIGAT at the matrix geometry, on the JAX package's
    weights (`interop.load_jax_params`), eval logits in float64 within
    1e-12 of the JAX model's."""
    from digat_tpu.data.user_graph import build_user_graph_np
    from tests.test_torch_support import models

    jm, params, pm = models(seed=4, **MATRIX)
    cfg = jm.config
    pm = pm.double()
    rng = np.random.default_rng(6)
    B, Nn, H, Gn, L, C = 3, 5, cfg.max_history_num, cfg.news_graph_size, 16, cfg.category_num
    V = cfg.vocabulary_size
    cat = rng.integers(0, C, (B, H)).astype(np.int32)
    cat[0, 5:] = C
    ug, cm = build_user_graph_np(cat, H, C)
    user_text = rng.integers(0, V, (B, H, L)).astype(np.int32)
    user_mask = rng.random((B, H, L)) < 0.7
    user_mask[0, 5:] = False  # pad news: all-pad titles
    news_text = rng.integers(0, V, (B, Nn, Gn, L)).astype(np.int32)
    news_mask = rng.random((B, Nn, Gn, L)) < 0.7
    news_graph = (rng.random((B, Nn, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool)
    gmask = np.concatenate([np.zeros((B, Nn, 1), bool), rng.random((B, Nn, Gn - 1)) < 0.8], -1)
    inputs = (user_text, user_mask, ug, cm, cat, news_text, news_mask, news_graph, gmask)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
        want = np.asarray(jm.forward(p64, jax.random.PRNGKey(0), False,
                                     *(jnp.asarray(a) for a in inputs)))
    with torch.no_grad():
        got = pm.forward(*(_t(a) for a in inputs)).numpy()
    assert want.dtype == got.dtype == np.float64 and got.shape == (B, Nn)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
