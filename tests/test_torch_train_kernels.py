"""The plain versions of the training kernels against the JAX functions they
replace, on the CPU:

  * A' (encoder backward): the plain encoder's gradients, word-dropout mask
    applied, against `msa_encoder_pooled(..., interpret=True)` gradients
    and the JAX XLA composition, at the full widths of
    tests/test_msa_encoder.py (16 x 25 heads, L 32, Din 300, A 256), fp32,
    max |diff| <= 1e-4 * (max |grad| + 1e-3) as that file uses;
  * C (Eq. 8 scores): the plain forward and written backward against
    `interactive_gat_scores_pallas` in interpret mode and `jax.grad` of the
    XLA expression, G 26, and G 6 against the XLA expression only (the JAX
    kernel cannot trace under 8 nodes, ROADMAP.md section 3), <= 1e-5;
  * D (embedding gradient): `index_add_` against `embedding_lookup(...,
    interpret=True)` gradients, the cases of tests/test_emb_grad.py.

The JAX package cannot run its in-kernel dropout off the TPU, so the JAX
side is given keep * x / (1 - p) with the port's Philox mask and its dx is
chain-ruled through the same mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.ops.pallas import runtime as jax_runtime
from digat_tpu.ops.pallas.emb_grad import build_sorted_emb_meta
from digat_tpu.ops.pallas.emb_grad import embedding_lookup as jax_embedding_lookup
from digat_tpu.ops.pallas.gat_scores import _scores_xla, interactive_gat_scores_pallas
from digat_tpu.ops.pallas.msa_attention_grouped import unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder
from digat_tpu_torch.ops import emb_grad as EG
from digat_tpu_torch.ops import gat_scores as GS
from digat_tpu_torch.ops.dropout import keep_mask_plain
from digat_tpu_torch.ops.msa_encoder import msa_encoder_bwd, msa_encoder_bwd_plain

HEADS, DK, LT, DIN, A = 16, 25, 32, 300, 256


@pytest.fixture(scope="module")
def encoder_case():
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    msa = JL.mha_init(ks[0], HEADS, DIN, DK, DK)
    pool = JL.attn_pool_init(ks[1], HEADS * DK, A)
    n = 12
    x = np.array(jax.random.normal(ks[2], (n, LT, DIN)))
    mask = np.array(jax.random.uniform(ks[3], (n, LT)) < 0.75)
    mask[0] = False  # all-pad title
    dp = np.random.default_rng(1).normal(size=(n, HEADS * DK)).astype(np.float32)
    return msa, pool, x, mask, dp


def _jax_grads(msa, pool, x, mask, dp, interpret):
    """Gradients of sum(encoder(x) * dp) in the JAX package: (dx, dWq, dbq,
    dWk, dWv, dbv, dW1, db1, dv)."""
    if interpret:
        def enc(m, p, xx):
            out, _ = jax_msa_encoder(xx, mask, m, p, HEADS, DK, tile=8, interpret=True)
            return unpad_heads(out, HEADS, DK)
    else:
        def enc(m, p, xx):
            return JL.attn_pool(p, jax.nn.relu(JL.mha(m, xx, HEADS)), mask=mask)

    gm, gp, gx = jax.grad(lambda m, p, xx: jnp.sum(enc(m, p, xx) * dp), argnums=(0, 1, 2))(
        msa, pool, jnp.asarray(x))
    return [np.asarray(a) for a in (gx, gm["W_Q"]["w"], gm["W_Q"]["b"], gm["W_K"]["w"],
                                    gm["W_V"]["w"], gm["W_V"]["b"], gp["affine1"]["w"],
                                    gp["affine1"]["b"], gp["affine2"]["w"][:, 0])]


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("interpret", [False, True], ids=["xla", "pallas_interpret"])
def test_encoder_backward_plain_vs_jax(encoder_case, rate, interpret):
    msa, pool, x, mask, dp = encoder_case
    n = x.shape[0]
    keep = keep_mask_plain(n, LT * DIN, rate, 31, 0).reshape(x.shape).numpy() if rate else None
    xd = np.where(keep, x / (1.0 - rate), 0.0).astype(np.float32) if rate else x
    want = _jax_grads(msa, pool, xd, mask, dp, interpret)
    if rate:
        want[0] = np.where(keep, want[0] / (1.0 - rate), 0.0)
    t = lambda a: torch.from_numpy(np.array(a))
    args = (t(x), t(mask), t(msa["W_Q"]["w"]), t(msa["W_Q"]["b"]), t(msa["W_K"]["w"]),
            t(msa["W_V"]["w"]), t(msa["W_V"]["b"]), t(pool["affine1"]["w"]),
            t(pool["affine1"]["b"]), t(pool["affine2"]["w"][:, 0]))
    got = msa_encoder_bwd(*args, t(dp), HEADS, rate, 31, 0)  # CPU: the plain version
    for g, w, ref in zip(got, want, msa_encoder_bwd_plain(*args, t(dp), HEADS, rate, 31, 0)):
        assert torch.equal(g, ref)
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) < 1e-4 * (scale + 1e-3), scale


def _scores_case(B, G, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    return f(B, G, D), f(B, G, D), f(B, D), f(D), f(B, G, G)


@pytest.mark.parametrize("G,interpret", [(26, False), (26, True), (6, False)],
                         ids=["26-xla", "26-pallas_interpret", "6-xla"])
def test_gat_scores_plain_vs_jax(G, interpret):
    k1, k2, k3, a, g = _scores_case(5, G, 40, seed=G)
    fn = interactive_gat_scores_pallas if interpret else _scores_xla
    jax_runtime.set_interpret(interpret)
    try:
        s, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in (k1, k2, k3, a)))
        want = [np.asarray(s)] + [np.asarray(v) for v in vjp(jnp.asarray(g))]
    finally:
        jax_runtime.set_interpret(False)
    t = [torch.from_numpy(v).requires_grad_(True) for v in (k1, k2, k3, a)]
    s = GS.interactive_gat_scores(*t)
    s.backward(torch.from_numpy(g))
    for got, w in zip([s.detach()] + [v.grad for v in t], want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("V,shape,skew", [(50, (7, 5), False), (300, (31,), False),
                                          (1000, (40, 32), False), (120, (50, 8), True)],
                         ids=["tiny", "1d", "production_like", "zipf"])
def test_embedding_grad_plain_vs_jax(V, shape, skew):
    rng = np.random.default_rng(1 if skew else 0)
    tok = (np.minimum(rng.zipf(1.3, shape) - 1, V - 1) if skew
           else rng.integers(0, V, shape)).astype(np.int32)
    D = 20 if skew else (36 if V < 500 else 300)
    g = rng.standard_normal(shape + (D,)).astype(np.float32)
    table = rng.standard_normal((V, D)).astype(np.float32)
    meta = build_sorted_emb_meta(tok, V, chunk=16, tile=16)
    want = np.asarray(jax.grad(lambda tb: jnp.sum(
        jax_embedding_lookup(tb, jnp.asarray(tok), meta, tile=16, interpret=True)
        * jnp.asarray(g)))(jnp.asarray(table)))
    tt = torch.from_numpy(table).requires_grad_(True)
    out = EG.embedding_lookup(tt, torch.from_numpy(tok).long())
    np.testing.assert_array_equal(out.detach().numpy(), table[tok])
    before = EG.embedding_grad.launches
    out.backward(torch.from_numpy(g))
    assert EG.embedding_grad.launches == before  # CPU: the plain version
    assert np.abs(tt.grad.numpy() - want).max() < 1e-4


def test_sort_metadata_segments():
    """Kernel D's metadata: the tokens sorted as int32 with the stable
    permutation, so the runs of one token (the segments the kernels cut at
    every chunk boundary) hold each row's slots in slot order; every row's
    run has as many slots as the row has tokens, and the scratch holds two
    pieces a chunk, at least the number of segments that cross a chunk
    boundary."""
    rng = np.random.default_rng(3)
    tok = torch.from_numpy(np.minimum(rng.zipf(1.2, 700) - 1, 49))
    ids, perm = EG.sort_metadata(tok)
    assert ids.dtype == torch.int32
    assert torch.equal(ids.long(), tok[perm])
    assert bool((ids[1:] >= ids[:-1]).all())
    same = ids[1:] == ids[:-1]
    assert bool((perm[1:][same] > perm[:-1][same]).all())  # stable
    for v in range(60):
        assert int((ids == v).sum()) == int((tok == v).sum())
    k = torch.arange(1, 700)
    crossing = int((same & (k % EG.CHUNK == 0)).sum())  # runs cut by a chunk boundary
    assert 2 * crossing <= EG.partial_rows(700)
