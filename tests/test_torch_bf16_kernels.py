"""The plain versions of kernels A, A' and B at `compute_dtype` bfloat16
against the JAX kernels they replace, run in interpret mode (as the TPU
runs the kernel path: q, k and v stay fp32), on bf16 inputs made from a
seed with numpy.

  * A: `msa_encoder_pooled_plain` on bf16 titles and weights against
    `msa_encoder_pooled` at bf16, at titles of L 12, 16 and 40 (the long
    unit), within 1e-5 * max(1, |jax|); fp32 out.
  * A': `msa_encoder_bwd_plain` at dropout 0 against the JAX kernel's VJP:
    dx (bf16) within one bf16 ulp of each element, the weight gradients
    (fp32) within 1e-5 of each one's scale against the JAX kernel's
    gradients before its cast to bf16 (the same kernel on the bf16 values
    held in fp32, whose cast gives the bf16 VJP's values bit for bit).
  * The word dropout at bf16: the dropped operand equals
    jnp.where(m, x / keep, 0).astype(bf16) of the fp32 x, bit for bit,
    with the port's Philox mask on both sides; JAX's XLA dropout on a bf16
    x differs (it divides by keep rounded to bf16, recorded in ROADMAP.md
    section 3).
  * B: `interactive_gat_layer_plain` with bf16 weights against
    `interactive_gat_layer_fused` at G 8 and 10 within 1e-5.
  * On CPU tensors the wrappers run these plain versions and count no
    launch of either instance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.ops.pallas.gat_layer import interactive_gat_layer_fused as jax_gat_layer
from digat_tpu.ops.pallas.msa_attention_grouped import group_size, unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder
from digat_tpu_torch.ops import gat_layer as GL
from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.ops.dropout import keep_mask_plain
from tests.test_torch_support import bf16_ulp, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

BF16 = jnp.bfloat16
DIN, A = 32, 16


def _bf(a):
    """numpy fp32 -> JAX bf16."""
    return jnp.asarray(a, jnp.float32).astype(BF16)


def _t(a):
    """A JAX or numpy array -> torch, bf16 kept bf16."""
    a = jnp.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _encoder_case(N, L, heads, dk, seed):
    """bf16 titles and weights (as the model's compute copy gives them), a
    mask with an all-pad title, and an fp32 cotangent."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    msa = jax.tree.map(lambda w: w.astype(BF16), JL.mha_init(ks[0], heads, DIN, dk, dk))
    pool = jax.tree.map(lambda w: w.astype(BF16), JL.attn_pool_init(ks[1], heads * dk, A))
    rng = np.random.default_rng(seed)
    x = _bf(rng.normal(size=(N, L, DIN)))
    mask = rng.random((N, L)) < 0.75
    mask[0] = False
    cvec = jnp.asarray(rng.normal(size=(N, heads * dk)).astype(np.float32))
    return msa, pool, x, jnp.asarray(mask), cvec


def _port_args(msa, pool, x, mask):
    return (_t(x), _t(mask), _t(msa["W_Q"]["w"]), _t(msa["W_Q"]["b"]), _t(msa["W_K"]["w"]),
            _t(msa["W_V"]["w"]), _t(msa["W_V"]["b"]), _t(pool["affine1"]["w"]),
            _t(pool["affine1"]["b"]), _t(pool["affine2"]["w"][:, 0]))


def _fused(mask, heads, dk):
    def f(m, p, xx):
        out, _ = jax_msa_encoder(xx, mask, m, p, heads, dk, tile=8, interpret=True)
        return unpad_heads(out, heads, dk)
    return f


SHAPES = [(12, 4, 8), (16, 4, 8), (40, 2, 8)]  # (L, heads, dk): the short unit, then the long


@pytest.mark.parametrize("L,heads,dk", SHAPES, ids=lambda v: str(v))
def test_msa_encoder_plain_matches_jax_kernel_at_bf16(L, heads, dk):
    assert group_size(heads, L, dk) > 0
    msa, pool, x, mask, _ = _encoder_case(7, L, heads, dk, seed=L)
    want = np.asarray(_fused(mask, heads, dk)(msa, pool, x))
    assert want.dtype == np.float32
    got = ME.msa_encoder_pooled_plain(*_port_args(msa, pool, x, mask), heads)
    assert got.dtype == torch.float32
    err = np.abs(got.numpy() - want)
    assert (err <= 1e-5 * np.maximum(1.0, np.abs(want))).all(), err.max()


@pytest.mark.parametrize("L,heads,dk", SHAPES, ids=lambda v: str(v))
def test_msa_encoder_bwd_plain_matches_jax_vjp_at_bf16(L, heads, dk):
    msa, pool, x, mask, cvec = _encoder_case(6, L, heads, dk, seed=L + 1)
    fused = _fused(mask, heads, dk)
    _, vjp = jax.vjp(fused, msa, pool, x)
    g_msa, g_pool, g_x = vjp(cvec)
    # the same kernel on the bf16 values held in fp32: its gradients before
    # the cast, which the bf16 VJP rounds
    up = lambda t: jax.tree.map(lambda w: w.astype(jnp.float32), t)
    _, vjp32 = jax.vjp(fused, up(msa), up(pool), up(x))
    f_msa, f_pool, _ = vjp32(cvec)
    for a, b in zip(jax.tree.leaves((g_msa, g_pool)), jax.tree.leaves((f_msa, f_pool))):
        assert a.dtype == BF16
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      np.asarray(b.astype(BF16).astype(jnp.float32)))
    dx, *grads = ME.msa_encoder_bwd_plain(*_port_args(msa, pool, x, mask), _t(cvec), heads)
    assert dx.dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in grads)
    want_dx = _t(g_x).float()
    assert ((dx.float() - want_dx).abs() <= bf16_ulp(want_dx)).all()
    wants = (f_msa["W_Q"]["w"], f_msa["W_Q"]["b"], f_msa["W_K"]["w"], f_msa["W_V"]["w"],
             f_msa["W_V"]["b"], f_pool["affine1"]["w"], f_pool["affine1"]["b"],
             f_pool["affine2"]["w"][:, 0])
    for got, want in zip(grads, wants):
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_word_dropout_at_bf16_rounds_once():
    """The dropped bf16 operand is bf16(x / keep) where kept: JAX's form on
    the fp32 x, bit for bit, under the port's mask; JAX's own dropout on a
    bf16 x divides by bf16(keep) = 0.80078125 and differs."""
    rng = np.random.default_rng(3)
    N, L, rate = 40, 12, 0.2
    x = _bf(rng.normal(size=(N, L, DIN)))
    keep = 1.0 - rate
    m = keep_mask_plain(N, L * DIN, rate, 11, 5).reshape(N, L, DIN).numpy()
    got = ME.drop_titles_plain(_t(x), rate, 11, 5)
    want = jnp.where(m, x.astype(jnp.float32) / keep, 0.0).astype(BF16)
    np.testing.assert_array_equal(got.to(torch.bfloat16).float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    quirk = jnp.where(m, x / keep, 0.0).astype(BF16)
    assert int((quirk != want).sum()) > 0


def _gat_case(B, G, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    adj = (rng.random((B, G, G)) < 0.3) | np.eye(G, dtype=bool)
    adj[0, 1] = False  # a row with no neighbour: uniform alpha
    weights = [_bf(w) for w in (f(D, D, sc=0.2), f(D, sc=0.05), f(D, D, sc=0.2),
                                f(D, D, sc=0.2), f(D, D, sc=0.2), f(D, sc=0.05), f(D, sc=0.2))]
    return [jnp.asarray(f(B, G, D, sc=0.3)), jnp.asarray(adj), jnp.asarray(f(B, D, sc=0.3))] \
        + weights


@pytest.mark.parametrize("G", [8, 10])
def test_gat_layer_plain_with_bf16_weights_matches_jax_kernel(G):
    case = _gat_case(5, G, 32, seed=G)
    want = np.asarray(jax_gat_layer(*case, interpret=True))
    assert want.dtype == np.float32
    got = GL.interactive_gat_layer_plain(*map(_t, case))
    assert got.dtype == torch.float32
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


def test_wrappers_on_cpu_run_the_plain_versions_at_bf16():
    msa, pool, x, mask, cvec = _encoder_case(5, 12, 4, 8, seed=9)
    args = _port_args(msa, pool, x, mask)
    counts = lambda: (ME.msa_encoder_pooled.launches, ME.msa_encoder_pooled.launches_bf16,
                      ME.msa_encoder_bwd.launches, ME.msa_encoder_bwd.launches_bf16,
                      GL.interactive_gat_layer_fused.launches,
                      GL.interactive_gat_layer_fused.launches_bf16)
    before = counts()
    torch.testing.assert_close(ME.msa_encoder_pooled(*args, 4),
                               ME.msa_encoder_pooled_plain(*args, 4), rtol=0, atol=0)
    for a, b in zip(ME.msa_encoder_bwd(*args, _t(cvec), 4),
                    ME.msa_encoder_bwd_plain(*args, _t(cvec), 4)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    case = list(map(_t, _gat_case(3, 8, 32, seed=1)))
    torch.testing.assert_close(GL.interactive_gat_layer_fused(*case),
                               GL.interactive_gat_layer_plain(*case), rtol=0, atol=0)
    assert counts() == before
