"""MSA titles past the short attention unit: kernels A and A' at L 33-128
and dk up to 128 (their plain versions), and the route beyond L 128.

  * `msa_encoder_pooled_plain` and `msa_encoder_bwd_plain` at L 33, 48, 64
    and 128 and at dk 80 and 128 against the JAX package's fused kernel
    `msa_encoder_pooled` run in interpret mode (as tests/test_msa_encoder.py
    runs it), forward and every gradient, within 1e-5 of each output's
    scale; title 0 all pad;
  * where `group_size(heads, L, dk)` is 0 (L 160), the port's news encoder
    (the attention pair, ReLU, the pool) against the JAX encoder's `L.mha`
    route within 1e-5, and at L 128 the kernel route against the same;
  * the dispatch on the card's path, with the stub library of
    tests/test_torch_guards.py standing in for the card: kernel A (and no
    attention launch) up to L 128, the attention pair beyond, whose word
    dropout in training is kernel A'';
  * the configuration takes any title length on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.models import news_encoders as JN
from digat_tpu.ops.pallas.msa_attention_grouped import unpad_heads
from digat_tpu.ops.pallas.msa_encoder import msa_encoder_pooled as jax_msa_encoder_pooled
from digat_tpu_torch.config import Config
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops import msa_encoder as ME
from digat_tpu_torch.ops.msa_attention_grouped import group_size
from tests.test_torch_guards import _StubCuda
from tests.test_torch_support import models, one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

DIN, A = 24, 16


def _jax_inputs(N, L, heads, dk, seed):
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    msa = JL.mha_init(ks[0], heads, DIN, dk, dk)
    pool = JL.attn_pool_init(ks[1], heads * dk, A)
    x = jax.random.normal(ks[2], (N, L, DIN))
    mask = jax.random.uniform(ks[3], (N, L)) < 0.75
    mask = mask.at[0].set(False)  # an all-pad title
    cvec = jax.random.normal(ks[4], (N, heads * dk))
    return msa, pool, x, mask, cvec


def _port_args(msa, pool, x, mask):
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(x), t(mask), t(msa["W_Q"]["w"]), t(msa["W_Q"]["b"]), t(msa["W_K"]["w"]),
            t(msa["W_V"]["w"]), t(msa["W_V"]["b"]), t(pool["affine1"]["w"]),
            t(pool["affine1"]["b"]), t(pool["affine2"]["w"][:, 0]))


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= 1e-5 * scale, (what, err, scale)


@pytest.mark.parametrize("L,heads,dk", [(33, 4, 8), (48, 4, 8), (64, 2, 12), (128, 2, 8),
                                        (40, 2, 80), (20, 1, 128)])
def test_plain_kernels_match_jax_interpret_kernel(L, heads, dk):
    """Forward and gradients of kernels A's and A''s plain versions against
    the JAX kernel (interpret mode, group size g = group_size(heads, L, dk)
    heads a 128-lane group)."""
    N = 5
    assert group_size(heads, L, dk) > 0
    msa, pool, x, mask, cvec = _jax_inputs(N, L, heads, dk, seed=L + dk)

    def fused(m, p, xx):
        out, _ = jax_msa_encoder_pooled(xx, mask, m, p, heads, dk, tile=8, interpret=True)
        return unpad_heads(out, heads, dk)

    want = fused(msa, pool, x)
    args = _port_args(msa, pool, x, mask)
    got = ME.msa_encoder_pooled_plain(*args, heads)
    _close(got.numpy(), want, "pooled")
    g_msa, g_pool, g_x = jax.grad(lambda m, p, xx: jnp.sum(fused(m, p, xx) * cvec),
                                  argnums=(0, 1, 2))(msa, pool, x)
    dx, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv = ME.msa_encoder_bwd_plain(
        *args, torch.from_numpy(np.array(cvec)), heads)
    for what, a, b in (("dx", dx, g_x), ("dwq", dwq, g_msa["W_Q"]["w"]),
                       ("dbq", dbq, g_msa["W_Q"]["b"]), ("dwk", dwk, g_msa["W_K"]["w"]),
                       ("dwv", dwv, g_msa["W_V"]["w"]), ("dbv", dbv, g_msa["W_V"]["b"]),
                       ("dw1", dw1, g_pool["affine1"]["w"]), ("db1", db1, g_pool["affine1"]["b"]),
                       ("dv", dv, g_pool["affine2"]["w"][:, 0])):
        _close(a.numpy(), b, what)


@pytest.mark.parametrize("L", [128, 160])
def test_news_encoder_routes_match_jax(L):
    """The port's MSA news encoder at L 128 (kernel A's route) and L 160
    (group_size 0: the attention pair, ReLU, the pool) against the JAX
    encoder's `L.mha` route (use_pallas off), in eval."""
    jm, params, pm = models(seed=6, max_title_length=L)
    cfg = jm.config
    assert (group_size(cfg.MSA_head_num, L, cfg.MSA_head_dim) > 0) == (L <= 128)
    assert pm.news_encoder.fused == (L <= 128)
    rng = np.random.default_rng(L)
    text = rng.integers(0, cfg.vocabulary_size, (7, L)).astype(np.int32)
    mask = np.arange(L)[None, :] < rng.integers(0, L + 1, (7, 1))
    mask[0] = False
    want = np.asarray(JN.encode(params["news_encoder"], jm.news_st, jax.random.PRNGKey(0),
                                False, jnp.asarray(text), jnp.asarray(mask)))
    with torch.inference_mode():
        got = pm.news_encoder(torch.from_numpy(text.astype(np.int64)),
                              torch.from_numpy(mask)).numpy()
    _close(got, want, f"news encoder at L {L}")


@pytest.mark.parametrize("L,kernel", [(32, "msa_encoder_pooled_f32"),
                                      (128, "msa_encoder_pooled_f32"),
                                      (129, "msa_attention_fwd_f32"),
                                      (160, "msa_attention_fwd_f32")])
def test_dispatch_on_the_card_path(monkeypatch, L, kernel):
    """With the card's dispatch (a stub library recording the C calls): up
    to L 128 the encoder launches kernel A and no attention kernel; beyond,
    the attention pair and no kernel A; in training beyond L 128 the word
    dropout is one launch of kernel A''."""
    stub = _StubCuda(monkeypatch)
    monkeypatch.setattr(build, "use_kernel", lambda where: True)
    _, _, pm = models(seed=7, max_title_length=L)
    text = torch.randint(0, pm.config.vocabulary_size, (3, L))
    mask = torch.ones(3, L, dtype=torch.bool)
    with torch.inference_mode():
        pm.news_encoder(text, mask)
    calls = [n for n, _ in stub.calls if not n.endswith(("_init", "_scratch_floats"))]
    assert calls == [kernel]
    stub.calls.clear()
    with torch.no_grad():
        pm.news_encoder(text, mask, seed=3, site=1)
    calls = [n for n, _ in stub.calls if not n.endswith(("_init", "_scratch_floats"))]
    assert calls == ([kernel] if L <= 128 else ["dropout_apply_f32", kernel])


def test_config_takes_any_title_length_on_the_card():
    for L in (33, 128, 129, 300):
        assert Config(max_title_length=L).check_options().max_title_length == L
    assert Config.from_args(["--max_title_length", "200"]).device == "cuda"
