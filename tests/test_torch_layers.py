"""Port layers and config against `digat_tpu` (CPU, fp32, rtol/atol 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu.config import news_graph_size as jax_news_graph_size
from digat_tpu_torch import layers as PL
from digat_tpu_torch.config import Config, news_graph_size
from tests.test_torch_support import MODULE_TOL


@pytest.mark.parametrize("m,hops", [(5, 2), (3, 2), (4, 1), (2, 3)])
def test_news_graph_size(m, hops):
    assert news_graph_size(m, hops) == jax_news_graph_size(m, hops)


def test_config_protocol_overrides():
    assert Config(dataset="MIND-large").dropout_rate == 0.1
    assert Config(dataset="MIND-small", epoch=3).epoch == 16
    assert Config(dataset="MIND-small", epoch_override=2).epoch == 2
    c = Config(vocabulary_size=10, category_num=18)
    assert (c.news_graph_size, c.user_graph_size, c.news_embedding_dim) == (26, 68, 400)
    assert c.effective_eval_batch_size() == 1024


def test_masked_softmax_fill_and_uniform_rows():
    rng = np.random.default_rng(0)
    s = rng.normal(size=(5, 7)).astype(np.float32) * 3
    m = rng.random((5, 7)) < 0.6
    m[2] = False  # fully masked row -> uniform
    want = np.asarray(JL.masked_softmax(jnp.asarray(s), jnp.asarray(m), axis=-1))
    got = PL.masked_softmax(torch.from_numpy(s), torch.from_numpy(m), dim=-1).numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    np.testing.assert_allclose(got[2], np.full(7, 1 / 7), rtol=1e-6)
    assert PL.MASK_FILL == JL.MASK_FILL


def _linear_from(lin, w, b=None):
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(w).T))
        if b is not None:
            lin.bias.copy_(torch.from_numpy(np.asarray(b)))


def test_attn_pool():
    rng = np.random.default_rng(1)
    g = torch.Generator().manual_seed(0)
    pool = PL.AttentionPool(12, 6, g)
    w1, b1 = rng.normal(size=(12, 6)).astype(np.float32), rng.normal(size=6).astype(np.float32)
    w2 = rng.normal(size=(6, 1)).astype(np.float32)
    _linear_from(pool.affine1, w1, b1)
    _linear_from(pool.affine2, w2)
    x = rng.normal(size=(3, 4, 9, 12)).astype(np.float32)
    m = rng.random((3, 4, 9)) < 0.7
    m[0, 0] = False
    params = {"affine1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
              "affine2": {"w": jnp.asarray(w2)}}
    want = np.asarray(JL.attn_pool(params, jnp.asarray(x), jnp.asarray(m)))
    got = pool(torch.from_numpy(x), torch.from_numpy(m)).detach().numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_sdp_attn():
    rng = np.random.default_rng(2)
    g = torch.Generator().manual_seed(0)
    attn = PL.ScaledDotProductAttention(10, 8, 6, g)
    wk = rng.normal(size=(10, 6)).astype(np.float32)
    wq, bq = rng.normal(size=(8, 6)).astype(np.float32), rng.normal(size=6).astype(np.float32)
    _linear_from(attn.K, wk)
    _linear_from(attn.Q, wq, bq)
    x = rng.normal(size=(5, 7, 10)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    m = rng.random((5, 7)) < 0.6
    m[3] = False
    params = {"K": {"w": jnp.asarray(wk)}, "Q": {"w": jnp.asarray(wq), "b": jnp.asarray(bq)}}
    want = np.asarray(JL.sdp_attn(params, jnp.asarray(x), jnp.asarray(q), jnp.asarray(m)))
    got = attn(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(m)).detach().numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("init,gain,bias_init", [("torch", 1.0, "torch"), ("xavier", 5 / 3, "zeros")])
def test_make_linear_distribution(init, gain, bias_init):
    """Initialisers draw from the JAX package's bounds (same distribution,
    not the same bits)."""
    g = torch.Generator().manual_seed(3)
    lin = PL.make_linear(200, 300, g, init=init, gain=gain, bias_init=bias_init)
    bound = 1 / np.sqrt(200) if init == "torch" else gain * np.sqrt(6 / 500)
    w = lin.weight.detach().numpy()
    assert w.shape == (300, 200)
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    b = lin.bias.detach().numpy()
    assert (not b.any()) if bias_init == "zeros" else np.abs(b).max() <= 1 / np.sqrt(200)
