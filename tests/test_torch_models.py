"""Port news encoder, DIGAT graph encoder and model against `digat_tpu` in
eval mode, on the same parameters (carried by `load_jax_params`), CPU,
fp32 rtol/atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.data.user_graph import build_user_graph_np
from digat_tpu.models import graph_encoders as JG
from digat_tpu.models import news_encoders as JN
from tests.test_torch_support import MODULE_TOL, models


def _key():
    """An eval-mode key (unused by the math), made at call time: another
    test in the same process may switch JAX's default PRNG implementation
    (the CLI sets `jax_default_prng_impl`), which changes the key shape."""
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="module")
def setup():
    jm, params, pm = models(seed=0)
    cfg = jm.config
    rng = np.random.default_rng(5)
    B, Gn, H, D = 6, cfg.news_graph_size, cfg.max_history_num, cfg.news_embedding_dim
    C = cfg.category_num
    cat = rng.integers(0, C, (B, H)).astype(np.int32)
    cat[0] = C  # empty history
    cat[1, 3:] = C
    ug, cm = build_user_graph_np(cat, H, C)
    news_graph = (rng.random((B, Gn, Gn)) < 0.3) | np.eye(Gn, dtype=bool)
    gmask = np.concatenate([np.zeros((B, 1), bool), rng.random((B, Gn - 1)) < 0.8], 1)
    inputs = dict(
        news_x=(rng.normal(size=(B, Gn, D)) * 0.5).astype(np.float32),
        news_graph=news_graph, gmask=gmask,
        hist=(rng.normal(size=(B, H, D)) * 0.5).astype(np.float32),
        user_graph=ug, cat_mask=cm, cat=cat,
        c_n0=(rng.normal(size=(B, D)) * 0.5).astype(np.float32),
    )
    return jm, params, pm, inputs


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lead", [(7,), (2, 3)])
def test_news_encoder(setup, lead):
    jm, params, pm, _ = setup
    cfg = jm.config
    rng = np.random.default_rng(len(lead))
    text = rng.integers(0, cfg.vocabulary_size, (*lead, cfg.max_title_length)).astype(np.int32)
    mask = rng.random((*lead, cfg.max_title_length)) < 0.7
    mask.reshape(-1, cfg.max_title_length)[0] = False
    want = np.asarray(JN.encode(params["news_encoder"], jm.news_st, _key(), False,
                                jnp.asarray(text), jnp.asarray(mask)))
    got = pm.encode_news(_t(text), _t(mask)).numpy()
    assert got.shape == (*lead, cfg.news_embedding_dim)
    np.testing.assert_allclose(got, want, **MODULE_TOL)


def test_news_and_user_graph_context(setup):
    jm, params, pm, x = setup
    gp, st = params["graph_encoder"], jm.graph_st
    want = np.asarray(JG.news_graph_context(gp["news_ctx"], st, _key(), False,
                                            jnp.asarray(x["news_x"]), jnp.asarray(x["gmask"])))
    got = pm.graph_encoder.news_graph_context(_t(x["news_x"]), _t(x["gmask"])).detach().numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    user_x = JG._user_graph_nodes(gp, st, _key(), False, jnp.asarray(x["hist"]))
    got_ux = pm.graph_encoder.user_graph_nodes(_t(x["hist"])).detach()
    np.testing.assert_allclose(got_ux.numpy(), np.asarray(user_x), rtol=0, atol=0)
    want = np.asarray(JG.user_graph_context(gp["user_ctx"], st, _key(), False, user_x,
                                            jnp.asarray(x["cat_mask"]), jnp.asarray(x["cat"]),
                                            jnp.asarray(x["c_n0"])))
    got = pm.graph_encoder.user_graph_context(got_ux, _t(x["cat_mask"]), _t(x["cat"]),
                                              _t(x["c_n0"])).detach().numpy()
    np.testing.assert_allclose(got, want, **MODULE_TOL)


@pytest.mark.parametrize("cached", [True, False], ids=["c_n0", "no_c_n0"])
def test_graph_encoder_forward(setup, cached):
    jm, params, pm, x = setup
    c_n0 = x["c_n0"] if cached else None
    want = JG.forward(params["graph_encoder"], jm.graph_st, _key(), False,
                      jnp.asarray(x["news_x"]), jnp.asarray(x["news_graph"]),
                      jnp.asarray(x["gmask"]), jnp.asarray(x["hist"]),
                      jnp.asarray(x["user_graph"]), jnp.asarray(x["cat_mask"]),
                      jnp.asarray(x["cat"]), None if c_n0 is None else jnp.asarray(c_n0))
    with torch.inference_mode():
        got = pm.graph_encoder(_t(x["news_x"]), _t(x["news_graph"]), _t(x["gmask"]),
                               _t(x["hist"]), _t(x["user_graph"]), _t(x["cat_mask"]),
                               _t(x["cat"]), None if c_n0 is None else _t(c_n0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODULE_TOL)


def test_model_inference_and_initial_context(setup):
    jm, params, pm, x = setup
    want = np.asarray(jm.inference(params, jnp.asarray(x["hist"]), jnp.asarray(x["user_graph"]),
                                   jnp.asarray(x["cat_mask"]), jnp.asarray(x["cat"]),
                                   jnp.asarray(x["news_x"]), jnp.asarray(x["news_graph"]),
                                   jnp.asarray(x["gmask"]), jnp.asarray(x["c_n0"])))
    got = pm.inference(_t(x["hist"]), _t(x["user_graph"]), _t(x["cat_mask"]), _t(x["cat"]),
                       _t(x["news_x"]), _t(x["news_graph"]), _t(x["gmask"]),
                       _t(x["c_n0"])).numpy()
    assert got.shape == (x["hist"].shape[0],)
    np.testing.assert_allclose(got, want, **MODULE_TOL)
    want0 = np.asarray(jm.initial_news_context(params, jnp.asarray(x["news_x"]),
                                               jnp.asarray(x["gmask"])))
    got0 = pm.initial_news_context(_t(x["news_x"]), _t(x["gmask"])).numpy()
    np.testing.assert_allclose(got0, want0, **MODULE_TOL)


def test_model_is_eval_only(setup):
    """The eval entry points stay eval only: they run under inference mode
    and their results carry no gradient, although the model now trains
    (its parameters require grad and `train()` is the nn.Module one)."""
    _, _, pm, x = setup
    assert all(p.requires_grad for p in pm.parameters())
    assert pm.train() is pm and pm.eval() is pm
    rng = np.random.default_rng(1)
    text = _t(rng.integers(0, pm.config.vocabulary_size, (3, pm.config.max_title_length)))
    out = pm.encode_news(text, _t(rng.random(text.shape) < 0.7))
    c0 = pm.initial_news_context(_t(x["news_x"]), _t(x["gmask"]))
    for t in (out, c0):
        assert t.is_inference() and not t.requires_grad
