"""The port's extended layer library (`digat_tpu_torch.layers_ext`) against
`digat_tpu.layers_ext` on the CPU, on weights carried across from the JAX
`*_init` functions (`layers_ext.load_jax_params`):

  * every module's output, its input gradients and its weight gradients
    (the vector-Jacobian product of one seeded cotangent) against
    `jax.vjp` of the JAX function: max |port - jax| <= 1e-5 * max(1, max
    |jax|) of each tensor in fp32, 1e-12 in fp64; with masks that hold a
    fully masked row (a uniform softmax), with `residual` and `layer_norm`;
  * training: the graph modules with dropout 0.2 (on the GATs' weights and
    between layers), the JAX side given the port's Philox masks in the
    same call order (its `layers.dropout` replaced for the test only);
  * initialisation: each parameter's law against the JAX init's (zeros and
    ones exactly; otherwise the largest |w| and the spread within 10 % and
    15 %, the gains of xavier, tanh, ReLU, sigmoid and torch-default);
  * `load_jax_params` is strict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu import layers as JL
from digat_tpu import layers_ext as JX
from digat_tpu_torch import layers_ext as X
from digat_tpu_torch.ops.dropout import keep_mask_plain

B, N, D, Q = 3, 7, 16, 4
SEED, RATE = 23, 0.2
TOL = {"float32": 1e-5, "float64": 1e-12}


def _rng(seed):
    return np.random.default_rng(seed)


def _graph(seed, b=B, n=N):
    g = (_rng(seed).random((b, n, n)) < 0.4) | np.eye(n, dtype=bool)[None]
    g[0, 2] = False  # a node with no edge at all: its softmax row is uniform
    return g


def _mask(seed, *shape):
    m = _rng(seed).random(shape) < 0.7
    m[(0,) * (len(shape) - 1)] = False  # a fully masked row
    return m


def _gen():
    return torch.Generator().manual_seed(0)


def _case(name):
    """(jax params, jax apply(params, *floats), port module, float inputs,
    mask inputs, port kwargs, jax kwargs) for `name`."""
    k = jax.random.PRNGKey(5)
    r = _rng(11)
    f = lambda *s: r.normal(size=s).astype(np.float32)
    if name in ("candidate", "multi_candidate"):
        p = JX.candidate_attention_init(k, D, 12, 8)
        m = (X.MultiCandidateAttention if name == "multi_candidate" else X.CandidateAttention)(
            D, 12, 8, _gen())
        q = f(B, Q, 12) if name == "multi_candidate" else f(B, 12)
        fn = JX.multi_candidate_attention if name == "multi_candidate" else JX.candidate_attention
        return p, fn, m, [f(B, N, D), q], [_mask(1, B, N)], {}, {}
    if name == "multi_sdp":
        p = JX.multi_sdp_attention_init(k, D, 12, 8)
        return (p, JX.multi_sdp_attention, X.MultiSDPAttention(D, 12, 8, _gen()),
                [f(B, N, D), f(B, Q, 12)], [_mask(2, B, Q, N)], {}, {})
    if name == "dual_sdp":
        p = JX.dual_sdp_attention_init(k, D, 12, 8)
        return (p, JX.dual_sdp_attention, X.DualSDPAttention(D, 12, 8, _gen()),
                [f(B, N, D), f(B, Q, 12)], [_mask(3, B, N, Q)], {}, {})
    if name == "dual_free":
        return ({}, lambda _, a, b, m: JX.dual_sdp_attention_free(a, b, m), None,
                [f(B, N, D), f(B, Q, D)], [_mask(4, B, N, Q)], {}, {})
    feature, graph = f(B, N, D), _graph(6)
    train = name.endswith("train")
    base = name.replace("_train", "")
    pk = dict(seed=SEED, site=0, dropout=RATE) if train else {}
    jk = dict(rng=jax.random.PRNGKey(1), dropout=RATE, train=True) if train else {}
    if base == "gcn":
        p = JX.gcn_init(k, D, 8, hidden_dim=12, num_layers=3)
        m = X.GCN(D, 8, _gen(), hidden_dim=12, num_layers=3)
    elif base == "gcn_ln_residual":
        p = JX.gcn_init(k, D, D, hidden_dim=D, num_layers=3, layer_norm=True)
        m = X.GCN(D, D, _gen(), hidden_dim=D, num_layers=3, layer_norm=True)
        pk, jk = {**pk, "residual": True}, {**jk, "residual": True}
    elif base == "gated_rgcn":
        p, m = JX.gated_rgcn_init(k, D, num_layers=2), X.GatedRGCN(D, _gen(), num_layers=2)
    elif base == "gat":
        p, m = JX.gat_init(k, D, num_layers=2), X.GAT(D, _gen(), num_layers=2)
        pk, jk = {**pk, "residual": True}, {**jk, "residual": True}
    else:  # multihead_gat
        p = JX.multihead_gat_init(k, D, head_num=3, num_layers=2)
        m = X.MultiheadGAT(D, 3, _gen(), num_layers=2)
        pk, jk = {**pk, "residual": True}, {**jk, "residual": True}
    fn = {"gcn": JX.gcn, "gcn_ln_residual": JX.gcn, "gated_rgcn": JX.gated_rgcn,
          "gat": JX.gat, "multihead_gat": lambda pp, x, g, **kw: JX.multihead_gat(
              pp, x, g, 3, **kw)}[base]
    return p, fn, m, [feature], [graph], pk, jk


CASES = ["candidate", "multi_candidate", "multi_sdp", "dual_sdp", "dual_free", "gcn",
         "gcn_ln_residual", "gated_rgcn", "gat", "multihead_gat", "gcn_ln_residual_train",
         "gated_rgcn_train", "gat_train", "multihead_gat_train"]


def _shared_dropout():
    """A stand-in for `digat_tpu.layers.dropout` that applies the port's
    masks: call k takes the Philox mask of (SEED, site k), as the port's
    k-th dropout call does."""
    calls = []

    def drop(key, x, rate, train):
        if not train or rate <= 0.0:
            return x
        cols = x.shape[-1]
        keep = keep_mask_plain(int(np.prod(x.shape[:-1])), cols, rate, SEED,
                               len(calls)).reshape(x.shape).numpy()
        calls.append(x.shape)
        return jnp.where(keep, x * (1.0 / (1.0 - rate)), 0.0).astype(x.dtype)

    return drop, calls


def _close(got, want, tol, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * scale, f"{what}: max |port - jax| {err:.3e} > {tol * scale:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", CASES)
def test_module_matches_jax_forward_and_gradients(name, dtype, monkeypatch):
    params, fn, module, floats, masks, pkw, jkw = _case(name)
    drop, jax_calls = _shared_dropout()
    monkeypatch.setattr(JL, "dropout", drop)
    np_dtype = np.dtype(dtype)
    floats = [a.astype(np_dtype) for a in floats]
    params = jax.tree.map(lambda a: np.asarray(a, np_dtype), params)
    with jax.enable_x64(dtype == "float64"):
        out, vjp = jax.vjp(lambda pp, *xs: fn(pp, *xs, *masks, **jkw), params,
                           *map(jnp.asarray, floats))
        outs = out if isinstance(out, tuple) else (out,)
        cots = tuple(_rng(40 + i).normal(size=o.shape).astype(np_dtype)
                     for i, o in enumerate(outs))
        want_grads = vjp(cots if isinstance(out, tuple) else cots[0])
    tdtype = getattr(torch, dtype)
    xs = [torch.tensor(a, requires_grad=True) for a in floats]
    ms = [torch.from_numpy(m) for m in masks]
    if module is None:
        got = X.dual_sdp_attention_free(*xs, *ms)
    else:
        module = X.load_jax_params(module.to(tdtype), params)
        got = module(*xs, *ms, **pkw)
    got = got if isinstance(got, tuple) else (got,)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cots])
    tol = TOL[dtype]
    for i, (g, w) in enumerate(zip(got, outs)):
        assert g.dtype == tdtype and g.shape == w.shape
        _close(g.detach().numpy(), w, tol, f"output {i}")
    for i, (x, w) in enumerate(zip(xs, want_grads[1:])):
        _close(x.grad.numpy(), w, tol, f"input {i} gradient")
    if module is not None:
        want_w = X.state_dict_from_jax(want_grads[0])
        named = dict(module.named_parameters())
        assert set(named) == set(want_w)
        for n, prm in named.items():
            _close(prm.grad.numpy(), want_w[n], tol, f"{n} gradient")
    if name.endswith("train"):
        drops = {"gcn_ln_residual_train": 2, "gated_rgcn_train": 1, "gat_train": 3,
                 "multihead_gat_train": 3}[name]
        assert len(jax_calls) == drops  # the weights of each GAT layer, and between layers


def test_eval_has_no_dropout_and_training_draws_by_site():
    """Without a seed the rate does nothing; with one, the calls draw under
    consecutive sites from `site`, so two runs of one seed agree and
    another first site differs."""
    m = X.GAT(D, _gen(), num_layers=2).double()
    x = torch.from_numpy(_rng(3).normal(size=(B, N, D)))
    g = torch.from_numpy(_graph(4))
    assert torch.equal(m(x, g, dropout=0.5), m(x, g))
    a = m(x, g, seed=9, site=0, dropout=0.5)
    assert torch.equal(a, m(x, g, seed=9, site=0, dropout=0.5))
    assert not torch.equal(a, m(x, g, seed=9, site=5, dropout=0.5))
    assert not torch.equal(a, m(x, g))


INITS = [
    ("candidate", lambda k: JX.candidate_attention_init(k, 96, 80, 64),
     lambda: X.CandidateAttention(96, 80, 64, _gen())),
    ("multi_sdp", lambda k: JX.multi_sdp_attention_init(k, 96, 80, 64),
     lambda: X.MultiSDPAttention(96, 80, 64, _gen())),
    ("dual_sdp", lambda k: JX.dual_sdp_attention_init(k, 96, 80, 64),
     lambda: X.DualSDPAttention(96, 80, 64, _gen())),
    ("gcn", lambda k: JX.gcn_init(k, 96, 64, hidden_dim=80, num_layers=3, layer_norm=True),
     lambda: X.GCN(96, 64, _gen(), hidden_dim=80, num_layers=3, layer_norm=True)),
    ("gated_rgcn", lambda k: JX.gated_rgcn_init(k, 96, num_layers=2),
     lambda: X.GatedRGCN(96, _gen(), num_layers=2)),
    ("gat", lambda k: JX.gat_init(k, 96, num_layers=2), lambda: X.GAT(96, _gen(), num_layers=2)),
    ("multihead_gat", lambda k: JX.multihead_gat_init(k, 96, head_num=4, num_layers=2),
     lambda: X.MultiheadGAT(96, 4, _gen(), num_layers=2)),
]


@pytest.mark.parametrize("name,jax_init,port_init", INITS, ids=[c[0] for c in INITS])
def test_initialisation_follows_the_jax_laws(name, jax_init, port_init):
    want = X.state_dict_from_jax(jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3))))
    got = {k: v.detach().numpy() for k, v in port_init().state_dict().items()}
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if not w.any() or (w == 1).all():  # zero biases, LayerNorm scale and shift
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        assert abs(np.abs(g).max() / np.abs(w).max() - 1) < 0.1, k
        assert abs(g.std() / w.std() - 1) < 0.15, k


@pytest.mark.parametrize("change", ["missing", "stray", "shape"])
def test_load_jax_params_is_strict(change):
    params = jax.tree.map(np.array, JX.gat_init(jax.random.PRNGKey(0), D, num_layers=2))
    if change == "missing":
        del params["layers"][1]["K"]["b"]
    elif change == "stray":
        params["layers"][0]["extra"] = np.zeros(2, np.float32)
    else:
        params["layers"][0]["Q"]["w"] = np.zeros((D, D + 1), np.float32)
    with pytest.raises(RuntimeError):
        X.load_jax_params(X.GAT(D, _gen(), num_layers=2), params)
