"""NRMS-SA and NRMS at `compute_dtype` bfloat16 against `digat_tpu` on its
kernel path (E and F in Pallas interpret mode, as the TPU runs them), on
the CPU, at NRMS_GEO's widths (4 heads of 6, L 12, history 10, M 3).

The title tower runs in bf16 up to the attention pair on both sides: the
cast table's rows, bf16 projections (each `x @ w + b` rounded twice, as
XLA rounds it) and the pair's bf16 output, cast to fp32; the fusion and
the user tower are fp32 activations times bf16 weights. The two sides
round at the same places, so what remains is the fp32 summation order,
which moves a bf16 value by one ulp where it falls near a rounding
boundary; 1e-4 * max(1, |logit|) holds the logits (about 40 times what a
single flipped rounding of the attention output moves them, and below one
bf16 ulp of the logit, 3.9e-3, which a rounding the port missed would
cost). The XLA path (use_pallas off) rounds the scores and the
probabilities to bf16 as well and lies further away.

  * eval logits of both models, and of NRMS-SA against JAX's XLA path;
  * `NRMSCachedScorer` against JAX's: the scores within that limit and the
    same rank file;
  * one training step (dropout 0): the loss within 1e-4 relative, every
    gradient within 2e-2 of its tensor's largest |JAX| element; not
    tighter, because the JAX package sums the word table's gradient rows in
    bf16 (the transpose of a gather from the bf16 table), where the port
    sums them in fp32 and rounds once. A bias of a bf16 product is held
    within 1e-1: its gradient is the bf16 cotangent summed over the rows,
    which JAX's CPU backend sums in bf16 (the transpose of the broadcast
    add), the port in fp32 rounded once (measured 7.2e-2 of the scale at
    the title tower's W_V bias, 0 at every fp32-activation bias). The
    training cases have no title and
    no history whose keys are all masked: there E and F add -1e9 and pass a
    gradient to q and k, where the port's select passes none (ROADMAP.md
    section 3), which moves W_Q's and W_K's gradients by up to 74 % of
    their scale;
  * five Adam steps: each loss within 1e-3 relative of JAX's (Adam's first
    steps move a weight by about lr whatever its gradient, so a gradient
    element near 0 that the two sides round to opposite signs moves its
    weight 2 lr apart)."""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.eval import metrics as JM
from digat_tpu.eval.scorer import NRMSCachedScorer as JaxNRMSScorer
from digat_tpu.models.model import TrainBatch as JaxTrainBatch
from digat_tpu.models.nrms import NRMSTables as JaxNRMSTables
from digat_tpu.train import optimizer as jax_optimizer
from digat_tpu.train.train_step import make_train_step
from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching
from digat_tpu_torch.eval import metrics as M
from digat_tpu_torch.eval.scorer import NRMSCachedScorer
from digat_tpu_torch.interop import params_from_model
from digat_tpu_torch.models.nrms import NRMSTables
from digat_tpu_torch.train.optimizer import Adam
from digat_tpu_torch.train.train_step import train_step
from tests.test_torch_support import (NRMS_GEO, impressions, jax_interpret, nrms_arrays,
                                      nrms_models, one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NEWS = 40
MODELS = ["NRMS-SA", "NRMS"]


def _limit(ref):
    return 1e-4 * max(1.0, float(np.abs(ref).max()))


def _models(seed, model, **over):
    return nrms_models(seed=seed, use_pallas=True, nrms_model=model, compute_dtype="bfloat16",
                       **over)


@pytest.fixture(scope="module")
def arrays():
    return nrms_arrays(np.random.default_rng(0), NEWS, Config(**NRMS_GEO))


def _batch(seed, B=6, K=4):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, NEWS, (B, NRMS_GEO["max_history_num"]))
    hist[0] = 0  # a cold user
    hist[1, 4:] = 0
    return batching.TrainBatch(history_idx=hist.astype(np.int32),
                               cat_idx=np.zeros_like(hist, np.int32),
                               sample_idx=rng.integers(0, NEWS, (B, 1 + K)).astype(np.int32),
                               weight=np.ones(B, np.float32))


def _jax_tables(arrays):
    return JaxNRMSTables(*(jnp.asarray(arrays[f]) for f in JaxNRMSTables._fields))


def _port_tables(arrays):
    return NRMSTables.from_arrays(SimpleNamespace(**arrays), "cpu")


def _jax_logits(jm, params, arrays, b):
    return np.asarray(jm.forward_indexed(jm.cast_params(params), _jax_tables(arrays),
                                         JaxTrainBatch(*map(jnp.asarray, b)),
                                         jax.random.PRNGKey(0), False))


@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax_kernel_path(arrays, model):
    jm, params, pm = _models(1, model)
    b = _batch(2)
    with jax_interpret():
        want = _jax_logits(jm, params, arrays, b)
    with torch.inference_mode():
        got = pm.computing(pm.forward_indexed, _port_tables(arrays),
                           batching.to_device(b, "cpu")).numpy()
    assert got.dtype == np.float32 and np.abs(want).max() > 1e-3
    err = float(np.abs(got - want).max())
    assert err <= _limit(want), err
    if model == "NRMS-SA":
        jx, _, _ = nrms_models(seed=1, nrms_model=model, compute_dtype="bfloat16")
        xla = _jax_logits(jx, params, arrays, b)
        assert float(np.abs(xla - want).max()) > 10 * max(err, 1e-7)


@pytest.mark.parametrize("model", MODELS)
def test_cached_scorer_matches_jax_at_bf16(arrays, model, tmp_path):
    jm, params, pm = _models(3, model)
    hist, cat, imp, cand, _ = impressions(np.random.default_rng(4), NEWS, pm.config, 9, 5)
    hist[0] = 0
    with jax_interpret():
        want = JaxNRMSScorer(jm, batch_size=16).score_items(params, _jax_tables(arrays), hist,
                                                             cat, imp, cand)
    got = NRMSCachedScorer(pm, batch_size=16).score_items(SimpleNamespace(**arrays), hist, cat,
                                                          imp, cand)
    assert np.isfinite(got).all() and float(np.abs(got - want).max()) <= _limit(want)
    files = []
    for tag, s, write, group in (("port", got, M.write_rank_file, M.group_by_impression),
                                 ("jax", want, JM.write_rank_file, JM.group_by_impression)):
        write(str(tmp_path / tag), group(imp, s))
        files.append((tmp_path / tag).read_text())
    assert files[0] == files[1]


@pytest.fixture(scope="module")
def train_arrays(arrays):
    """`arrays` with every title's first position valid: no all-masked key
    row in the title tower."""
    mask = arrays["news_title_mask"].copy()
    mask[:, 0] = True
    return dict(arrays, news_title_mask=mask)


def _train_batch(seed):
    """A batch of 8 with at least one history item a row (no all-masked key
    row in the user tower)."""
    b = _batch(seed, B=8)
    b.history_idx[:, 0] = np.random.default_rng(seed).integers(1, NEWS, 8)
    return b


def test_one_training_step_matches_jax(train_arrays):
    arrays = train_arrays
    jm, params, pm = _models(4, "NRMS-SA", dropout_rate=0.0)
    b = _train_batch(7)
    with jax_interpret():
        cast = lambda p: jm.loss(p, _jax_tables(arrays), JaxTrainBatch(*map(jnp.asarray, b)),
                                 jax.random.PRNGKey(0))
        loss, grads = jax.value_and_grad(cast)(params)
    pm.zero_grad()
    got = pm.loss(_port_tables(arrays), batching.to_device(b, "cpu"), 1)
    got.backward()
    assert abs(float(got.detach()) - float(loss)) <= 1e-4 * abs(float(loss))
    gm = copy.deepcopy(pm)
    with torch.no_grad():
        for p, q in zip(gm.parameters(), pm.parameters()):
            p.copy_(q.grad)
    flat_j = jax.tree_util.tree_leaves_with_path(grads)
    flat_p = jax.tree.leaves(params_from_model(gm))
    assert len(flat_j) == len(flat_p)
    for (path, gj), gp in zip(flat_j, flat_p):
        gj, gp = np.asarray(gj, np.float32), np.asarray(gp, np.float32)
        scale = max(float(np.abs(gj).max()), 1e-12)
        bias = jax.tree_util.keystr(path).endswith("['b']")
        assert float(np.abs(gp - gj).max()) <= (1e-1 if bias else 2e-2) * scale, path


def test_five_adam_steps_match_jax(train_arrays):
    arrays = train_arrays
    jm, params, pm = _models(5, "NRMS-SA", dropout_rate=0.0)
    batches = [_train_batch(5 + k) for k in range(5)]
    tx = jax_optimizer.make_optimizer(0.0, 1.0, params)
    state = tx.init(params)
    opt = Adam(pm.named_parameters(), 0.0, 1.0)
    pt = _port_tables(arrays)
    jax_loss, port_loss = [], []
    with jax_interpret():
        step = make_train_step(jm, tx)
        p = params
        for b in batches:
            p, state, loss = step(p, state, _jax_tables(arrays),
                                  JaxTrainBatch(*map(jnp.asarray, b)), jax.random.PRNGKey(0),
                                  1e-3)
            jax_loss.append(float(loss))
            port_loss.append(float(train_step(pm, opt, pt, batching.to_device(b, "cpu"), 1,
                                              1e-3)))
    jax_loss, port_loss = np.array(jax_loss), np.array(port_loss)
    assert (np.abs(port_loss - jax_loss) <= 1e-3 * np.abs(jax_loss)).all(), (port_loss, jax_loss)
