"""MSA-DIGAT at `compute_dtype` bfloat16 against `digat_tpu` on its kernel
path (the Pallas kernels in interpret mode, as the TPU runs them; CPU):
eval logits of DIGAT and its five ablations, and the two-stage cached
scorer.

The activations stay fp32 on both sides and the weights are bf16 copies,
so a rounding that one side makes and the other does not shows at about
4e-3: the logits agree within 1e-4 * max(1, |logit|). The JAX package's
XLA path rounds q, k and v to bf16 where its kernel keeps them fp32, and
the port, which follows the kernel, lies further from it."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.eval.scorer import CachedScorer as JaxCachedScorer
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.eval.scorer import CachedScorer
from tests.test_torch_support import (bf16_eval_logits, bf16_models, corpus_arrays,
                                      impressions, jax_interpret, one_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


def _check(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= 1e-4 * np.maximum(1.0, np.abs(want))).all(), err.max()
    return float(err.max())


def test_eval_logits_match_jax_kernel_path():
    got, want, xla = bf16_eval_logits(seed=0, xla=True)
    err = _check(got, want)
    assert float(np.abs(got - xla).max()) > 10 * max(err, 1e-7)


@pytest.mark.parametrize("variant", ["wo_SA", "Seq_SA", "wo_interaction", "news_graph_wo_inter",
                                     "user_graph_wo_inter"])
def test_eval_logits_of_ablations_match_jax(variant):
    got, want, _ = bf16_eval_logits(seed=1, graph_encoder=variant)
    _check(got, want)


def test_cached_scorer_matches_jax_at_bf16():
    """Both stages on one compute copy: scores within 1e-4 of the score
    scale, the same rank order in every impression."""
    jm, params, pm = bf16_models(seed=2)
    cfg = jm.config
    rng = np.random.default_rng(12)
    arrays = corpus_arrays(rng, 37, cfg)
    hist, cat, imp_index, cand, _ = impressions(rng, 37, cfg, 9, 3)
    jt = JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with jax_interpret():
        want = JaxCachedScorer(jm, 8, mesh=False).score_items(params, jt, hist, cat, imp_index,
                                                              cand)
    got = CachedScorer(pm, 8).score_items(SimpleNamespace(**arrays), hist, cat, imp_index, cand)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * max(1.0, float(np.abs(want).max()))
    order = lambda s: [np.argsort(-g, kind="stable") for g in PM.group_by_impression(imp_index, s)]
    for g, w in zip(order(got), order(want)):
        np.testing.assert_array_equal(g, w)


def test_compute_copy_is_bf16_and_the_masters_stay_fp32():
    _, _, pm = bf16_models(seed=3)
    params = pm.compute_params()
    assert params["news_encoder.word_embedding.weight"].dtype == torch.float32
    assert {t.dtype for n, t in params.items() if n != "news_encoder.word_embedding.weight"} \
        == {torch.bfloat16}
    assert {p.dtype for p in pm.parameters()} == {torch.float32}
    # at float32 the model computes on its parameters themselves
    assert bf16_models(seed=3, compute_dtype="float32")[2].compute_params() is None
