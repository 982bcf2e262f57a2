"""CNN-DIGAT (and a CNN ablation) and MSA titles past 128 positions at
`compute_dtype` bfloat16 against `digat_tpu` on its kernel path (B, C and
F in Pallas interpret mode), on the CPU, at the small widths of
tests/test_torch_support.py (D 32).

Behind the CNN every activation is bf16 on both sides, and the port rounds
where XLA does (`layers.linear`'s two roundings, `sigmoid` op by op, the
bf16 scalars of `scale_down` and `leaky_relu`, the bias of the bank as its
own add): the eval logits come out the JAX kernel path's bit for bit on
these inputs, op by op. They are held within 1e-4 * max(1, |logit|), for
sums that another summation order may round the other way (one bf16 ulp of
a logit is 3.9e-3 of it). Past L 128 the MSA encoder runs the pair's bf16
instance on bf16 projections, its output cast to fp32, as F does; the same
limit. Under `jax.jit` XLA fuses bf16 elementwise chains and keeps their
intermediates in fp32 (excess precision), so a jitted JAX program rounds
at fewer places than its op-by-op run; the port follows the op-by-op
program, which names every rounding. JAX's jitted cached scorer lies up to
0.124 from it on logits of 64 (half a bf16 ulp), the port 0.

  * eval logits: CNN-DIGAT, CNN news_graph_wo_inter (group3 bank), MSA at
    L 130; the JAX XLA path of CNN-DIGAT lies further away (its B and C
    round k1, k2, k3 and the scores to bf16 inside the layer);
  * the cached scorer: CNN-DIGAT and MSA at L 130 against JAX's run op by
    op (`jax.disable_jit`), scores within that limit and the same rank order
    in every impression.

Training (one step, five Adam steps): tests/test_torch_bf16_cnn_train.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from digat_tpu.eval.scorer import CachedScorer as JaxCachedScorer
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.eval.scorer import CachedScorer
from tests.test_torch_support import (bf16_eval_logits, bf16_models, corpus_arrays,  # noqa
                                      impressions, jax_interpret, one_thread)

pytestmark = pytest.mark.usefixtures("one_thread")

CNN = dict(news_encoder="CNN", cnn_kernel_num=32)
LONG = dict(max_title_length=130)  # group_size 0: the attention pair (F)


def _limit(want):
    return 1e-4 * np.maximum(1.0, np.abs(want))


@pytest.mark.parametrize("over", [CNN, dict(CNN, graph_encoder="news_graph_wo_inter",
                                            cnn_method="group3", cnn_kernel_num=30), LONG],
                         ids=["CNN-DIGAT", "CNN-news_graph_wo_inter", "MSA-L130"])
def test_eval_logits_match_jax_kernel_path(over):
    got, want, xla = bf16_eval_logits(seed=0, xla=over is CNN, **over)
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want)
    assert (err <= _limit(want)).all(), err.max()
    if xla is not None:
        assert float(np.abs(xla - want).max()) > 10 * max(float(err.max()), 1e-7)


@pytest.mark.parametrize("over", [CNN, LONG], ids=["CNN-DIGAT", "MSA-L130"])
def test_cached_scorer_matches_jax_at_bf16(over):
    jm, params, pm = bf16_models(seed=2, **over)
    cfg = jm.config
    rng = np.random.default_rng(12)
    arrays = corpus_arrays(rng, 37, cfg)
    hist, cat, imp_index, cand, _ = impressions(rng, 37, cfg, 9, 3)
    jt = JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()})
    with jax_interpret(), jax.disable_jit():
        want = JaxCachedScorer(jm, 8, mesh=False).score_items(params, jt, hist, cat, imp_index,
                                                              cand)
    got = CachedScorer(pm, 8).score_items(SimpleNamespace(**arrays), hist, cat, imp_index, cand)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (np.abs(got - want) <= 1e-4 * max(1.0, float(np.abs(want).max()))).all()
    order = lambda s: [np.argsort(-g, kind="stable") for g in PM.group_by_impression(imp_index, s)]
    for g, w in zip(order(got), order(want)):
        np.testing.assert_array_equal(g, w)
