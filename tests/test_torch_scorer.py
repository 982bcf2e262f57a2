"""The port's two-stage scorer, batching and metrics against `digat_tpu`
on the same parameters (CPU).

Tolerances: scores rtol/atol 1e-4 (depth compounds fp32 summation-order
differences); identical per-impression rank order and rank files; metrics
to 1e-6. The stage-1 news count (37) is not a multiple of the chunk (8),
and the last stage-2 batch is padded with item 0."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digat_tpu.data.batching import eval_batches as jax_eval_batches
from digat_tpu.eval import metrics as JM
from digat_tpu.eval.scorer import CachedScorer as JaxCachedScorer
from digat_tpu.eval.scorer import compute_scores as jax_compute_scores
from digat_tpu.models.model import CorpusTables as JaxTables
from digat_tpu_torch.data.batching import eval_batches
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.eval.scorer import CachedScorer, compute_scores
from digat_tpu_torch.models.model import CorpusTables
from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused
from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled
from tests.test_torch_support import SLICE_TOL, corpus_arrays, impressions, models

NEWS, BS, N_IMP, PER_IMP = 37, 8, 9, 3  # 27 items: last batch holds 3


@pytest.fixture(scope="module")
def slice_setup():
    jm, params, pm = models(seed=1)
    cfg = jm.config
    rng = np.random.default_rng(11)
    arrays = corpus_arrays(rng, NEWS, cfg)
    hist, cat, imp_index, cand, labels = impressions(rng, NEWS, cfg, N_IMP, PER_IMP)
    return jm, params, pm, arrays, (hist, cat, imp_index, cand, labels)


def test_eval_batches_match_jax():
    rng = np.random.default_rng(3)
    hist = rng.integers(0, 50, (6, 5))
    cat = rng.integers(0, 4, (6, 5))
    imp_index = np.sort(rng.integers(0, 6, 19))
    cand = rng.integers(0, 50, 19)
    want = list(jax_eval_batches(hist, cat, imp_index, cand, 8))
    got = list(eval_batches(hist, cat, imp_index, cand, 8, "cpu"))
    assert [v for _, v in got] == [v for _, v in want] == [8, 8, 3]
    for (gb, _), (wb, _) in zip(got, want):
        for name in ("history_idx", "cat_idx", "cand_idx"):
            t = getattr(gb, name)
            assert t.dtype == torch.int64
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(wb, name)))


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    imp_index = np.repeat(np.arange(40), rng.integers(2, 9, 40))
    labels = (rng.random(len(imp_index)) < 0.3).astype(np.float32)
    scores = rng.normal(size=len(imp_index)).astype(np.float32)
    np.testing.assert_allclose(PM.score_impressions_flat(imp_index, labels, scores),
                               JM.score_impressions_flat(imp_index, labels, scores),
                               rtol=0, atol=1e-12, equal_nan=True)
    groups = PM.group_by_impression(imp_index, scores)
    for g, w in zip(groups, JM.group_by_impression(imp_index, scores)):
        np.testing.assert_array_equal(g, w)
    PM.write_rank_file(tmp_path / "port.txt", groups)
    JM.write_rank_file(tmp_path / "jax.txt", groups)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_cache_news_tail_chunk(slice_setup):
    jm, params, pm, arrays, _ = slice_setup
    want_reps, want_c0 = JaxCachedScorer(jm, BS, mesh=False).cache_news(
        params, JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    before = msa_encoder_pooled.launches
    reps, c0 = CachedScorer(pm, BS).cache_news(SimpleNamespace(**arrays))
    assert msa_encoder_pooled.launches == before  # CPU: plain path, no launch
    assert reps.shape == (NEWS, pm.config.news_embedding_dim)
    np.testing.assert_allclose(reps.numpy(), np.asarray(want_reps), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c0.numpy(), np.asarray(want_c0), rtol=1e-5, atol=1e-5)


def _rank_order(imp_index, scores):
    return [np.argsort(-s, kind="stable") for s in PM.group_by_impression(imp_index, scores)]


def test_score_items_match_jax(slice_setup):
    jm, params, pm, arrays, (hist, cat, imp_index, cand, _) = slice_setup
    jt = JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()})
    want = JaxCachedScorer(jm, BS, mesh=False).score_items(params, jt, hist, cat, imp_index, cand)
    scorer = CachedScorer(pm, BS)
    before = interactive_gat_layer_fused.launches
    got = scorer.score_items(jt, hist, cat, imp_index, cand)
    assert interactive_gat_layer_fused.launches == before
    assert scorer.timings["stage2_batches"] == 4 and scorer.timings["items"] == 27
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **SLICE_TOL)
    for g, w in zip(_rank_order(imp_index, got), _rank_order(imp_index, want)):
        np.testing.assert_array_equal(g, w)


def test_compute_scores_match_jax(slice_setup, tmp_path):
    jm, params, pm, arrays, (hist, cat, imp_index, cand, labels) = slice_setup
    split = SimpleNamespace(history_idx=hist, cat_idx=cat)
    corpus = SimpleNamespace(
        splits={"dev": split}, dev_imp_index=imp_index, dev_cand=cand, dev_labels=labels,
        tables=lambda: JaxTables(**{k: jnp.asarray(v) for k, v in arrays.items()}),
    )
    want = jax_compute_scores(jm, params, corpus, "dev", batch_size=BS,
                              result_file=str(tmp_path / "jax.txt"))
    port_corpus = SimpleNamespace(**{**vars(corpus), "tables": lambda: SimpleNamespace(**arrays)})
    got = compute_scores(pm, port_corpus, "dev", batch_size=BS,
                         result_file=str(tmp_path / "port.txt"))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    with pytest.raises(ValueError):
        compute_scores(pm, port_corpus, "train")


def test_tables_from_arrays_dtypes(slice_setup):
    *_, arrays, _ = slice_setup
    t = CorpusTables.from_arrays(SimpleNamespace(**arrays), "cpu")
    assert t.news_title_text.dtype == torch.int64 and t.news_graph.dtype == torch.bool
    again = CorpusTables.from_arrays(t, "cpu")
    assert again.news_graph.data_ptr() == t.news_graph.data_ptr()  # no copy of tensors
