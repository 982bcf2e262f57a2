"""Two-stage cached evaluation on one device.

Counterpart of `digat_tpu.eval.scorer` (`CachedScorer.cache_news`,
`score_items`, `NRMSCachedScorer`, `compute_scores`). For MSA-DIGAT:

  stage 1: encode every unique news once (kernel A, one launch per chunk of
           `batch_size` titles) -> news_reps [news_num, D]; then the initial
           news context c_n0 [news_num, D] in chunks;
  stage 2: per batch of impression items, gather from the two
           [news_num, D] caches (never a [news_num, Gn, D] one), rebuild the
           user graph and run the graph encoder (kernel B, 2 * depth
           launches per batch); the score is a dot product.

At `compute_dtype` bfloat16 both stages run on one compute copy of the
weights (`Model.compute_params`), made once a pass, as the JAX scorer casts
its parameters once, and each stage swaps it in once for all its chunks or
batches (`Model.computing`).

For the NRMS family, the dual cache of the reference's Appendix-B eval:

  stage 1: encode every news title once (the attention kernel, one forward
           launch per chunk) -> plain reps; for NRMS-SA the fused reps are
           formed from the cached plain reps of each news's augmented
           neighbours, never by encoding their titles again;
  stage 2: per batch, the user tower on the plain reps of the history (one
           forward launch), scored against the fused rep of the candidate.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from digat_tpu_torch.data.batching import eval_batches
from digat_tpu_torch.data.user_graph import build_user_graph
from digat_tpu_torch.eval import metrics as M
from digat_tpu_torch.models.model import CorpusTables, EvalBatch, Model
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CachedScorer:
    """Two-stage scorer for one model. After `score_items`, `timings` holds
    the wall seconds of each stage (each ends in a device synchronise) and
    the item and batch counts."""

    def __init__(self, model: Model, batch_size: int = 1024):
        self.model = model
        self.batch_size = batch_size
        self.device = model.device
        self.timings: dict = {}

    @torch.inference_mode()
    def cache_news(self, tables, params: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 1 -> (news_reps [N, D], c_n0 [N, D]) on the model's device,
        on the compute copy `params` (a fresh one if None). The last chunk
        may be short; no padding is needed."""
        t = CorpusTables.from_arrays(tables, self.device)
        n, bs = t.news_title_text.shape[0], self.batch_size

        def stage1():
            reps = torch.cat([
                self.model.encode_news(t.news_title_text[s:s + bs], t.news_title_mask[s:s + bs])
                for s in range(0, n, bs)
            ])
            c_n0 = torch.cat([
                self.model.initial_news_context(reps[t.news_node_id[s:s + bs]],
                                                t.news_graph_mask[s:s + bs])
                for s in range(0, n, bs)
            ])
            return reps, c_n0

        return self.model.computing(stage1, params=params)

    @torch.inference_mode()
    def _score_batch(self, tables: CorpusTables, news_reps, c_n0, batch: EvalBatch):
        cfg = self.model.config
        user_reps = news_reps[batch.history_idx]  # [b, H, D]
        sag = news_reps[tables.news_node_id[batch.cand_idx]]  # [b, Gn, D]
        graph = tables.news_graph[batch.cand_idx]
        gmask = tables.news_graph_mask[batch.cand_idx]
        user_graph, cat_mask = build_user_graph(batch.cat_idx, cfg.max_history_num,
                                                cfg.category_num)
        return self.model.inference(user_reps, user_graph, cat_mask, batch.cat_idx, sag, graph,
                                    gmask, c_n0[batch.cand_idx])

    @torch.inference_mode()
    def score_items(self, tables, history_idx: np.ndarray, cat_idx: np.ndarray,
                    imp_index: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Stage 1, then stage 2 over every impression item -> scores
        [items] float32 (host)."""
        t = CorpusTables.from_arrays(tables, self.device)
        t0 = time.perf_counter()
        params = self.model.compute_params()
        news_reps, c_n0 = self.cache_news(t, params)
        _sync(self.device)
        t1 = time.perf_counter()
        pending = self.model.computing(lambda: [
            (self._score_batch(t, news_reps, c_n0, batch), valid)
            for batch, valid in eval_batches(history_idx, cat_idx, imp_index, cand,
                                             self.batch_size, self.device)
        ], params=params)
        scores = np.zeros(len(cand), np.float32)
        if pending:
            scores[:] = torch.cat([s[:v] for s, v in pending]).float().cpu().numpy()
        t2 = time.perf_counter()
        self.timings = {"stage1_s": t1 - t0, "stage2_s": t2 - t1, "items": len(cand),
                        "stage2_batches": len(pending)}
        return scores


class NRMSCachedScorer:
    """Dual-cache scorer for the NRMS family: plain reps feed the user
    tower, fused reps (NRMS-SA; the plain ones for NRMS) score candidates.
    After `score_items`, `timings` holds what `CachedScorer`'s does."""

    def __init__(self, model: NRMSModel, batch_size: int = 1024):
        self.model = model
        self.batch_size = batch_size
        self.device = model.device
        self.timings: dict = {}

    @torch.inference_mode()
    def cache_news(self, tables) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 1 -> (plain [N, D], fused [N, D]) on the model's device."""
        t = NRMSTables.from_arrays(tables, self.device)
        n, bs = t.news_title_text.shape[0], self.batch_size
        plain = torch.cat([
            self.model.encode_titles(t.news_title_text[s:s + bs], t.news_title_mask[s:s + bs])
            for s in range(0, n, bs)
        ])
        if not self.model.sa:
            return plain, plain
        fused = torch.cat([
            self.model.fuse_sa(plain[s:s + bs], plain[t.augmented_news[s:s + bs]])
            for s in range(0, n, bs)
        ])
        return plain, fused

    @torch.inference_mode()
    def score_items(self, tables, history_idx: np.ndarray, cat_idx: np.ndarray,
                    imp_index: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Stage 1, then stage 2 over every impression item -> scores
        [items] float32 (host). `cat_idx` is unused by this family."""
        t0 = time.perf_counter()
        plain, fused = self.cache_news(tables)
        _sync(self.device)
        t1 = time.perf_counter()
        pending = []
        for batch, valid in eval_batches(history_idx, cat_idx, imp_index, cand,
                                         self.batch_size, self.device):
            user = self.model.encode_user(plain[batch.history_idx], batch.history_idx != 0)
            pending.append(((fused[batch.cand_idx] * user).sum(dim=-1), valid))
        scores = np.zeros(len(cand), np.float32)
        if pending:
            scores[:] = torch.cat([s[:v] for s, v in pending]).float().cpu().numpy()
        t2 = time.perf_counter()
        self.timings = {"stage1_s": t1 - t0, "stage2_s": t2 - t1, "items": len(cand),
                        "stage2_batches": len(pending)}
        return scores


def compute_scores(
    model,
    corpus,
    mode: str,
    batch_size: Optional[int] = None,
    result_file: Optional[str] = None,
) -> Tuple[float, float, float, float]:
    """End-to-end dev/test scoring -> (auc, mrr, ndcg5, ndcg10), by the
    model's family: `CachedScorer` for MSA-DIGAT, `NRMSCachedScorer` for
    NRMS and NRMS-SA.

    `corpus` provides `tables()` (the five `CorpusTables` fields, numpy or
    tensors) or, for the NRMS family, `nrms_tables()` (the three
    `NRMSTables` fields), `splits[mode].history_idx` / `.cat_idx`, and
    `{mode}_imp_index`, `{mode}_cand`, `{mode}_labels`, as
    `digat_tpu.data.corpus.Corpus` does."""
    if mode not in ("dev", "test"):
        raise ValueError(f"mode must be 'dev' or 'test', got {mode!r}")
    bs = batch_size or model.config.effective_eval_batch_size()
    split = corpus.splits[mode]
    imp_index = getattr(corpus, f"{mode}_imp_index")
    cand = getattr(corpus, f"{mode}_cand")
    labels = getattr(corpus, f"{mode}_labels")
    if getattr(model, "family", "digat") == "nrms":
        scorer, tables = NRMSCachedScorer(model, bs), corpus.nrms_tables()
    else:
        scorer, tables = CachedScorer(model, bs), corpus.tables()
    scores = scorer.score_items(tables, split.history_idx, split.cat_idx, imp_index, cand)
    if result_file:
        M.write_rank_file(result_file, M.group_by_impression(imp_index, scores))
    if getattr(corpus, f"{mode}_unlabeled", np.asarray(labels).sum() == 0):
        # unlabeled split: the rank file is the deliverable
        return (float("nan"),) * 4
    return M.score_impressions_flat(imp_index, labels, scores)
