"""Two-stage cached evaluation, on one device or sharded across ranks.

Counterpart of `digat_tpu.eval.scorer` (`CachedScorer.cache_news`,
`score_items`, `NRMSCachedScorer`, `compute_scores`, and across devices its
`_shard_chunk_fn`, `_shard_score_fn` and multi-process `compute_scores`).
For MSA-DIGAT:

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

At `compute_dtype` bfloat16 its stages run on one compute copy too.

Across W > 1 ranks (`dist`, a `parallel.dist.DistContext`), both scorers
shard as the JAX package does: the chunk is rounded up to a multiple of W
and each rank runs its W-th of every stage-1 chunk (the rows past the last
news repeat it and are dropped), then an all_gather puts the caches back
together on every rank; stage 2 takes the items strided across the ranks,
each rank's scores in its own slots and zeros elsewhere, and an all_reduce
sums them into the whole vector on every rank.

A model whose word table is row-sharded over a model group (`--mesh_model`
M > 1) takes the whole table for stage 1, gathered once a pass over the
model group (`parallel.sharded_table.whole_table`), as the JAX scorer
replicates the parameters; the ranks of every group then score their
shares as above.
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
from digat_tpu_torch.parallel.dist import DistContext
from digat_tpu_torch.parallel.sharded_table import whole_table


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _chunked(dist: DistContext, n: int, bs: int, device, fn) -> torch.Tensor:
    """fn(sel) -> [rows of sel, ...] over every chunk of `bs` of n rows,
    concatenated in order. One rank takes the chunks themselves (`sel` a
    slice); W ranks each take their bs / W rows of every chunk (`sel` an
    index tensor; bs a multiple of W, rows past n repeat row n - 1) and
    gather the others'."""
    starts = range(0, n, bs)
    if dist.world == 1:
        return torch.cat([fn(slice(s, s + bs)) for s in starts])
    per = bs // dist.world
    own = torch.arange(per, device=device) + dist.rank * per
    local = torch.cat([fn((own + s).clamp(max=n - 1)) for s in starts])
    full = dist.all_gather_rows(local)  # [W * chunks * per, ...], rank-major
    full = full.reshape((dist.world, len(starts), per) + tuple(full.shape[1:]))
    return full.transpose(0, 1).reshape((len(starts) * bs,) + tuple(full.shape[3:]))[:n]


def _stage2(dist: DistContext, n_items: int, device, pending) -> np.ndarray:
    """The (scores, valid) of each stage-2 batch of this rank's items
    (strided across ranks) -> every item's score (host float32)."""
    scores = torch.zeros(n_items, dtype=torch.float32, device=device)
    if pending:
        own = torch.arange(dist.rank, n_items, dist.world, device=device)
        scores[own] = torch.cat([s[:v] for s, v in pending]).float()
    dist.all_reduce_sum_([scores])
    return scores.cpu().numpy()


class CachedScorer:
    """Two-stage scorer for one model, sharded across the ranks of `dist`.
    After `score_items`, `timings` holds the wall seconds of each stage
    (each ends in a device synchronise) and this rank's item and batch
    counts."""

    def __init__(self, model: Model, batch_size: int = 1024,
                 dist: DistContext = DistContext()):
        self.model = model
        self.dist = dist
        self.batch_size = _round_up(batch_size, dist.world)
        self.device = model.device
        self.timings: dict = {}

    @torch.inference_mode()
    def cache_news(self, tables, params: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 1 -> (news_reps [N, D], c_n0 [N, D]) on the model's device,
        on the compute copy `params` (a fresh one if None). The last chunk
        may be short; no padding is needed."""
        t = CorpusTables.from_arrays(tables, self.device)
        n, bs, m = t.news_title_text.shape[0], self.batch_size, self.model

        def stage1():
            reps = _chunked(self.dist, n, bs, self.device, lambda sel: m.encode_news(
                t.news_title_text[sel], t.news_title_mask[sel]))
            c_n0 = _chunked(self.dist, n, bs, self.device, lambda sel: m.initial_news_context(
                reps[t.news_node_id[sel]], t.news_graph_mask[sel]))
            return reps, c_n0

        with whole_table(self.model):
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
        [items] float32 (host), the same on every rank."""
        t = CorpusTables.from_arrays(tables, self.device)
        t0 = time.perf_counter()
        params = self.model.compute_params()
        news_reps, c_n0 = self.cache_news(t, params)
        _sync(self.device)
        t1 = time.perf_counter()
        pending = self.model.computing(lambda: [
            (self._score_batch(t, news_reps, c_n0, batch), valid)
            for batch, valid in eval_batches(history_idx, cat_idx, imp_index, cand,
                                             self.batch_size, self.device,
                                             shard_index=self.dist.rank,
                                             shard_count=self.dist.world)
        ], params=params)
        scores = _stage2(self.dist, len(cand), self.device, pending)
        t2 = time.perf_counter()
        self.timings = {"stage1_s": t1 - t0, "stage2_s": t2 - t1,
                        "items": len(range(self.dist.rank, len(cand), self.dist.world)),
                        "stage2_batches": len(pending)}
        return scores


class NRMSCachedScorer:
    """Dual-cache scorer for the NRMS family, sharded across the ranks of
    `dist`: plain reps feed the user tower, fused reps (NRMS-SA; the plain
    ones for NRMS) score candidates. After `score_items`, `timings` holds
    what `CachedScorer`'s does."""

    def __init__(self, model: NRMSModel, batch_size: int = 1024,
                 dist: DistContext = DistContext()):
        self.model = model
        self.dist = dist
        self.batch_size = _round_up(batch_size, dist.world)
        self.device = model.device
        self.timings: dict = {}

    @torch.inference_mode()
    def cache_news(self, tables, params: Optional[dict] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 1 -> (plain [N, D], fused [N, D]) on the model's device, on
        the compute copy `params` (a fresh one if None)."""
        t = NRMSTables.from_arrays(tables, self.device)
        n, bs, m = t.news_title_text.shape[0], self.batch_size, self.model

        def stage1():
            plain = _chunked(self.dist, n, bs, self.device, lambda sel: m.encode_titles(
                t.news_title_text[sel], t.news_title_mask[sel]))
            if not m.sa:
                return plain, plain
            fused = _chunked(self.dist, n, bs, self.device, lambda sel: m.fuse_sa(
                plain[sel], plain[t.augmented_news[sel]]))
            return plain, fused

        with whole_table(self.model):
            return self.model.computing(stage1, params=params)

    @torch.inference_mode()
    def score_items(self, tables, history_idx: np.ndarray, cat_idx: np.ndarray,
                    imp_index: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Stage 1, then stage 2 over every impression item -> scores
        [items] float32 (host), the same on every rank. `cat_idx` is unused
        by this family."""
        t0 = time.perf_counter()
        params = self.model.compute_params()
        plain, fused = self.cache_news(tables, params)
        _sync(self.device)
        t1 = time.perf_counter()

        def stage2():
            pending = []
            for batch, valid in eval_batches(history_idx, cat_idx, imp_index, cand,
                                             self.batch_size, self.device,
                                             shard_index=self.dist.rank,
                                             shard_count=self.dist.world):
                user = self.model.encode_user(plain[batch.history_idx], batch.history_idx != 0)
                pending.append(((fused[batch.cand_idx] * user).sum(dim=-1), valid))
            return pending

        pending = self.model.computing(stage2, params=params)
        scores = _stage2(self.dist, len(cand), self.device, pending)
        t2 = time.perf_counter()
        self.timings = {"stage1_s": t1 - t0, "stage2_s": t2 - t1,
                        "items": len(range(self.dist.rank, len(cand), self.dist.world)),
                        "stage2_batches": len(pending)}
        return scores


def compute_scores(
    model,
    corpus,
    mode: str,
    batch_size: Optional[int] = None,
    result_file: Optional[str] = None,
    dist: DistContext = DistContext(),
) -> Tuple[float, float, float, float]:
    """End-to-end dev/test scoring -> (auc, mrr, ndcg5, ndcg10), by the
    model's family: `CachedScorer` for MSA-DIGAT, `NRMSCachedScorer` for
    NRMS and NRMS-SA, sharded across the ranks of `dist` (every rank gets
    the metrics; give `result_file` on one rank only).

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
        scorer, tables = NRMSCachedScorer(model, bs, dist), corpus.nrms_tables()
    else:
        scorer, tables = CachedScorer(model, bs, dist), corpus.tables()
    scores = scorer.score_items(tables, split.history_idx, split.cat_idx, imp_index, cand)
    if result_file:
        M.write_rank_file(result_file, M.group_by_impression(imp_index, scores))
    if getattr(corpus, f"{mode}_unlabeled", np.asarray(labels).sum() == 0):
        # unlabeled split: the rank file is the deliverable
        return (float("nan"),) * 4
    return M.score_impressions_flat(imp_index, labels, scores)
