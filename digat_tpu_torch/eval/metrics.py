"""MIND ranking metrics in NumPy: the port's own copy.

The same math as `digat_tpu/eval/metrics.py` (`score_impressions_flat`,
`group_by_impression`, `write_rank_file`, `avg_metric`): mean AUC (midrank ties), MRR,
nDCG@5 and nDCG@10 over impressions, and the leaderboard rank-file format.
Copied so the port never imports the JAX package."""

from __future__ import annotations

import json
from typing import List, Sequence, Tuple

import numpy as np


def group_by_impression(
    imp_index: np.ndarray, values: np.ndarray
) -> List[np.ndarray]:
    """Split item-level values into per-impression arrays (file order).
    Vectorized sort + split: MIND-large dev is ~25M items, a Python
    append loop here is a multi-minute host stall."""
    imp_index = np.asarray(imp_index)
    if len(imp_index) == 0:
        return []
    n_imp = int(imp_index.max()) + 1
    order = np.argsort(imp_index, kind="stable")  # keeps file order per imp
    counts = np.bincount(imp_index, minlength=n_imp)
    return np.split(np.asarray(values)[order], np.cumsum(counts)[:-1])


def _flat_chunk_sums(
    imp_index: np.ndarray, labels: np.ndarray, scores: np.ndarray
) -> np.ndarray:
    """Metric SUMS over the impressions of one contiguous chunk:
    [sum_auc, sum_mrr, sum_ndcg5, sum_ndcg10, kept_impressions].
    `imp_index` must be re-based to start near 0. NaN (single-class AUC)
    propagates through the sums, matching the list path's mean."""
    n = len(imp_index)
    binary = bool(np.all((labels == 0.0) | (labels == 1.0)))
    n_imp = int(imp_index.max()) + 1
    counts = np.bincount(imp_index, minlength=n_imp).astype(np.int64)
    seg_start = np.cumsum(counts) - counts
    n_pos = np.bincount(imp_index, weights=labels, minlength=n_imp)
    n_neg = counts - n_pos

    asc = np.lexsort((scores, imp_index))
    imp_a, s_a, y_a = imp_index[asc], scores[asc], labels[asc]
    pos_a = np.arange(n) - seg_start[imp_a]  # 0-based ascending rank

    # ---- AUC: per-impression midranks ----
    new_group = np.r_[True, (imp_a[1:] != imp_a[:-1]) | (s_a[1:] != s_a[:-1])]
    gid = np.cumsum(new_group) - 1
    gcnt = np.bincount(gid)
    gstart = np.cumsum(gcnt) - gcnt  # chunk-global position of tie group
    mid_global = gstart + (gcnt - 1) / 2.0
    rank_in_imp = mid_global[gid] - seg_start[imp_a] + 1.0
    pos_rank_sum = np.bincount(
        imp_a, weights=rank_in_imp * (y_a > 0), minlength=n_imp
    )
    with np.errstate(invalid="ignore", divide="ignore"):
        auc = np.where(
            (n_pos == 0) | (n_neg == 0),  # single-class: NaN (auc_score rule)
            np.nan,
            (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg),
        )

        # ---- MRR / nDCG: descending rank = per-segment reversal of the
        # ascending one (tie order is arbitrary either way) ----
        pos_d = counts[imp_a] - 1 - pos_a
        mrr = (
            np.bincount(imp_a, weights=y_a / (pos_d + 1.0), minlength=n_imp)
            / n_pos
        )
        gains_d = (y_a if binary else 2.0**y_a - 1.0) / np.log2(pos_d + 2.0)
        dcg5 = np.bincount(imp_a, weights=gains_d * (pos_d < 5), minlength=n_imp)
        dcg10 = np.bincount(imp_a, weights=gains_d * (pos_d < 10), minlength=n_imp)
        if binary:
            # ideal ordering puts the n_pos unit gains first: closed form
            cum_disc = np.r_[0.0, np.cumsum(1.0 / np.log2(np.arange(10) + 2.0))]
            npos_i = n_pos.astype(np.int64)
            idcg5 = cum_disc[np.minimum(npos_i, 5)]
            idcg10 = cum_disc[np.minimum(npos_i, 10)]
        else:
            ideal = np.lexsort((-labels, imp_index))
            imp_i, y_i = imp_index[ideal], labels[ideal]
            pos_i = np.arange(n) - seg_start[imp_i]
            gains_i = (2.0**y_i - 1.0) / np.log2(pos_i + 2.0)
            idcg5 = np.bincount(
                imp_i, weights=gains_i * (pos_i < 5), minlength=n_imp
            )
            idcg10 = np.bincount(
                imp_i, weights=gains_i * (pos_i < 10), minlength=n_imp
            )
        ndcg5 = dcg5 / idcg5
        ndcg10 = dcg10 / idcg10

    keep = counts > 0
    return np.array([
        auc[keep].sum(), mrr[keep].sum(), ndcg5[keep].sum(),
        ndcg10[keep].sum(), float(keep.sum()),
    ])


def score_impressions_flat(
    imp_index: np.ndarray, labels: np.ndarray, scores: np.ndarray
) -> Tuple[float, float, float, float]:
    """Fully vectorized mean AUC/MRR/nDCG@5/nDCG@10 over impressions from
    flat item-level arrays — no per-impression Python loop (descending-sort
    tie order is arbitrary, which only matters for exactly tied scores).

    Work is split at impression boundaries into chunks processed by a
    thread pool (NumPy releases the GIL in sorts/gathers/bincounts), so
    the dominant lexsort runs at cache-friendly sizes on all cores:
    the ~55M-item MIND-large dev scores in ~15 s instead of minutes.

    Empty impressions are skipped; single-class impressions yield NaN AUC,
    propagating into the mean."""
    imp_index = np.asarray(imp_index, np.int64)
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    n = len(imp_index)
    if n == 0:
        return (float("nan"),) * 4
    if not bool(np.all(imp_index[1:] >= imp_index[:-1])):
        order = np.argsort(imp_index, kind="stable")
        imp_index, labels, scores = imp_index[order], labels[order], scores[order]

    target = 2_000_000  # items per chunk: small enough to sort in-cache
    n_chunks = max(1, min(64, (n + target - 1) // target))
    # chunk bounds aligned to impression boundaries
    edges = np.searchsorted(
        imp_index, np.linspace(imp_index[0], imp_index[-1] + 1, n_chunks + 1)
    )
    edges = np.unique(edges)

    def work(lo: int, hi: int) -> np.ndarray:
        if lo == hi:
            return np.zeros(5)
        base = imp_index[lo]
        return _flat_chunk_sums(
            imp_index[lo:hi] - base, labels[lo:hi], scores[lo:hi]
        )

    if len(edges) <= 2:
        sums = work(0, n)
    else:
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        workers = min(_os.cpu_count() or 4, len(edges) - 1)
        with ThreadPoolExecutor(workers) as ex:
            parts = list(
                ex.map(lambda b: work(b[0], b[1]), zip(edges[:-1], edges[1:]))
            )
        sums = np.sum(parts, axis=0)
    kept = sums[4]
    if kept == 0:
        return (float("nan"),) * 4
    return tuple(float(x) for x in sums[:4] / kept)


def write_rank_file(path: str, scores_by_impression: Sequence[np.ndarray]) -> None:
    """`<imp_id> [r1,r2,...]` where r_j is the rank of candidate j by
    descending score (util.py:70-80)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, s in enumerate(scores_by_impression):
            order = np.argsort(-np.asarray(s), kind="stable")
            ranks = np.empty(len(s), np.int64)
            ranks[order] = np.arange(1, len(s) + 1)
            f.write(("" if i == 0 else "\n") + f"{i + 1} " + json.dumps(ranks.tolist(), separators=(",", ":")))


def avg_metric(auc: float, mrr: float, ndcg5: float, ndcg10: float) -> float:
    """The composite dev criterion: (AUC + MRR + (nDCG@5 + nDCG@10) / 2) / 3."""
    return (auc + mrr + (ndcg5 + ndcg10) / 2.0) / 3.0
