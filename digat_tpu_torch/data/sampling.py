"""Per-epoch negative sampling, vectorised.

The port's own copy of `digat_tpu.data.sampling` (numpy only), with the
reference's semantics:

  * if a sample has <= K non-clicks, its negatives wrap deterministically
    (j % n over file order);
  * otherwise K distinct non-clicks are drawn uniformly without
    replacement.

One random key per flat negative, a lexicographic argsort by (row, key)
and a prefix-offset gather take the first K of each row's random
permutation."""

from __future__ import annotations

import numpy as np


def sample_negatives(
    neg_flat: np.ndarray,
    neg_offsets: np.ndarray,
    k: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Returns [num_samples, k] int32 negative news ids."""
    num = len(neg_offsets) - 1
    lengths = np.diff(neg_offsets)
    out = np.zeros((num, k), np.int32)

    # rows with enough negatives: random permutation via sort of random keys
    big = lengths > k
    if big.any():
        row_of = np.repeat(np.arange(num), lengths)
        keys = rng.random(len(neg_flat))
        order = np.lexsort((keys, row_of))
        sorted_flat = neg_flat[order]
        starts = neg_offsets[:-1]
        take = starts[big][:, None] + np.arange(k)[None, :]
        out[big] = sorted_flat[take]

    # rows with <= k negatives: deterministic wrap j % n (file order)
    small = ~big & (lengths > 0)
    if small.any():
        idx = np.nonzero(small)[0]
        j = np.arange(k)[None, :]
        n = lengths[idx][:, None]
        take = neg_offsets[idx][:, None] + (j % n)
        out[idx] = neg_flat[take]
    # rows with zero negatives keep id 0 (the pad news)
    return out
