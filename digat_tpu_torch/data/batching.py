"""Stage-2 eval batches as tensors.

Counterpart of `digat_tpu.data.batching.eval_batches` on one device: items
keep file order, and the last batch is padded to the full batch size with
item 0 so every batch has one shape. Multi-host sharding belongs to the
multi-GPU slice."""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from digat_tpu_torch.models.model import EvalBatch


def eval_batches(
    history_idx: np.ndarray,
    cat_idx: np.ndarray,
    imp_index: np.ndarray,  # [items] -> behavior row
    cand: np.ndarray,  # [items]
    batch_size: int,
    device,
) -> Iterator[tuple]:
    """Yields (EvalBatch on `device`, valid_count)."""
    items = np.arange(len(cand))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)
    for s in range(0, len(items), batch_size):
        sel = items[s : s + batch_size]
        b = len(sel)
        if b < batch_size:
            sel = np.concatenate([sel, np.zeros(batch_size - b, np.int64)])
        rows = imp_index[sel]
        yield (
            EvalBatch(history_idx=put(history_idx[rows]), cat_idx=put(cat_idx[rows]),
                      cand_idx=put(cand[sel])),
            b,
        )
