"""Segmented softmax and weighted sum over category indices.

Counterpart of `digat_tpu/ops/segment.py` with torch_scatter semantics and
a static segment count: the softmax normalises within each segment, empty
segments give all-zero rows, and every position belongs to one segment in
[0, num_segments)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -3.0e38  # finite stand-in for -inf, as in the JAX package


def segment_softmax_sum(scores: torch.Tensor, values: torch.Tensor,
                        segment_ids: torch.Tensor, num_segments: int):
    """Per-segment softmax of `scores` [..., H], then the weighted sum of
    `values` [..., H, D] per segment.

    Returns (alpha [..., H], segsum [..., S, D])."""
    out_dtype = values.dtype
    acc = torch.promote_types(scores.dtype, torch.float32)
    scores = scores.to(acc)
    onehot = F.one_hot(segment_ids.long(), num_segments).to(acc)  # [..., H, S]
    masked = torch.where(onehot > 0, scores[..., None], torch.full_like(onehot, NEG_INF))
    seg_max = masked.amax(dim=-2)  # [..., S]
    pos_max = torch.einsum("...hs,...s->...h", onehot, seg_max)
    ex = torch.exp(scores - pos_max)
    seg_den = torch.einsum("...h,...hs->...s", ex, onehot)
    pos_den = torch.einsum("...hs,...s->...h", onehot, seg_den)
    alpha = (ex / pos_den).to(out_dtype)
    weighted = onehot.to(out_dtype) * alpha[..., None]
    segsum = torch.einsum("...hs,...hd->...sd", weighted, values)
    return alpha, segsum
