"""User history-graph construction on tensors.

Counterpart of `digat_tpu.data.user_graph.build_user_graph`: the dense
adjacency is rebuilt from the per-slot category indices (padded slots
carry index C) with the reference's edge rules: self-loops everywhere,
news-topic edges, news-news edges within a category, and topic-topic edges
between present categories."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def build_user_graph(cat_idx: torch.Tensor, max_history_num: int, category_num: int):
    """cat_idx [..., H] int -> (user_graph [..., H+C, H+C] bool,
    category_mask [..., C+1] bool)."""
    H, C = max_history_num, category_num
    cat_idx = cat_idx.long()
    valid = cat_idx < C
    onehot = F.one_hot(cat_idx.clamp(max=C), C + 1)[..., :C].bool() & valid[..., None]
    present = onehot.any(dim=-2)  # [..., C]
    nn_ = valid[..., :, None] & valid[..., None, :] & (cat_idx[..., :, None] == cat_idx[..., None, :])
    tt = present[..., :, None] & present[..., None, :]
    top = torch.cat([nn_, onehot], dim=-1)
    bottom = torch.cat([onehot.transpose(-1, -2), tt], dim=-1)
    graph = torch.cat([top, bottom], dim=-2)
    graph = graph | torch.eye(H + C, dtype=torch.bool, device=cat_idx.device)
    category_mask = torch.cat([present, torch.zeros_like(present[..., :1])], dim=-1)
    return graph, category_mask
