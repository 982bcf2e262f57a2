"""Model assembly for serving: MSA news encoder, DIGAT graph encoder, dot
product.

Counterpart of `digat_tpu.models.model` (`CorpusTables`, `EvalBatch`,
`Model.encode_news`, `initial_news_context`, `inference`), eval only: the
training path belongs to a later slice. Parameters live in `nn.Module`s
under the reference `state_dict` names, drawn from an explicit
`torch.Generator` on the CPU and then moved to the model's device, so one
seed gives the same weights on every device."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from digat_tpu_torch.config import Config
from digat_tpu_torch.models.graph_encoders import DIGATGraphEncoder
from digat_tpu_torch.models.news_encoders import NewsEncoder
from digat_tpu_torch.runtime import exact_fp32, resolve_device


class CorpusTables(NamedTuple):
    """Corpus arrays on the model's device, shared by every batch."""

    news_title_text: torch.Tensor  # [news_num, L] int64
    news_title_mask: torch.Tensor  # [news_num, L] bool
    news_node_id: torch.Tensor  # [news_num, Gn] int64 (SAG node ids)
    news_graph: torch.Tensor  # [news_num, Gn, Gn] bool (self-loops added)
    news_graph_mask: torch.Tensor  # [news_num, Gn] bool (slot 0 zeroed)

    @classmethod
    def from_arrays(cls, tables, device) -> "CorpusTables":
        """Any object with the five fields (numpy arrays or tensors) ->
        CorpusTables on `device`."""
        def put(x, dtype):
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
            return t.to(device=device, dtype=dtype).contiguous()

        return cls(
            news_title_text=put(tables.news_title_text, torch.int64),
            news_title_mask=put(tables.news_title_mask, torch.bool),
            news_node_id=put(tables.news_node_id, torch.int64),
            news_graph=put(tables.news_graph, torch.bool),
            news_graph_mask=put(tables.news_graph_mask, torch.bool),
        )


class EvalBatch(NamedTuple):
    """Stage-2 batch: one impression item per row."""

    history_idx: torch.Tensor  # [B, H] int64
    cat_idx: torch.Tensor  # [B, H] int64
    cand_idx: torch.Tensor  # [B] int64


class Model(nn.Module):
    """MSA-DIGAT for serving. Runs on CUDA unless `device` names another
    device; with no device and no CUDA it raises."""

    def __init__(self, config: Config, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        config.validate()
        device = resolve_device(device)
        exact_fp32()
        self.config = config
        g = generator if generator is not None else torch.Generator().manual_seed(config.seed)
        self.news_encoder = NewsEncoder(
            config.vocabulary_size, config.word_embedding_dim, config.MSA_head_num,
            config.MSA_head_dim, config.attention_dim, config.max_title_length, g,
        )
        self.graph_encoder = DIGATGraphEncoder(
            config.graph_depth, config.max_history_num, config.category_num,
            config.news_embedding_dim, g,
        )
        self.requires_grad_(False)
        super().train(False)
        self.to(device)
        self.device = device

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("digat_tpu_torch ports the eval path only; training is a later slice")
        return super().train(False)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def encode_news(self, title_text: torch.Tensor, title_mask: torch.Tensor) -> torch.Tensor:
        """Stage-1: encode news titles -> [..., D]."""
        return self.news_encoder(title_text, title_mask)

    @torch.inference_mode()
    def initial_news_context(self, sag_embeddings: torch.Tensor, news_graph_mask: torch.Tensor):
        """Stage-1: c_n0 from the SAG node representations [B, Gn, D]."""
        return self.graph_encoder.initial_news_context(sag_embeddings, news_graph_mask)

    @torch.inference_mode()
    def inference(self, user_news_embedding, user_graph, user_category_mask,
                  user_category_indices, candidate_news_embedding, news_graph,
                  news_graph_mask, c_n0) -> torch.Tensor:
        """Two-stage cached scoring -> logits [B]."""
        news_rep, user_rep = self.graph_encoder(
            candidate_news_embedding, news_graph, news_graph_mask, user_news_embedding,
            user_graph, user_category_mask, user_category_indices, c_n0=c_n0,
        )
        return (news_rep * user_rep).sum(dim=-1)
