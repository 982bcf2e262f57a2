"""DIGAT dual-graph encoder, eval path.

Counterpart of the DIGAT variant of `digat_tpu.models.graph_encoders`
(`news_graph_context`, `user_graph_context`, `_user_graph_nodes`,
`_gat_layer`, `forward`, `initial_news_context`) in eval mode: no dropout.
Every interactive GAT layer is one call of kernel B
(`ops.gat_layer.interactive_gat_layer_fused`). The five ablations and the
vanilla GAT belong to a later slice.

The depth loop alternates a news-graph and a user-graph layer and adds both
contexts up. Given a cached initial news context `c_n0`, the first news
context is not recomputed (the two-stage scorer's stage 2)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from digat_tpu_torch.layers import (
    GAIN_RELU,
    ScaledDotProductAttention,
    gain_leaky_relu,
    linear,
    make_linear,
    sdp_attn,
)
from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused
from digat_tpu_torch.ops.segment import segment_softmax_sum


def _gat_stack(module: nn.Module, prefix: str, depth: int, dim: int, g: torch.Generator):
    """Per-depth interactive GAT parameters under the reference names
    `{prefix}_W`, `_ffn1`, `_ffn2`, `_ffn3`, `_a` (nn.ModuleLists)."""
    glr = gain_leaky_relu(0.2)
    layers = {
        "W": [make_linear(dim, dim, g, init="xavier", bias_init="zeros") for _ in range(depth)],
        "ffn1": [make_linear(dim, dim, g, bias=False, init="xavier", gain=GAIN_RELU)
                 for _ in range(depth)],
        "ffn2": [make_linear(dim, dim, g, bias=False, init="xavier", gain=GAIN_RELU)
                 for _ in range(depth)],
        "ffn3": [make_linear(dim, dim, g, init="xavier", gain=GAIN_RELU, bias_init="zeros")
                 for _ in range(depth)],
        "a": [make_linear(dim, 1, g, bias=False, init="xavier", gain=glr) for _ in range(depth)],
    }
    for name, mods in layers.items():
        setattr(module, f"{prefix}_{name}", nn.ModuleList(mods))


class DIGATGraphEncoder(nn.Module):
    def __init__(self, depth: int, max_history_num: int, category_num: int, dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.depth = depth
        self.max_history_num = max_history_num
        self.category_num = category_num
        self.dim = dim
        g = generator
        self.topic_node_embedding = nn.Parameter(torch.zeros(category_num, dim))
        self.candidate_attention = ScaledDotProductAttention(dim, dim, dim, g)
        self.news_graph_W = make_linear(2 * dim, dim, g, init="xavier", bias_init="zeros")
        self.user_news_K = make_linear(dim, dim, g, bias=False, init="xavier")
        self.user_news_Q = make_linear(dim, dim, g, init="xavier", bias_init="zeros")
        self.featureAffine = make_linear(dim, dim, g, init="xavier", gain=GAIN_RELU,
                                         bias_init="zeros")
        self.userAttention = ScaledDotProductAttention(dim, dim, dim, g)
        _gat_stack(self, "news_graph_attention", depth, dim, g)
        _gat_stack(self, "user_graph_attention", depth, dim, g)

    # ------------------------------------------------------------------
    def news_graph_context(self, x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
        """Gated fusion of the candidate (node 0) with query-conditioned
        attention over the SAG. x [B, G, D], node_mask [B, G] -> [B, D]."""
        local = x[:, 0, :]
        global_ = sdp_attn(self.candidate_attention, x, local, node_mask)
        gate = torch.sigmoid(linear(torch.cat([local, global_], dim=-1), self.news_graph_W))
        return gate * local + (1.0 - gate) * global_

    def user_graph_context(self, user_x, cat_mask, cat_idx, query) -> torch.Tensor:
        """Topic-level segmented attention, then user-level attention.
        user_x [B, Gu, D]; cat_mask [B, C+1]; cat_idx [B, H]; query [B, D]."""
        hist = user_x[:, : self.max_history_num, :]
        k = linear(hist, self.user_news_K)
        q = linear(query, self.user_news_Q)
        a = torch.einsum("bhd,bd->bh", k, q) / math.sqrt(float(self.dim))
        _, topic = segment_softmax_sum(a, hist, cat_idx, self.category_num + 1)
        topic = torch.relu(linear(topic, self.featureAffine)) + topic
        return sdp_attn(self.userAttention, topic, query, cat_mask)

    def user_graph_nodes(self, user_news_embedding: torch.Tensor) -> torch.Tensor:
        """History-news nodes followed by the topic nodes: [B, H+C, D]."""
        B = user_news_embedding.shape[0]
        topic = self.topic_node_embedding[None].expand(B, self.category_num, self.dim)
        return torch.cat([user_news_embedding, topic], dim=1)

    def gat_layer(self, prefix: str, i: int, x, adj, query) -> torch.Tensor:
        """One interactive GAT layer, eval: kernel B."""
        W = getattr(self, f"{prefix}_W")[i]
        W3 = getattr(self, f"{prefix}_ffn3")[i]
        return interactive_gat_layer_fused(
            x.contiguous(), adj.contiguous(), query.contiguous(),
            W.weight.t(), W.bias,
            getattr(self, f"{prefix}_ffn1")[i].weight.t(),
            getattr(self, f"{prefix}_ffn2")[i].weight.t(),
            W3.weight.t(), W3.bias,
            getattr(self, f"{prefix}_a")[i].weight[0],
        )

    # ------------------------------------------------------------------
    def forward(self, news_graph_embeddings, news_graph, news_graph_mask,
                user_news_embedding, user_graph, user_category_mask,
                user_category_indices, c_n0: Optional[torch.Tensor] = None):
        """Returns (news_representation, user_representation), both [B, D]."""
        user_x = self.user_graph_nodes(user_news_embedding)
        if c_n0 is None:
            c_n = self.news_graph_context(news_graph_embeddings, news_graph_mask)
        else:
            c_n = c_n0
        c_u = self.user_graph_context(user_x, user_category_mask, user_category_indices, c_n)
        news_x = news_graph_embeddings
        for i in range(self.depth):
            news_x = self.gat_layer("news_graph_attention", i, news_x, news_graph, c_u)
            user_x = self.gat_layer("user_graph_attention", i, user_x, user_graph, c_n)
            c_n = c_n + self.news_graph_context(news_x, news_graph_mask)
            c_u = c_u + self.user_graph_context(user_x, user_category_mask,
                                                user_category_indices, c_n)
        return c_n, c_u

    def initial_news_context(self, news_graph_embeddings, news_graph_mask) -> torch.Tensor:
        """Stage-1 cache: c_n0 for every unique news."""
        return self.news_graph_context(news_graph_embeddings, news_graph_mask)
