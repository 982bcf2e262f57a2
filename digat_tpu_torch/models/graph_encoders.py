"""DIGAT dual-graph encoder.

Counterpart of the DIGAT variant of `digat_tpu.models.graph_encoders`
(`news_graph_context`, `user_graph_context`, `_user_graph_nodes`,
`_gat_layer`, `forward`, `initial_news_context`). Eval (no dropout) runs
every interactive GAT layer as one call of kernel B
(`ops.gat_layer.interactive_gat_layer_fused`). Training runs the composed
layer of the JAX package: input dropout p/2, one fused x [W|W1|W2]
product y, Eq. (8) read from y in place through kernel C
(`ops.gat_scores.interactive_gat_scores_fused_y`, forward and backward),
leaky ReLU, masked softmax, dropout p on alpha, aggregation and residual.
The other dropout sites mirror the reference's rates too: gate logits
p/2, topic p, topic-node broadcast p/2. Each site draws its mask
from kernel A'' under the step's seed and its own site number
(`layers.DropoutSites`). The five ablations and the vanilla GAT belong to a
later slice.

The depth loop alternates a news-graph and a user-graph layer and adds both
contexts up. Given a cached initial news context `c_n0`, the first news
context is not recomputed (the two-stage scorer's stage 2)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from digat_tpu_torch.layers import (
    EVAL,
    GAIN_RELU,
    DropoutSites,
    ScaledDotProductAttention,
    gain_leaky_relu,
    linear,
    make_linear,
    masked_softmax,
    sdp_attn,
)
from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused
from digat_tpu_torch.ops.gat_scores import interactive_gat_scores_fused_y
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
                 dropout_rate: float, generator: torch.Generator):
        super().__init__()
        self.depth = depth
        self.dropout_rate = dropout_rate
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
    def news_graph_context(self, x: torch.Tensor, node_mask: torch.Tensor,
                           drop: DropoutSites = EVAL) -> torch.Tensor:
        """Gated fusion of the candidate (node 0) with query-conditioned
        attention over the SAG. x [B, G, D], node_mask [B, G] -> [B, D]."""
        local = x[:, 0, :]
        global_ = sdp_attn(self.candidate_attention, x, local, node_mask)
        gate_logits = linear(torch.cat([local, global_], dim=-1), self.news_graph_W)
        gate = torch.sigmoid(drop(gate_logits, self.dropout_rate / 2))
        return gate * local + (1.0 - gate) * global_

    def user_graph_context(self, user_x, cat_mask, cat_idx, query,
                           drop: DropoutSites = EVAL) -> torch.Tensor:
        """Topic-level segmented attention, then user-level attention.
        user_x [B, Gu, D]; cat_mask [B, C+1]; cat_idx [B, H]; query [B, D]."""
        hist = user_x[:, : self.max_history_num, :]
        k = linear(hist, self.user_news_K)
        q = linear(query, self.user_news_Q)
        a = torch.einsum("bhd,bd->bh", k, q) / math.sqrt(float(self.dim))
        _, topic = segment_softmax_sum(a, hist, cat_idx, self.category_num + 1)
        topic = torch.relu(linear(topic, self.featureAffine)) + topic
        topic = drop(topic, self.dropout_rate)
        return sdp_attn(self.userAttention, topic, query, cat_mask)

    def user_graph_nodes(self, user_news_embedding: torch.Tensor,
                         drop: DropoutSites = EVAL) -> torch.Tensor:
        """History-news nodes followed by the topic nodes: [B, H+C, D]."""
        B = user_news_embedding.shape[0]
        topic = self.topic_node_embedding[None].expand(B, self.category_num, self.dim)
        topic = drop(topic, self.dropout_rate / 2)
        return torch.cat([user_news_embedding, topic], dim=1)

    def gat_layer(self, prefix: str, i: int, x, adj, query,
                  drop: DropoutSites = EVAL) -> torch.Tensor:
        """One interactive GAT layer: kernel B in eval, the composed layer
        with kernel C in training (as `_gat_layer` picks the fused kernel
        only when not training)."""
        W = getattr(self, f"{prefix}_W")[i]
        W1 = getattr(self, f"{prefix}_ffn1")[i]
        W2 = getattr(self, f"{prefix}_ffn2")[i]
        W3 = getattr(self, f"{prefix}_ffn3")[i]
        a_vec = getattr(self, f"{prefix}_a")[i].weight[0]
        if not drop.training:
            return interactive_gat_layer_fused(
                x.contiguous(), adj.contiguous(), query.contiguous(), W.weight.t(), W.bias,
                W1.weight.t(), W2.weight.t(), W3.weight.t(), W3.bias, a_vec)
        p = self.dropout_rate
        x = drop(x, p / 2)
        D = x.shape[-1]
        # one [D, 3D] product for the three per-node projections
        y = x @ torch.cat([W.weight, W1.weight, W2.weight]).t()
        h = y[..., :D] + W.bias
        scores = interactive_gat_scores_fused_y(y, linear(query, W3), a_vec)
        alpha = masked_softmax(F.leaky_relu(scores, 0.2), adj, dim=2)
        alpha = drop(alpha, p)
        return torch.relu(torch.einsum("bij,bjd->bid", alpha, h)) + x

    # ------------------------------------------------------------------
    def forward(self, news_graph_embeddings, news_graph, news_graph_mask,
                user_news_embedding, user_graph, user_category_mask,
                user_category_indices, c_n0: Optional[torch.Tensor] = None,
                drop: DropoutSites = EVAL):
        """Returns (news_representation, user_representation), both [B, D].
        `drop` carries the training step's dropout (default: eval)."""
        user_x = self.user_graph_nodes(user_news_embedding, drop)
        if c_n0 is None:
            c_n = self.news_graph_context(news_graph_embeddings, news_graph_mask, drop)
        else:
            c_n = c_n0
        c_u = self.user_graph_context(user_x, user_category_mask, user_category_indices, c_n,
                                      drop)
        news_x = news_graph_embeddings
        for i in range(self.depth):
            news_x = self.gat_layer("news_graph_attention", i, news_x, news_graph, c_u, drop)
            user_x = self.gat_layer("user_graph_attention", i, user_x, user_graph, c_n, drop)
            c_n = c_n + self.news_graph_context(news_x, news_graph_mask, drop)
            c_u = c_u + self.user_graph_context(user_x, user_category_mask,
                                                user_category_indices, c_n, drop)
        return c_n, c_u

    def initial_news_context(self, news_graph_embeddings, news_graph_mask) -> torch.Tensor:
        """Stage-1 cache: c_n0 for every unique news."""
        return self.news_graph_context(news_graph_embeddings, news_graph_mask)
