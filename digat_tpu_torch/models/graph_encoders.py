"""Dual-graph encoders: DIGAT and its five ablations.

Counterpart of `digat_tpu.models.graph_encoders` (`init`,
`news_graph_context`, `user_graph_context`, `_user_graph_nodes`,
`_gat_layer`, `forward`, `initial_news_context`), every variant:

  DIGAT                interactive GAT layers on both graphs;
  wo_SA                no news graph: the candidate is node 0, and only the
                       user graph is iterated (interactive, on node 0);
  Seq_SA               the news context of the SAG fixed; only the user
                       graph is iterated (interactive);
  wo_interaction       vanilla GAT layers on both graphs;
  news_graph_wo_inter  vanilla on the news graph, interactive on the user's;
  user_graph_wo_inter  interactive on the news graph, vanilla on the user's.

Eval (no dropout) runs every interactive GAT layer as one call of kernel B
(`ops.gat_layer.interactive_gat_layer_fused`). Training runs the composed
layer of the JAX package: input dropout p/2, one fused x [W|W1|W2]
product y, Eq. (8) read from y in place through kernel C
(`ops.gat_scores.interactive_gat_scores_fused_y`, forward and backward),
leaky ReLU, masked softmax, dropout p on alpha, aggregation and residual.
The other dropout sites mirror the reference's rates too: gate logits
p/2, topic p, topic-node broadcast p/2. Each site draws its mask
from kernel A'' under the step's seed and its own site number
(`layers.DropoutSites`). The vanilla layer (additive a1 + a2 scores, no
cross-graph query) is plain PyTorch, as the JAX package leaves it to XLA,
with the interactive layer's dropout sites: p/2 on x, p on alpha.

The depth loop alternates a news-graph and a user-graph layer and adds both
contexts up. Given a cached initial news context `c_n0`, the first news
context is not recomputed (the two-stage scorer's stage 2).

At `compute_dtype` bfloat16 the weights are bf16 copies and every
activation stays fp32: each product of an activation and a weight is
formed in fp32 (`layers.promoted`), as JAX's type promotion forms it. The
topic-node embeddings are the one activation taken from a weight: dropped
in fp32 and rounded back to bf16, as the JAX package drops them in their
own dtype, then promoted where they join the history nodes."""

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
    promoted,
    sdp_attn,
)
from digat_tpu_torch.ops.gat import vanilla_gat_scores
from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused
from digat_tpu_torch.ops.gat_scores import interactive_gat_scores_fused_y
from digat_tpu_torch.ops.segment import segment_softmax_sum


# the GAT stack of each graph per variant, (news graph, user graph):
# "interactive", "vanilla" or None (no such stack), as `init` composes them
VARIANT_GATS = {
    "DIGAT": ("interactive", "interactive"),
    "wo_SA": (None, "interactive"),
    "Seq_SA": (None, "interactive"),
    "wo_interaction": ("vanilla", "vanilla"),
    "news_graph_wo_inter": ("vanilla", "interactive"),
    "user_graph_wo_inter": ("interactive", "vanilla"),
}


def _gat_stack(module: nn.Module, prefix: str, kind: str, depth: int, dim: int,
               g: torch.Generator):
    """Per-depth GAT parameters under the reference names (nn.ModuleLists):
    interactive `{prefix}_W`, `_ffn1`, `_ffn2`, `_ffn3`, `_a`; vanilla
    `{prefix}_W`, `_a1`, `_a2`."""
    glr = gain_leaky_relu(0.2)
    if kind == "vanilla":
        layers = {
            "W": [make_linear(dim, dim, g, init="xavier", bias_init="zeros")
                  for _ in range(depth)],
            "a1": [make_linear(dim, 1, g, bias=False, init="xavier", gain=glr)
                   for _ in range(depth)],
            "a2": [make_linear(dim, 1, g, bias=False, init="xavier", gain=glr)
                   for _ in range(depth)],
        }
        for name, mods in layers.items():
            setattr(module, f"{prefix}_{name}", nn.ModuleList(mods))
        return
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


class GraphEncoder(nn.Module):
    """One variant of `VARIANT_GATS`, with the parameters that variant has (no
    news-context weights for wo_SA, no news-graph stack for wo_SA and
    Seq_SA)."""

    def __init__(self, variant: str, depth: int, max_history_num: int, category_num: int,
                 dim: int, dropout_rate: float, generator: torch.Generator):
        super().__init__()
        if variant not in VARIANT_GATS:
            raise ValueError(f"unknown graph encoder {variant}")
        self.variant = variant
        self.news_gat, self.user_gat = VARIANT_GATS[variant]
        self.depth = depth
        self.dropout_rate = dropout_rate
        self.max_history_num = max_history_num
        self.category_num = category_num
        self.dim = dim
        g = generator
        self.topic_node_embedding = nn.Parameter(torch.zeros(category_num, dim))
        if variant != "wo_SA":
            self.candidate_attention = ScaledDotProductAttention(dim, dim, dim, g)
            self.news_graph_W = make_linear(2 * dim, dim, g, init="xavier", bias_init="zeros")
        self.user_news_K = make_linear(dim, dim, g, bias=False, init="xavier")
        self.user_news_Q = make_linear(dim, dim, g, init="xavier", bias_init="zeros")
        self.featureAffine = make_linear(dim, dim, g, init="xavier", gain=GAIN_RELU,
                                         bias_init="zeros")
        self.userAttention = ScaledDotProductAttention(dim, dim, dim, g)
        if self.news_gat is not None:
            _gat_stack(self, "news_graph_attention", self.news_gat, depth, dim, g)
        _gat_stack(self, "user_graph_attention", self.user_gat, depth, dim, g)

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
        acc = torch.promote_types(topic.dtype, torch.float32)
        topic = drop(topic.to(acc), self.dropout_rate / 2).to(topic.dtype)
        return torch.cat(promoted(user_news_embedding, topic), dim=1)

    def gat_layer(self, prefix: str, i: int, x, adj, query,
                  drop: DropoutSites = EVAL) -> torch.Tensor:
        """One GAT layer of the graph's stack: interactive where `query` is
        given, vanilla where it is None."""
        if query is None:
            return self.vanilla_gat_layer(prefix, i, x, adj, drop)
        return self.interactive_gat_layer(prefix, i, x, adj, query, drop)

    def vanilla_gat_layer(self, prefix: str, i: int, x, adj,
                          drop: DropoutSites = EVAL) -> torch.Tensor:
        """out[i] = relu(sum_j alpha[i, j] h[j]) + x[i], alpha the masked
        softmax over neighbours j of leaky_relu(a1 . h[j] + a2 . h[i])."""
        p = self.dropout_rate
        x = drop(x, p / 2)
        h = linear(x, getattr(self, f"{prefix}_W")[i])
        scores = vanilla_gat_scores(*promoted(h, getattr(self, f"{prefix}_a1")[i].weight[0],
                                              getattr(self, f"{prefix}_a2")[i].weight[0]))
        alpha = masked_softmax(F.leaky_relu(scores, 0.2), adj, dim=2)
        alpha = drop(alpha, p)
        return torch.relu(torch.einsum("bij,bjd->bid", alpha, h)) + x

    def interactive_gat_layer(self, prefix: str, i: int, x, adj, query,
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
        xw, wy, bW = promoted(x, torch.cat([W.weight, W1.weight, W2.weight]), W.bias)
        y = xw @ wy.t()
        h = y[..., :D] + bW
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
        `drop` carries the training step's dropout (default: eval). The
        dropout sites are drawn in the JAX package's call order."""
        user_x = self.user_graph_nodes(user_news_embedding, drop)
        if self.variant == "wo_SA":
            # no news graph: the candidate is node 0 (c_n0 is that node too)
            cand = news_graph_embeddings[:, 0, :]
            for i in range(self.depth):
                user_x = self.gat_layer("user_graph_attention", i, user_x, user_graph, cand,
                                        drop)
            return cand, self.user_graph_context(user_x, user_category_mask,
                                                 user_category_indices, cand, drop)
        if c_n0 is None:
            c_n = self.news_graph_context(news_graph_embeddings, news_graph_mask, drop)
        else:
            c_n = c_n0
        c_u = self.user_graph_context(user_x, user_category_mask, user_category_indices, c_n,
                                      drop)
        if self.variant == "Seq_SA":
            # the news context stays fixed; only the user graph is iterated
            for i in range(self.depth):
                user_x = self.gat_layer("user_graph_attention", i, user_x, user_graph, c_n, drop)
                c_u = c_u + self.user_graph_context(user_x, user_category_mask,
                                                    user_category_indices, c_n, drop)
            return c_n, c_u
        news_interactive = self.news_gat == "interactive"
        user_interactive = self.user_gat == "interactive"
        news_x = news_graph_embeddings
        for i in range(self.depth):
            news_x = self.gat_layer("news_graph_attention", i, news_x, news_graph,
                                    c_u if news_interactive else None, drop)
            user_x = self.gat_layer("user_graph_attention", i, user_x, user_graph,
                                    c_n if user_interactive else None, drop)
            c_n = c_n + self.news_graph_context(news_x, news_graph_mask, drop)
            c_u = c_u + self.user_graph_context(user_x, user_category_mask,
                                                user_category_indices, c_n, drop)
        return c_n, c_u

    def initial_news_context(self, news_graph_embeddings, news_graph_mask) -> torch.Tensor:
        """Stage-1 cache: c_n0 for every unique news (node 0 for wo_SA)."""
        if self.variant == "wo_SA":
            return news_graph_embeddings[:, 0, :]
        return self.news_graph_context(news_graph_embeddings, news_graph_mask)
