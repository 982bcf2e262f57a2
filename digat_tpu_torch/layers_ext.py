"""The extended layer library: counterpart of `digat_tpu/layers_ext.py`.

The reference ships attention and graph modules beyond those its models
use (candidate and multi-candidate attention, multi and dual scaled
dot-product attention and the parameter-free dual one, GCN, gated RGCN,
GAT, multi-head GAT). They are part of the public layer library for
building model variants; nothing in either package imports them. Each is
an `nn.Module` whose parameters keep the JAX tree's names (`feature`,
`query`, `attn`; `layers.{i}.W`, `fs` / `fr` / `fa`, `V` / `Q` / `K`,
`ln_scale` / `ln_bias`), with the same math, the -1e9 mask fill
(`layers.masked_softmax`) and the same initializer laws and gains.
`load_jax_params(module, params)` fills a module from the JAX function's
parameter tree.

Dropout applies only in training (a `seed` given) and only where the JAX
functions put it: on the attention weights of the GATs, and between
layers, not after the last. It goes through `layers.dropout` (kernel A''
on a CUDA tensor, its plain version on the CPU); the calls are numbered in
order from `site` under `seed` (`layers.DropoutSites`). The products are
plain, as the JAX functions leave them to XLA.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from digat_tpu_torch.layers import (
    GAIN_RELU,
    GAIN_TANH,
    DropoutSites,
    leaky_relu,
    linear,
    make_linear,
    masked_softmax,
    sigmoid,
)


# ---------------------------------------------------------------------------
# Candidate attentions (tanh-additive)
# ---------------------------------------------------------------------------
class CandidateAttention(nn.Module):
    """feature [B, N, Df], query [B, Dq], mask [B, N] -> [B, Df]."""

    def __init__(self, feature_dim: int, query_dim: int, attention_dim: int,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.feature = make_linear(feature_dim, attention_dim, g, bias=False, init="xavier",
                                   gain=GAIN_TANH)
        self.query = make_linear(query_dim, attention_dim, g, init="xavier", gain=GAIN_TANH,
                                 bias_init="zeros")
        self.attn = make_linear(attention_dim, 1, g, bias=False, init="xavier")

    def forward(self, feature, query, mask=None):
        a = linear(torch.tanh(linear(feature, self.feature)
                              + linear(query, self.query)[..., None, :]), self.attn).squeeze(-1)
        alpha = masked_softmax(a, mask, dim=-1)
        return torch.einsum("...n,...nd->...d", alpha, feature)


class MultiCandidateAttention(CandidateAttention):
    """The same parameters for several queries: feature [B, N, Df], query
    [B, Q, Dq], mask [B, N] -> [B, Q, Df]."""

    def forward(self, feature, query, mask=None):
        a = linear(torch.tanh(linear(feature, self.feature)[..., None, :, :]
                              + linear(query, self.query)[..., :, None, :]),
                   self.attn).squeeze(-1)  # [B, Q, N]
        m = None if mask is None else mask[..., None, :]
        alpha = masked_softmax(a, m, dim=-1)
        return torch.einsum("...qn,...nd->...qd", alpha, feature)


# ---------------------------------------------------------------------------
# Multi-query and dual scaled dot-product attentions
# ---------------------------------------------------------------------------
class MultiSDPAttention(nn.Module):
    """feature [B, N, Df], query [B, Q, Dq], mask [B, Q, N] -> [B, Q, Df]."""

    def __init__(self, feature_dim: int, query_dim: int, attention_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.K = make_linear(feature_dim, attention_dim, generator, init="xavier",
                             bias_init="zeros")
        self.Q = make_linear(query_dim, attention_dim, generator, init="xavier",
                             bias_init="zeros")

    def forward(self, feature, query, mask=None):
        d = self.K.out_features
        a = torch.einsum("...qd,...nd->...qn", linear(query, self.Q),
                         linear(feature, self.K)) / math.sqrt(float(d))
        alpha = masked_softmax(a, mask, dim=-1)
        return torch.einsum("...qn,...nd->...qd", alpha, feature)


def _dual(a, feature1, feature2, mask):
    alpha1 = masked_softmax(a, mask, dim=-1)  # over feature2
    alpha2 = masked_softmax(a, mask, dim=-2)  # over feature1
    out1 = torch.einsum("...ij,...id->...jd", alpha2, feature1)
    out2 = torch.einsum("...ij,...jd->...id", alpha1, feature2)
    return out1, out2


class DualSDPAttention(nn.Module):
    """Bidirectional co-attention: feature1 [B, N1, Df1], feature2 [B, N2,
    Df2], mask [B, N1, N2] -> (out1 [B, N2, Df1], out2 [B, N1, Df2]), as the
    reference's code computes them (its doc comment swaps the names)."""

    def __init__(self, feature_dim1: int, feature_dim2: int, attention_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.f1 = make_linear(feature_dim1, attention_dim, generator, init="xavier",
                              bias_init="zeros")
        self.f2 = make_linear(feature_dim2, attention_dim, generator, init="xavier",
                              bias_init="zeros")

    def forward(self, feature1, feature2, mask=None):
        d = self.f1.out_features
        a = torch.einsum("...id,...jd->...ij", linear(feature1, self.f1),
                         linear(feature2, self.f2)) / math.sqrt(float(d))
        return _dual(a, feature1, feature2, mask)


def dual_sdp_attention_free(feature1, feature2, mask=None):
    """The parameter-free dual attention (the features of one width)."""
    d = feature1.shape[-1]
    a = torch.einsum("...id,...jd->...ij", feature1, feature2) / math.sqrt(float(d))
    return _dual(a, feature1, feature2, mask)


# ---------------------------------------------------------------------------
# Graph convolution stacks: feature [B, N, D], graph [B, N, N] (bool or 0/1)
# ---------------------------------------------------------------------------
def _layer_norm(x, scale, bias, eps: float = 1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _aggregate(graph, x):
    return torch.einsum("...ij,...jd->...id", graph.to(x.dtype), x)


class _GCNLayer(nn.Module):
    def __init__(self, d_in: int, d_out: int, layer_norm: bool, generator: torch.Generator):
        super().__init__()
        self.W = make_linear(d_in, d_out, generator, init="xavier", gain=GAIN_RELU,
                             bias_init="zeros")
        if layer_norm:
            self.ln_scale = nn.Parameter(torch.ones(d_out))
            self.ln_bias = nn.Parameter(torch.zeros(d_out))


class GCN(nn.Module):
    """Stacked GCN: relu(W (A x)) a layer, with an optional LayerNorm before
    the ReLU and residual after it; dropout between layers in training."""

    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator,
                 hidden_dim: int = 0, num_layers: int = 1, layer_norm: bool = False):
        super().__init__()
        dims = ([(in_dim, out_dim)] if num_layers == 1 else
                [(in_dim, hidden_dim)] + [(hidden_dim, hidden_dim)] * (num_layers - 2)
                + [(hidden_dim, out_dim)])
        self.layers = nn.ModuleList(_GCNLayer(di, do, layer_norm, generator) for di, do in dims)

    def forward(self, feature, graph, *, seed: Optional[int] = None, site: int = 0,
                dropout: float = 0.0, residual: bool = False):
        sites, out = DropoutSites(seed, site), feature
        for i, p in enumerate(self.layers):
            h = linear(_aggregate(graph, out), p.W)
            if hasattr(p, "ln_scale"):
                h = _layer_norm(h, p.ln_scale, p.ln_bias)
            h = torch.relu(h)
            out = h + out if residual else h
            if dropout > 0 and i < len(self.layers) - 1:
                out = sites(out, dropout)
        return out


class _GatedLayer(nn.Module):
    def __init__(self, d: int, generator: torch.Generator):
        super().__init__()
        gain = 1.0  # calculate_gain('sigmoid')
        self.fs = make_linear(d, d, generator, init="xavier", gain=gain, bias_init="zeros")
        self.fr = make_linear(d, d, generator, init="xavier", gain=gain, bias_init="zeros")
        self.fa = make_linear(2 * d, d, generator, init="xavier", gain=gain, bias_init="zeros")


class GatedRGCN(nn.Module):
    """Gated relational GCN: h = fs x + fr (A x), gate = sigmoid(fa [h, x]),
    out = relu(h) gate + x (1 - gate); dropout between layers in training."""

    def __init__(self, feature_dim: int, generator: torch.Generator, num_layers: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(_GatedLayer(feature_dim, generator)
                                    for _ in range(num_layers))

    def forward(self, feature, graph, *, seed: Optional[int] = None, site: int = 0,
                dropout: float = 0.0):
        sites, out = DropoutSites(seed, site), feature
        for i, p in enumerate(self.layers):
            h = linear(out, p.fs) + linear(_aggregate(graph, out), p.fr)
            gate = sigmoid(linear(torch.cat([h, out], dim=-1), p.fa))
            out = torch.relu(h) * gate + out * (1.0 - gate)
            if dropout > 0 and i < len(self.layers) - 1:
                out = sites(out, dropout)
        return out


class _Projections(nn.Module):
    def __init__(self, **linears):
        super().__init__()
        for name, lin in linears.items():
            setattr(self, name, lin)


def _attend(e, graph, h, sites, dropout):
    """softmax over the graph's edges of the leaky-ReLU scores, dropout on
    the weights in training, then the weighted sum of h."""
    alpha = masked_softmax(leaky_relu(e, 0.2), graph, dim=-1)
    if dropout > 0:
        alpha = sites(alpha, dropout)
    return torch.einsum("...ij,...jd->...id", alpha, h)


class GAT(nn.Module):
    """Scaled dot-product GAT: h = W x, alpha = softmax over the edges of
    leaky_relu((Q h)(K h)^T / sqrt(d), 0.2), out = relu(alpha h) (+ x with
    `residual`). Torch-default initialisation, as the reference's."""

    def __init__(self, feature_dim: int, generator: torch.Generator, num_layers: int = 1):
        super().__init__()
        d, g = feature_dim, generator
        self.layers = nn.ModuleList(
            _Projections(W=make_linear(d, d, g), Q=make_linear(d, d, g), K=make_linear(d, d, g))
            for _ in range(num_layers))

    def forward(self, feature, graph, *, seed: Optional[int] = None, site: int = 0,
                dropout: float = 0.0, residual: bool = False):
        sites, out = DropoutSites(seed, site), feature
        d = feature.shape[-1]
        for i, p in enumerate(self.layers):
            h = linear(out, p.W)
            e = torch.einsum("...id,...jd->...ij", linear(h, p.Q),
                             linear(h, p.K)) / math.sqrt(float(d))
            new = torch.relu(_attend(e, graph, h, sites, dropout))
            out = new + out if residual else new
            if dropout > 0 and i < len(self.layers) - 1:
                out = sites(out, dropout)
        return out


class MultiheadGAT(nn.Module):
    """GAT with `head_num` heads of the feature width (V projects to all of
    them, Q and K are shared), averaged over the heads after the
    aggregation and before the ReLU."""

    def __init__(self, feature_dim: int, head_num: int, generator: torch.Generator,
                 num_layers: int = 1):
        super().__init__()
        d, g = feature_dim, generator
        self.head_num = head_num
        self.layers = nn.ModuleList(
            _Projections(V=make_linear(d, head_num * d, g),
                         Q=make_linear(d, d, g, init="xavier", bias_init="zeros"),
                         K=make_linear(d, d, g, init="xavier", bias_init="zeros"))
            for _ in range(num_layers))

    def forward(self, feature, graph, *, seed: Optional[int] = None, site: int = 0,
                dropout: float = 0.0, residual: bool = False):
        sites, out = DropoutSites(seed, site), feature
        d = feature.shape[-1]
        for i, p in enumerate(self.layers):
            lead, n = out.shape[:-2], out.shape[-2]
            h = linear(out, p.V).reshape(*lead, n, self.head_num, d).movedim(-2, -3)
            e = torch.einsum("...id,...jd->...ij", linear(h, p.Q),
                             linear(h, p.K)) / math.sqrt(float(d))
            new = torch.relu(_attend(e, graph[..., None, :, :], h, sites, dropout).mean(dim=-3))
            out = new + out if residual else new
            if dropout > 0 and i < len(self.layers) - 1:
                out = sites(out, dropout)
        return out


# ---------------------------------------------------------------------------
# Weights from the JAX functions' parameter trees
# ---------------------------------------------------------------------------
def state_dict_from_jax(params) -> dict:
    """The state_dict (numpy arrays) of a module for the parameter tree of
    its JAX counterpart (the `*_init` functions of `digat_tpu.layers_ext`):
    a linear's {"w" [in, out], "b"} becomes its `weight` (transposed) and
    `bias`, a list its entries 0, 1, ..., any other array the parameter of
    its name."""
    sd = {}

    def walk(node, prefix):
        if isinstance(node, Mapping) and "w" in node and not isinstance(node["w"], Mapping):
            sd[f"{prefix}weight"] = np.asarray(node["w"]).T
            if "b" in node:
                sd[f"{prefix}bias"] = np.asarray(node["b"])
        elif isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for k, v in enumerate(node):
                walk(v, f"{prefix}{k}.")
        else:
            sd[prefix[:-1]] = np.asarray(node)

    walk(params, "")
    return sd


def load_jax_params(module: nn.Module, params) -> nn.Module:
    """Fill `module` from the parameter tree of its JAX counterpart
    (`state_dict_from_jax`), strictly: a missing, stray or misshapen array
    raises (RuntimeError)."""
    dtype = next(module.parameters()).dtype
    module.load_state_dict({k: torch.from_numpy(np.array(v)).to(dtype)
                            for k, v in state_dict_from_jax(params).items()}, strict=True)
    return module
