"""Core layers on the serving path, as PyTorch modules.

Counterpart of `digat_tpu/layers.py`: the same initialiser distributions
(torch-default fan-in uniform, xavier-uniform with activation gains), the
same -1e9 mask fill and an fp32 softmax. Modules keep the reference
PyTorch `state_dict` names (`affine1`/`affine2`, `K`/`Q`, `W_K`/`W_Q`/`W_V`)
so `digat_tpu.interop.torch_to_params` reads a port model directly.

Weights live in `nn.Linear` layout `[out, in]` (apply `x @ W.T + b`), where
the JAX package stores `[in, out]`; `interop.load_jax_params` transposes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

MASK_FILL = -1e9

GAIN_RELU = math.sqrt(2.0)
GAIN_TANH = 5.0 / 3.0


def gain_leaky_relu(negative_slope: float = 0.2) -> float:
    return math.sqrt(2.0 / (1.0 + negative_slope**2))


def make_linear(
    d_in: int,
    d_out: int,
    generator: torch.Generator,
    *,
    bias: bool = True,
    init: str = "torch",  # torch | xavier
    gain: float = 1.0,
    bias_init: str = "torch",  # torch | zeros
) -> nn.Linear:
    """An `nn.Linear` drawn from `generator` (CPU) with the JAX package's
    `linear_init` distributions."""
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, bias=bias)
    with torch.no_grad():
        if init == "torch":
            bound = 1.0 / math.sqrt(d_in)
        else:
            bound = gain * math.sqrt(6.0 / (d_in + d_out))
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            if bias_init == "zeros":
                lin.bias.zero_()
            else:
                b = 1.0 / math.sqrt(d_in)
                lin.bias.uniform_(-b, b, generator=generator)
    return lin


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, lin.weight, lin.bias)


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """softmax(where(mask, scores, -1e9)) in at least fp32; a fully masked
    row becomes uniform, as in the reference."""
    dtype = scores.dtype
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, torch.full_like(scores, MASK_FILL))
    acc = torch.promote_types(dtype, torch.float32)
    return torch.softmax(scores.to(acc), dim=dim).to(dtype)


class AttentionPool(nn.Module):
    """Masked tanh-MLP attention pooling (reference layers.py "Attention")."""

    def __init__(self, feature_dim: int, attention_dim: int, generator: torch.Generator):
        super().__init__()
        self.affine1 = make_linear(feature_dim, attention_dim, generator, init="xavier",
                                   gain=GAIN_TANH, bias_init="zeros")
        self.affine2 = make_linear(attention_dim, 1, generator, bias=False, init="xavier")

    def forward(self, feature: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return attn_pool(self, feature, mask)


def attn_pool(pool: AttentionPool, feature: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feature [..., L, D], mask [..., L] -> [..., D]."""
    a = linear(torch.tanh(linear(feature, pool.affine1)), pool.affine2)
    alpha = masked_softmax(a.squeeze(-1), mask, dim=-1)
    return torch.einsum("...l,...ld->...d", alpha, feature)


class ScaledDotProductAttention(nn.Module):
    """Single-query scaled dot-product attention (reference
    "ScaledDotProductAttention")."""

    def __init__(self, feature_dim: int, query_dim: int, attention_dim: int,
                 generator: torch.Generator):
        super().__init__()
        self.K = make_linear(feature_dim, attention_dim, generator, bias=False, init="xavier")
        self.Q = make_linear(query_dim, attention_dim, generator, init="xavier", bias_init="zeros")

    def forward(self, feature, query, mask=None):
        return sdp_attn(self, feature, query, mask)


def sdp_attn(attn: ScaledDotProductAttention, feature: torch.Tensor, query: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feature [..., L, Df], query [..., Dq], mask [..., L] -> [..., Df]."""
    k = linear(feature, attn.K)
    q = linear(query, attn.Q)
    a = torch.einsum("...ld,...d->...l", k, q) / math.sqrt(float(attn.K.out_features))
    alpha = masked_softmax(a, mask, dim=-1)
    return torch.einsum("...l,...ld->...d", alpha, feature)


class MultiHeadAttention(nn.Module):
    """The projections of the reference's unmasked multi-head self-attention.
    On the serving path the whole encoder after the embedding runs in
    `ops.msa_encoder.msa_encoder_pooled`, which reads these weights."""

    def __init__(self, heads: int, d_model: int, d_k: int, d_v: int, generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.W_K = make_linear(d_model, heads * d_k, generator, bias=False)
        self.W_Q = make_linear(d_model, heads * d_k, generator, bias_init="zeros")
        self.W_V = make_linear(d_model, heads * d_v, generator, bias_init="zeros")
