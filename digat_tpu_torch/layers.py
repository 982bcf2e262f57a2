"""Core layers, as PyTorch modules and functions.

Counterpart of `digat_tpu/layers.py`: the same initialiser distributions
(torch-default fan-in uniform, xavier-uniform with activation gains), the
same -1e9 mask fill and an fp32 softmax, and inverted dropout for
training. Modules keep the reference PyTorch `state_dict` names
(`affine1`/`affine2`, `K`/`Q`, `W_K`/`W_Q`/`W_V`) so
`digat_tpu.interop.torch_to_params` reads a port model directly.

Weights live in `nn.Linear` layout `[out, in]` (apply `x @ W.T + b`), where
the JAX package stores `[in, out]`; `interop.load_jax_params` transposes.

At `compute_dtype` bfloat16 the weights are bf16 copies. Where the
activations stay fp32 (MSA through kernel A, the NRMS user tower), JAX's
type promotion forms an fp32 activation times a bf16 weight in fp32;
PyTorch's products refuse mixed dtypes, so every such site goes through
`promoted` (`linear` does). Where they are bf16 (the NRMS title tower's
projections, MSA titles past 128 positions, the CNN encoder and the graph
encoder behind it), each op rounds its result to bf16 as XLA does on the
JAX package's CPU backend (measured there): `x @ w + b` rounds the product
and then the sum (`linear`), a weak-typed Python scalar takes the bf16
dtype before it is used (`scale_down`, `leaky_relu`), `sigmoid` is
XLA's expansion, and the attention
pair returns its bf16 output cast to fp32 (`mha`).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from digat_tpu_torch.ops.dropout import dropout as apply_dropout
from digat_tpu_torch.ops.msa_attention import msa_attention

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


def promoted(*ts):
    """The tensors in their common dtype (`torch.promote_types` over them, as
    `jnp.result_type` promotes: bf16 with fp32 is fp32); None stays None. A
    tensor already of that dtype is returned as it is. The cast of a bf16
    weight is differentiable: its gradient comes back rounded to bf16, as
    the transpose of JAX's `convert_element_type` rounds it."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in ts if t is not None))
    return tuple(None if t is None else t.to(dtype) for t in ts)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """x W^T + b in the dtype that x and the weights promote to; in bf16 the
    product is rounded to bf16 before the bias is added, as XLA rounds
    `x @ w + b`."""
    x, w, b = promoted(x, lin.weight, lin.bias)
    if x.dtype != torch.bfloat16 or b is None:
        return F.linear(x, w, b)
    return F.linear(x, w) + b


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar x as a weak-typed JAX scalar meets t: rounded to
    bf16 where t is bf16 (torch then computes with it in fp32 and rounds
    the result once, as XLA does), as it is otherwise."""
    return float(torch.tensor(x, dtype=torch.bfloat16)) if t.dtype == torch.bfloat16 else x


def scale_down(t: torch.Tensor, divisor: float) -> torch.Tensor:
    """t / divisor, the divisor a weak-typed scalar (sqrt(32) -> 5.65625 in
    bf16)."""
    return t / _weak(divisor, t)


def sigmoid(t: torch.Tensor) -> torch.Tensor:
    """jax.nn.sigmoid: 1 / (1 + exp(-t)), which XLA rounds op by op in bf16
    (measured on the JAX package's CPU backend; torch's bf16 sigmoid rounds
    once and differs in about a third of the elements)."""
    if t.dtype != torch.bfloat16:
        return torch.sigmoid(t)
    return 1.0 / (1.0 + torch.exp(-t))


def leaky_relu(t: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    """jax.nn.leaky_relu: where(t >= 0, t, slope * t), the slope a weak-typed
    scalar (0.2001953125 in bf16, where F.leaky_relu would multiply by
    0.2)."""
    if t.dtype != torch.bfloat16:
        return F.leaky_relu(t, negative_slope)
    return torch.where(t >= 0, t, t * _weak(negative_slope, t))


def dropout(x: torch.Tensor, rate: float, seed: Optional[int], site: int) -> torch.Tensor:
    """Inverted dropout of training: x / (1 - rate) where kept, else 0, by
    kernel A'' (`ops.dropout.dropout`: one fused launch forward and one
    backward on the card, `dropout_plain` on the CPU). The keep mask of x
    seen as [rows, last dim] under (seed, site) is the same bits on the card
    and the CPU. Identity when `seed` is None (eval) or the rate is 0. The
    JAX package draws from `jax.random`, a different stream of the same
    law."""
    if seed is None or rate <= 0.0:
        return x
    return apply_dropout(x, rate, seed, site)


class DropoutSites:
    """The dropout sites of one training step, numbered in call order: call
    k draws its mask under (seed, first_site + k). With `seed` None every
    call is the identity (eval)."""

    def __init__(self, seed: Optional[int], first_site: int = 0):
        self.seed = seed
        self.next_site = first_site

    @property
    def training(self) -> bool:
        return self.seed is not None

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.seed is None:
            return x
        site = self.next_site
        self.next_site += 1
        return dropout(x, rate, self.seed, site)


EVAL = DropoutSites(None)  # no dropout: the eval path


def masked_softmax(scores: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """softmax(where(mask, scores, -1e9)) in at least fp32; a fully masked
    row becomes uniform, as in the reference. Training uses it unchanged on
    the GAT scores, with dropout on its result."""
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
    a = linear(torch.tanh(linear(feature, pool.affine1)), pool.affine2).squeeze(-1)
    if mask is not None:
        a = torch.where(mask.to(torch.bool), a, torch.full_like(a, MASK_FILL))
    return SoftmaxPool.apply(*promoted(a, feature))


class SoftmaxPool(torch.autograd.Function):
    """out = sum_l softmax(scores)_l feature_l (softmax in at least fp32;
    scores and feature of one dtype), with its backward written for
    accuracy. Autograd would form the score
    gradient as ds_l = a_l (g.f_l - sum_m a_m g.f_m), the difference of two
    nearly equal dot products where the rows f_l are alike (the many pad
    slots of a history), and the rounding of that difference leaks into
    every later sum over l, whose exact value is 0 (the pool's bias
    gradient). The written backward takes the difference first, ds_l = a_l
    g.(f_l - out), and removes what rounding leaves of sum_l ds_l. The same
    function; at full width the NRMS user pool's fp32 bias gradient comes 60
    x closer to fp64 (4.1e-3 -> 6.6e-5 of its scale on the CPU,
    `scripts/nrms_gradient_precision.py`)."""

    @staticmethod
    def forward(ctx, scores, feature):
        alpha = torch.softmax(scores.to(torch.promote_types(scores.dtype, torch.float32)),
                              dim=-1).to(feature.dtype)
        out = torch.einsum("...l,...ld->...d", alpha, feature)
        ctx.save_for_backward(alpha, feature, out)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, feature, out = ctx.saved_tensors
        ds = alpha * torch.einsum("...ld,...d->...l", feature - out[..., None, :], g)
        ds = ds - alpha * ds.sum(dim=-1, keepdim=True)
        return ds, alpha[..., None] * g[..., None, :]


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
    a = scale_down(torch.einsum("...ld,...d->...l", k, q), math.sqrt(float(attn.K.out_features)))
    alpha = masked_softmax(a, mask, dim=-1)
    return torch.einsum("...l,...ld->...d", alpha, feature)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention (reference "MultiHeadAttention"). The DIGAT
    news encoder reads only these projections: its whole encoder after the
    embedding runs in `ops.msa_encoder.msa_encoder_pooled`. The NRMS family
    calls `forward` (`mha`), with a key mask."""

    def __init__(self, heads: int, d_model: int, d_k: int, d_v: int, generator: torch.Generator):
        super().__init__()
        self.heads = heads
        self.W_K = make_linear(d_model, heads * d_k, generator, bias=False)
        self.W_Q = make_linear(d_model, heads * d_k, generator, bias_init="zeros")
        self.W_V = make_linear(d_model, heads * d_v, generator, bias_init="zeros")

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return mha(self, x, self.heads, key_mask)


def mha(module: MultiHeadAttention, x: torch.Tensor, heads: int,
        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention, the counterpart of `digat_tpu.layers.mha`. x [..., L,
    d_model] -> [..., L, heads * d_v]; `key_mask` [..., L] masks keys with
    the -1e9 fill (the Appendix-B masked variant), None leaves every key in.
    The result is fp32 (fp64 for an fp64 model) whatever the projections'
    dtype, as the JAX package casts it: bf16 projections (a bf16 x and bf16
    weights) take the pair's bf16 instance.

    The projections are plain products, as the JAX package forms them
    outside any kernel. The attention core is the kernel pair of
    `ops.msa_attention` on the packed layout. The JAX package routes it by
    `ops.msa_attention_grouped.group_size(heads, L, dk)`: to E (heads padded
    to 128 / g lanes) when it is positive, to F (packed) when it is 0. Here
    both geometries take the one packed kernel pair: E's padding is a TPU
    lane layout and would cost the card its pad lanes' bytes (3.2 x at the
    NRMS user tower)."""
    L, D = x.shape[-2], module.W_Q.out_features
    q, k, v = (linear(x, lin).reshape(-1, L, D) for lin in (module.W_Q, module.W_K,
                                                            module.W_V))
    mask = None if key_mask is None else key_mask.reshape(-1, L).to(torch.bool)
    out = msa_attention(q, k, v, heads, mask).reshape(*x.shape[:-1], D)
    return out.to(torch.promote_types(out.dtype, torch.float32))


# ---------------------------------------------------------------------------
# 1-D convolution bank of the CNN news encoder (`digat_tpu.layers.
# conv1d_bank`). The convolution is F.conv1d, a plain product outside any
# kernel, as the JAX package leaves `lax.conv_general_dilated` to XLA.
# ---------------------------------------------------------------------------
def conv_bank_widths(method: str, window: int) -> tuple:
    """The kernel widths of a bank: (window,) naive, (1, 3, 5) group3,
    (1, 2, 3, 4, 5) group5."""
    if method == "naive":
        return (window,)
    if method == "group3":
        return (1, 3, 5)
    if method == "group5":
        return (1, 2, 3, 4, 5)
    raise ValueError(f"unknown cnn_method {method}")


def make_conv1d(in_ch: int, out_ch: int, width: int, generator: torch.Generator) -> nn.Conv1d:
    """An `nn.Conv1d` (weight [out, in, width]) drawn from `generator` with
    torch's default law, U(+-1 / sqrt(in * width)) for weight and bias, as
    the JAX package's `_conv_init`."""
    conv = nn.utils.skip_init(nn.Conv1d, in_ch, out_ch, width)
    bound = 1.0 / math.sqrt(in_ch * width)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)
    return conv


class ConvBank(nn.Module):
    """relu(concat of the bank's convolutions) over a title: [..., L, C_in]
    -> [..., L, kernel_num], kernel_num / len(widths) channels a width.
    state_dict names follow the reference: `conv` (naive), `conv1` ...
    (group3, group5). Odd widths pad (w - 1) / 2 zero frames on each side
    (the same length out); even widths one more on the right, as
    `digat_tpu.layers._conv1d_same`. At bf16 the bias is its own add after
    the convolution's rounded result, as `_conv1d_same` adds it (XLA's CPU
    backend rounds twice, jitted or not); at fp32 it stays in the
    convolution."""

    def __init__(self, method: str, in_ch: int, kernel_num: int, window: int,
                 generator: torch.Generator):
        super().__init__()
        self.widths = conv_bank_widths(method, window)
        self.names = ["conv"] if method == "naive" else [
            f"conv{i + 1}" for i in range(len(self.widths))]
        per = kernel_num // len(self.widths)
        for name, w in zip(self.names, self.widths):
            setattr(self, name, make_conv1d(in_ch, per, w, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead, (L, C) = x.shape[:-2], x.shape[-2:]
        xt = x.reshape(-1, L, C).transpose(1, 2)  # [N, C_in, L]
        outs = []
        for name, w in zip(self.names, self.widths):
            conv = getattr(self, name)
            pad = (w - 1) // 2
            xp = F.pad(xt, (pad, pad if w % 2 else pad + 1))
            if xp.dtype == torch.bfloat16:
                outs.append(F.conv1d(xp, conv.weight) + conv.bias[:, None])
            else:
                outs.append(F.conv1d(xp, conv.weight, conv.bias))
        h = torch.relu(torch.cat(outs, dim=1)).transpose(1, 2)  # [N, L, kernel_num]
        return h.reshape(*lead, L, h.shape[-1])
