"""Fused MSA news encoder: embedded titles -> pooled news vectors, forward
(kernel A) and recompute backward (kernel A').

Replaces `digat_tpu/ops/pallas/msa_encoder.py::msa_encoder_pooled`: the
forward `_fwd_kernel` and the custom-VJP backward `_bwd_kernel` (and its
restructured `_bwd_kernel_v2`, same gradients). Per title: word dropout,
Q/K/V projections, multi-head UNMASKED softmax attention (pads attend),
ReLU, and the masked tanh-MLP attention pool (-1e9 fill, fp32 softmax).
Heads are not padded: the result is [N, H*dk].

The word dropout of training is applied inside the kernels: each element of
x is kept with probability 1 - rate and scaled by 1 / (1 - rate), from the
Philox bits of `ops.dropout` at row = title offset, col = position * Din +
feature, under (seed, site). The mask is never stored; the backward draws
it again.

On a CPU tensor `msa_encoder_pooled` runs `msa_encoder_pooled_plain`, whose
gradients are autograd's. On a CUDA tensor it goes through
`MSAEncoderFunction`: forward kernel A (`csrc/msa_encoder.cu`), backward
kernel A' (`csrc/msa_encoder_bwd.cu`); each header says what bounds it on
the card and how the design answers that. There is no fallback: a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import math

import torch

from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops.dropout import keep_mask_plain, threshold

TITLE_LENGTH = 32  # the kernels keep one warp lane per title position


def drop_titles_plain(x, rate: float, seed: int, site: int):
    """x [N, L, Din] with the kernels' word dropout applied."""
    if rate <= 0.0:
        return x
    N, L, Din = x.shape
    keep = keep_mask_plain(N, L * Din, rate, seed, site, device=x.device).reshape(N, L, Din)
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


def msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int,
                             dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain PyTorch version. x [N, L, Din]; mask [N, L] bool; wq/wk/wv
    [Din, H*dk] ([in, out] layout); bq, bv [H*dk]; w1 [H*dk, A]; b1, v [A]
    -> [N, H*dk]."""
    x = drop_titles_plain(x, dropout_rate, seed, site)
    N, L, _ = x.shape
    D = wq.shape[1]
    dk = D // heads
    q = (x @ wq + bq).reshape(N, L, heads, dk)
    k = (x @ wk).reshape(N, L, heads, dk)
    val = (x @ wv + bv).reshape(N, L, heads, dk)
    a = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(float(dk))
    p = torch.softmax(a, dim=-1)
    h = torch.relu(torch.einsum("nhqk,nkhd->nqhd", p, val).reshape(N, L, D))
    lg = torch.tanh(h @ w1 + b1) @ v
    lg = torch.where(mask.to(torch.bool), lg, torch.full_like(lg, MASK_FILL))
    alpha = torch.softmax(lg, dim=-1)
    return torch.einsum("nl,nld->nd", alpha, h)


def msa_encoder_bwd_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads: int,
                          dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Plain PyTorch version of kernel A': autograd through the plain
    forward. Returns (dx, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv) in the
    layouts of the arguments."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, wq, bq, wk, wv, bv, w1, b1, v)]
        out = msa_encoder_pooled_plain(leaves[0], mask, *leaves[1:], heads, dropout_rate, seed,
                                       site)
        return torch.autograd.grad(out, leaves, dp)


def _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, what):
    """Shapes, types and layouts the CUDA kernels take -> (N, L, Din, D, dk, A)."""
    N, L, Din = x.shape
    D = wq.shape[1]
    A = w1.shape[1]
    if D % heads:
        raise ValueError(f"{what}: D={D} not divisible by heads={heads}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x must be float32, got {x.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (N, L):
        raise TypeError(f"{what}: mask must be bool [N, L], got {mask.dtype} {tuple(mask.shape)}")
    if L != TITLE_LENGTH:
        raise ValueError(f"{what}: the kernels take titles of length {TITLE_LENGTH}, got {L}")
    if Din % 4 or D % 4:
        raise ValueError(f"{what}: Din={Din} and D={D} must be multiples of 4")
    shapes = {"wq": (wq, (Din, D)), "wk": (wk, (Din, D)), "wv": (wv, (Din, D)),
              "bq": (bq, (D,)), "bv": (bv, (D,)), "w1": (w1, (D, A)), "b1": (b1, (A,)),
              "v": (v, (A,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{what}: x and mask must be contiguous")
    return N, L, Din, D, D // heads, A


def _dropout_args(rate: float, seed: int, site: int):
    """(thresh, drop_scale, seed, site) as the kernels take them."""
    return (threshold(rate), 1.0 / (1.0 - rate) if rate > 0 else 1.0, seed & 0xFFFFFFFF,
            site & 0xFFFFFFFF)


def _linear_layout(*ws):
    """Weights passed as [in, out] -> contiguous [out, in] (nn.Linear layout);
    a `linear.weight.t()` view is read in place."""
    out = [w.t().contiguous() for w in ws]
    if any(t.data_ptr() % 16 for t in out):
        raise ValueError("msa_encoder: the weights must be 16-byte aligned")
    return out


def _forward_kernel(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site):
    N, L, Din, D, dk, A = _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                 "msa_encoder_pooled")
    wq_r, wk_r, wv_r, w1_r = _linear_layout(wq, wk, wv, w1)
    if x.data_ptr() % 16:
        raise ValueError("msa_encoder_pooled: x must be 16-byte aligned")
    out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    bq, bv, b1, v = bq.contiguous(), bv.contiguous(), b1.contiguous(), v.contiguous()
    with build.launch_on(x.device) as (lib, stream):
        err = lib.msa_encoder_pooled_f32(
            x.data_ptr(), mask.data_ptr(), wq_r.data_ptr(), bq.data_ptr(), wk_r.data_ptr(),
            wv_r.data_ptr(), bv.data_ptr(), w1_r.data_ptr(), b1.data_ptr(), v.data_ptr(),
            out.data_ptr(), N, L, Din, heads, dk, A, 1.0 / math.sqrt(float(dk)),
            *_dropout_args(rate, seed, site), stream,
        )
    build.check(lib, err, "msa_encoder_pooled")
    msa_encoder_pooled.launches += 1
    return out


def msa_encoder_bwd(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads: int,
                    dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Kernel A'. Same arguments and result as `msa_encoder_bwd_plain`
    (which it runs for a CPU tensor)."""
    if not build.use_kernel(x):
        return msa_encoder_bwd_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, heads,
                                     dropout_rate, seed, site)
    N, L, Din, D, dk, A = _check(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                 "msa_encoder_bwd")
    if tuple(dp.shape) != (N, D) or dp.dtype != torch.float32:
        raise ValueError(f"msa_encoder_bwd: dp must be float32 [{N}, {D}], got {dp.dtype} "
                         f"{tuple(dp.shape)}")
    wq_r, wk_r, wv_r, w1_r = _linear_layout(wq, wk, wv, w1)
    dev = x.device
    dx = torch.empty_like(x)
    dwqkv = torch.empty((3 * D, Din), dtype=torch.float32, device=dev)
    dbqkv = torch.empty(3 * D, dtype=torch.float32, device=dev)
    dw1 = torch.empty((A, D), dtype=torch.float32, device=dev)
    db1 = torch.empty(A, dtype=torch.float32, device=dev)
    dv = torch.empty(A, dtype=torch.float32, device=dev)
    if N == 0:
        return (dx, *(torch.zeros_like(t) for t in (wq, bq, wk, wv, bv, w1, b1, v)))
    dp, bq, bv, b1, v = (t.contiguous() for t in (dp, bq, bv, b1, v))
    with build.launch_on(dev) as (lib, stream):
        scratch = torch.empty(lib.msa_encoder_bwd_scratch_floats(N, L, Din, heads, dk, A),
                              dtype=torch.float32, device=dev)
        err = lib.msa_encoder_bwd_f32(
            x.data_ptr(), mask.data_ptr(), wq_r.data_ptr(), bq.data_ptr(), wk_r.data_ptr(),
            wv_r.data_ptr(), bv.data_ptr(), w1_r.data_ptr(), b1.data_ptr(), v.data_ptr(),
            dp.data_ptr(), dx.data_ptr(), dwqkv.data_ptr(), dbqkv.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dv.data_ptr(), scratch.data_ptr(), N, L, Din, heads, dk, A,
            1.0 / math.sqrt(float(dk)), *_dropout_args(dropout_rate, seed, site), stream,
        )
    build.check(lib, err, "msa_encoder_bwd")
    msa_encoder_bwd.launches += 1
    dwq, dwk, dwv = dwqkv[:D].t(), dwqkv[D:2 * D].t(), dwqkv[2 * D:].t()
    return dx, dwq, dbqkv[:D], dwk, dwv, dbqkv[2 * D:], dw1.t(), db1, dv


class MSAEncoderFunction(torch.autograd.Function):
    """Kernel A forward, kernel A' backward (CUDA tensors)."""

    @staticmethod
    def forward(ctx, x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site):
        ctx.save_for_backward(x, mask, wq, bq, wk, wv, bv, w1, b1, v)
        ctx.args = (heads, rate, seed, site)
        return _forward_kernel(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads, rate, seed, site)

    @staticmethod
    def backward(ctx, dp):
        x, mask, wq, bq, wk, wv, bv, w1, b1, v = ctx.saved_tensors
        heads, rate, seed, site = ctx.args
        dx, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv = msa_encoder_bwd(
            x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp.contiguous(), heads, rate, seed, site)
        return dx, None, dwq, dbq, dwk, dwv, dbv, dw1, db1, dv, None, None, None, None


def msa_encoder_pooled(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int,
                       dropout_rate: float = 0.0, seed: int = 0, site: int = 0):
    """Kernel A (forward) with kernel A' as its backward. Same arguments and
    result as `msa_encoder_pooled_plain`. The kernels read wq, wk, wv and w1
    in nn.Linear layout ([out, in]): a weight passed as `linear.weight.t()`,
    as the news encoder does, is read in place; any other is copied into
    that layout."""
    if not build.use_kernel(x):
        return msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                        dropout_rate, seed, site)
    return MSAEncoderFunction.apply(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads,
                                    float(dropout_rate), int(seed), int(site))


msa_encoder_pooled.launches = 0
msa_encoder_bwd.launches = 0
