"""Fused MSA news encoder (kernel A): embedded titles -> pooled news vectors.

Replaces `digat_tpu/ops/pallas/msa_encoder.py::msa_encoder_pooled` (the
forward `_fwd_kernel`, eval, dropout rate 0). Per title: Q/K/V projections,
multi-head UNMASKED softmax attention (pads attend), ReLU, and the masked
tanh-MLP attention pool (-1e9 fill, fp32 softmax). The CUDA kernel is
`csrc/msa_encoder.cu`; its header says what bounds it on the card and how
the design answers that. Heads are not padded: the result is [N, H*dk].

On a CPU tensor the wrapper runs `msa_encoder_pooled_plain`; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import build

TITLE_LENGTH = 32  # the kernel keeps one warp lane per title position


def msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int):
    """Plain PyTorch version. x [N, L, Din]; mask [N, L] bool; wq/wk/wv
    [Din, H*dk] ([in, out] layout); bq, bv [H*dk]; w1 [H*dk, A]; b1, v [A]
    -> [N, H*dk]."""
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


def msa_encoder_pooled(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads: int):
    """Kernel A. Same arguments and result as `msa_encoder_pooled_plain`.
    The kernel reads wq, wk, wv and w1 in nn.Linear layout ([out, in]): a
    weight passed as `linear.weight.t()`, as the news encoder does, is read
    in place; any other is copied into that layout."""
    if x.device.type == "cpu":
        return msa_encoder_pooled_plain(x, mask, wq, bq, wk, wv, bv, w1, b1, v, heads)
    if x.device.type != "cuda":
        raise ValueError(f"msa_encoder_pooled: unsupported device {x.device}")
    N, L, Din = x.shape
    D = wq.shape[1]
    A = w1.shape[1]
    if D % heads:
        raise ValueError(f"msa_encoder_pooled: D={D} not divisible by heads={heads}")
    dk = D // heads
    if x.dtype != torch.float32:
        raise TypeError(f"msa_encoder_pooled: x must be float32, got {x.dtype}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (N, L):
        raise TypeError(f"msa_encoder_pooled: mask must be bool [N, L], got {mask.dtype} {tuple(mask.shape)}")
    if L != TITLE_LENGTH:
        raise ValueError(f"msa_encoder_pooled: the kernel takes titles of length {TITLE_LENGTH}, got {L}")
    if Din % 4 or D % 4:
        raise ValueError(f"msa_encoder_pooled: Din={Din} and D={D} must be multiples of 4")
    shapes = {"wq": (wq, (Din, D)), "wk": (wk, (Din, D)), "wv": (wv, (Din, D)),
              "bq": (bq, (D,)), "bv": (bv, (D,)), "w1": (w1, (D, A)), "b1": (b1, (A,)),
              "v": (v, (A,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"msa_encoder_pooled: {name} must be float32 {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (x.is_contiguous() and mask.is_contiguous()):
        raise ValueError("msa_encoder_pooled: x and mask must be contiguous")
    wq_r, wk_r, wv_r, w1_r = (w.t().contiguous() for w in (wq, wk, wv, w1))
    if any(t.data_ptr() % 16 for t in (x, wq_r, wk_r, wv_r, w1_r)):
        raise ValueError("msa_encoder_pooled: x and the weights must be 16-byte aligned")
    out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    bq, bv, b1, v = bq.contiguous(), bv.contiguous(), b1.contiguous(), v.contiguous()
    lib = build.load_library()
    err = lib.msa_encoder_pooled_f32(
        x.data_ptr(), mask.data_ptr(), wq_r.data_ptr(), bq.data_ptr(), wk_r.data_ptr(),
        wv_r.data_ptr(), bv.data_ptr(), w1_r.data_ptr(), b1.data_ptr(), v.data_ptr(),
        out.data_ptr(), N, L, Din, heads, dk, A, 1.0 / math.sqrt(float(dk)),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    build.check(lib, err, "msa_encoder_pooled")
    msa_encoder_pooled.launches += 1
    return out


msa_encoder_pooled.launches = 0
