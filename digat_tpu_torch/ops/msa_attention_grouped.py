"""Masked multi-head self-attention over head-padded projections (E).

Replaces `digat_tpu/ops/pallas/msa_attention_grouped.py::msa_attention_grouped`
(`_fwd_kernel`, `_bwd_kernel`). The TPU kernel packs g heads into one
128-lane group, each head padded from dk to dkp = 128 / g lanes by
zero-padded projection weights (`pad_head_projection`), so that every
product is one dense 128-lane contraction. That layout is a TPU device:
the port's model runs the packed layout (`layers.mha`). This module keeps
E's entry point for callers that hold the padded layout: it launches the
kernel pair of `ops.msa_attention` with head stride dkp, reads the first dk
lanes of each head, takes the softmax scale from the true dk, and writes
the pad lanes of out, dq, dk and dv as zeros, as E's output has them.

`group_size`, `pad_head_projection` and `unpad_heads` are copies of the JAX
module's (the port imports nothing of it), in PyTorch.
"""

from __future__ import annotations

import torch

from digat_tpu_torch.ops import build
from digat_tpu_torch.ops.msa_attention import MSAAttentionFunction, attention_plain_strided


def group_size(heads: int, L: int, dk: int) -> int:
    """Largest divisor g of `heads` with g*L <= 128 and dk <= 128//g; 0 if
    none works (the JAX package then takes the packed kernel F)."""
    for g in range(min(128 // L, heads), 0, -1):
        if heads % g == 0 and dk <= 128 // g:
            return g
    return 0


def pad_head_projection(w, b, heads: int, dkp: int):
    """Zero-pad packed projection weights [D_in, H*dk] (+ bias [H*dk]) so the
    projection emits head-padded activations [.., H*dkp] directly."""
    d_in, hd = w.shape
    dk = hd // heads
    wp = torch.nn.functional.pad(w.reshape(d_in, heads, dk), (0, dkp - dk)).reshape(
        d_in, heads * dkp)
    bp = None
    if b is not None:
        bp = torch.nn.functional.pad(b.reshape(heads, dk), (0, dkp - dk)).reshape(-1)
    return wp, bp


def unpad_heads(x, heads: int, dk: int):
    """[.., H*dkp] -> packed [.., H*dk]."""
    dkp = x.shape[-1] // heads
    return x.reshape(*x.shape[:-1], heads, dkp)[..., :dk].reshape(*x.shape[:-1], heads * dk)


def msa_attention_grouped(q, k, v, heads: int, dk: int, mask=None):
    """q, k, v [N, L, heads * dkp] head-padded (see `pad_head_projection`);
    dk the true head width; mask [N, L] bool or None -> head-padded [N, L,
    heads * dkp], zero in the pad lanes. Differentiable in q, k and v."""
    N, L, Dp = q.shape
    if group_size(heads, L, dk) <= 0:
        raise ValueError(f"no valid group size for heads={heads} L={L} dk={dk}")
    if Dp % heads or Dp // heads < dk:
        raise ValueError(f"width {Dp} is not {heads} heads of at least {dk} lanes")
    if not build.use_kernel(q):
        return attention_plain_strided(q, k, v, heads, dk, mask)
    mask = None if mask is None else mask.to(torch.bool)
    return MSAAttentionFunction.apply(q, k, v, mask, heads, dk)
