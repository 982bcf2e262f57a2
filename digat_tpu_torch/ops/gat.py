"""Eq. (8) interactive graph-attention scores, plain PyTorch.

    score[b, i, j] = a . relu(K1[b, j] + K2[b, i] + K3[b])

Counterpart of `digat_tpu.ops.gat.interactive_gat_scores_xla`. It
materialises the [B, G, G, D] sum, so it runs over batch chunks that keep
that intermediate under `_MAX_ELEMENTS` floats; the hand-written layer
kernel (`ops.gat_layer`) never materialises it."""

from __future__ import annotations

import torch

_MAX_ELEMENTS = 1 << 27  # floats of the [chunk, G, G, D] sum: 512 MiB in fp32


def interactive_gat_scores(k1: torch.Tensor, k2: torch.Tensor, k3: torch.Tensor,
                           a_vec: torch.Tensor) -> torch.Tensor:
    """k1, k2 [B, G, D]; k3 [B, D]; a_vec [D] -> [B, G, G] logits (before
    leaky ReLU and mask)."""
    B, G, D = k1.shape
    step = max(1, _MAX_ELEMENTS // (G * G * D))
    out = []
    for s in range(0, B, step):
        t = (k1[s:s + step, None, :, :] + k2[s:s + step, :, None, :]
             + k3[s:s + step, None, None, :])
        out.append(torch.einsum("bijd,d->bij", torch.relu(t), a_vec))
    return torch.cat(out) if len(out) > 1 else out[0]
