"""Graph-attention scores, plain PyTorch: Eq. (8) and the vanilla GAT's.

    score[b, i, j] = a . relu(K1[b, j] + K2[b, i] + K3[b])

Counterpart of `digat_tpu.ops.gat.interactive_gat_scores_xla`. It
materialises the [B, G, G, D] sum, so it runs over batch chunks that keep
that intermediate under `_MAX_ELEMENTS` floats; the hand-written kernels
(`ops.gat_layer`, `ops.gat_scores`) never materialise it. The sum is
formed as k1[j] + (k2[i] + k3), in the order the kernels form it, so the
relu mask is the same bits in all of them: where k1 + k2 + k3 rounds to
within an ulp of 0, another order can flip the mask and move a gradient
entry by a whole g * a term.

`vanilla_gat_scores` is the ablations' additive score, the counterpart of
`digat_tpu.ops.gat.vanilla_gat_scores`, which the JAX package computes in
XLA, outside any kernel."""

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
        t = k1[s:s + step, None, :, :] + (k2[s:s + step, :, None, :]
                                          + k3[s:s + step, None, None, :])
        out.append(torch.einsum("bijd,d->bij", torch.relu(t), a_vec))
    return torch.cat(out) if len(out) > 1 else out[0]


def vanilla_gat_scores(h: torch.Tensor, a1_vec: torch.Tensor, a2_vec: torch.Tensor) -> torch.Tensor:
    """Additive GAT logits score[b, i, j] = a1 . h[b, j] + a2 . h[b, i]. h [B,
    G, D]; a1_vec, a2_vec [D] -> [B, G, G]."""
    s1 = h @ a1_vec  # [B, G] (the j term)
    s2 = h @ a2_vec  # [B, G] (the i term)
    return s1[:, None, :] + s2[:, :, None]
