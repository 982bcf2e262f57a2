"""Fused interactive GAT layer, eval (kernel B).

Replaces `digat_tpu/ops/pallas/gat_layer.py::interactive_gat_layer_fused`
(`_layer_kernel`). One eval-mode layer of the dual-graph encoder:

    h  = x W + bW,  k1 = x W1,  k2 = x W2,  k3 = q W3 + b3
    s[i, j]  = a . relu(k1[j] + k2[i] + k3)
    alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
    out      = relu(alpha h) + x

The CUDA kernel is `csrc/gat_layer.cu`, launched in two steps by the one
wrapper call: `gat_layer_project` (a tiled fp32 GEMM for the projections) and
`gat_layer_attend` (one block per graph for the rest); its header says what bounds
it on the card. On a CPU tensor the wrapper runs
`interactive_gat_layer_plain`; on a CUDA tensor it launches the kernel or
raises. The kernel's output carries no gradient, so under grad mode with an
input that requires grad the wrapper raises: training runs its own layer
(`models.graph_encoders`, kernel C). fp32 only: bf16 input belongs to a
later slice.
"""

from __future__ import annotations

import torch

from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops.gat import interactive_gat_scores


def interactive_gat_layer_plain(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                negative_slope: float = 0.2):
    """Plain PyTorch version. x [B, G, D]; adj [B, G, G] bool; query [B, D];
    W, W1, W2, W3 [D, D] ([in, out] layout); bW, b3, a_vec [D]."""
    h = x @ W + bW
    k1 = x @ W1
    k2 = x @ W2
    k3 = query @ W3 + b3
    s = interactive_gat_scores(k1, k2, k3, a_vec)
    e = torch.where(s > 0, s, negative_slope * s)
    e = torch.where(adj.to(torch.bool), e, torch.full_like(e, MASK_FILL))
    alpha = torch.softmax(e, dim=2)
    return torch.relu(torch.einsum("bij,bjd->bid", alpha, h)) + x


def gat_layer_project(x, query, W, bW, W1, W2, W3, b3):
    """Step 1 of kernel B -> (y [B*G, 3D] = x [W|W1|W2] + [bW|0|0],
    k3 [B, D] = query W3 + b3). Weights are [out, in] and contiguous; the
    caller checks the inputs. Counts no launch: the wrapper counts."""
    B, G, D = x.shape
    y = torch.empty((B * G, 3 * D), dtype=torch.float32, device=x.device)
    k3 = torch.empty((B, D), dtype=torch.float32, device=x.device)
    with build.launch_on(x.device) as (lib, stream):
        err = lib.gat_layer_project_f32(
            x.data_ptr(), query.data_ptr(), W.data_ptr(), bW.data_ptr(), W1.data_ptr(),
            W2.data_ptr(), W3.data_ptr(), b3.data_ptr(), y.data_ptr(), k3.data_ptr(), B, G, D,
            stream,
        )
    build.check(lib, err, "interactive_gat_layer_fused (project)")
    return y, k3


def gat_layer_attend(x, adj, y, k3, a_vec, negative_slope):
    """Step 2 of kernel B: Eq. 8 scores, mask, softmax over j, then
    relu(alpha h) + x -> [B, G, D]. Counts no launch: the wrapper counts."""
    B, G, D = x.shape
    out = torch.empty_like(x)
    with build.launch_on(x.device) as (lib, stream):
        err = lib.gat_layer_attend_f32(
            x.data_ptr(), adj.data_ptr(), y.data_ptr(), k3.data_ptr(), a_vec.data_ptr(),
            out.data_ptr(), B, G, D, float(negative_slope), stream,
        )
    build.check(lib, err, "interactive_gat_layer_fused (attend)")
    return out


def interactive_gat_layer_fused(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                negative_slope: float = 0.2):
    """Kernel B. Same arguments and result as `interactive_gat_layer_plain`.
    The kernel reads W, W1, W2 and W3 in nn.Linear layout ([out, in]): a
    weight passed as `linear.weight.t()`, as the graph encoder does, is read
    in place; any other is copied into that layout."""
    if not build.use_kernel(x):
        return interactive_gat_layer_plain(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                           negative_slope)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, query, W, bW, W1, W2, W3, b3, a_vec)):
        raise RuntimeError("interactive_gat_layer_fused is the eval layer and passes no "
                           "gradient; the training layer runs Eq. (8) through "
                           "ops.gat_scores.interactive_gat_scores")
    B, G, D = x.shape
    if x.dtype != torch.float32:
        raise TypeError(f"interactive_gat_layer_fused: x must be float32, got {x.dtype}")
    if adj.dtype != torch.bool or tuple(adj.shape) != (B, G, G):
        raise TypeError(f"interactive_gat_layer_fused: adj must be bool [B, G, G], "
                        f"got {adj.dtype} {tuple(adj.shape)}")
    shapes = {"query": (query, (B, D)), "W": (W, (D, D)), "W1": (W1, (D, D)),
              "W2": (W2, (D, D)), "W3": (W3, (D, D)), "bW": (bW, (D,)), "b3": (b3, (D,)),
              "a_vec": (a_vec, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"interactive_gat_layer_fused: {name} must be float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (x.is_contiguous() and adj.is_contiguous() and query.is_contiguous()):
        raise ValueError("interactive_gat_layer_fused: x, adj and query must be contiguous")
    if B == 0:
        return torch.empty_like(x)
    W, W1, W2, W3 = (w.t().contiguous() for w in (W, W1, W2, W3))
    y, k3 = gat_layer_project(x, query, W, bW.contiguous(), W1, W2, W3, b3.contiguous())
    out = gat_layer_attend(x, adj, y, k3, a_vec.contiguous(), negative_slope)
    interactive_gat_layer_fused.launches += 1
    return out


interactive_gat_layer_fused.launches = 0
