"""Fused interactive GAT layer, eval (kernel B).

Replaces `digat_tpu/ops/pallas/gat_layer.py::interactive_gat_layer_fused`
(`_layer_kernel`). One eval-mode layer of the dual-graph encoder:

    h  = x W + bW,  k1 = x W1,  k2 = x W2,  k3 = q W3 + b3
    s[i, j]  = a . relu(k1[j] + k2[i] + k3)
    alpha    = softmax_j(where(adj, leaky_relu(s, 0.2), -1e9))
    out      = relu(alpha h) + x

The CUDA kernel is `csrc/gat_layer.cu`, three launches of the one wrapper
call on the caller's stream: `gat_layer_project_f32` (y = x [W|W1|W2] +
[bW|0|0] and k3 on the tensor cores at 3xTF32), kernel C's forward
(`csrc/gat_scores.cu`, with `ops.gat_scores.fwd_plan`) on y's k1 and k2
column blocks, and `gat_layer_attend_f32` (mask, softmax over j and
relu(alpha h) + x, with `attend_plan`); its header says what bounds it on
the card. On a CPU tensor the wrapper runs `interactive_gat_layer_plain`;
on a CUDA tensor it launches the kernels or raises. The kernel's output
carries no gradient, so under grad mode with an input that requires grad
the wrapper raises: training runs its own layer (`models.graph_encoders`,
kernel C).

bf16 weights (`compute_dtype` bfloat16 where the news vectors stay fp32:
MSA-DIGAT): x, query and the result stay fp32, as the JAX kernel takes
them; the wrapper stacks W|W1|W2 as bf16 (half the bytes) and upcasts bW,
b3 and a (exact). Two steps, counted on `launches_bf16`:
`gat_layer_project_bf16` splits x and query into three bf16 planes each
(hi, mid, lo; they sum back to x within 2^-24 |x|) in scratch the wrapper
allocates, then forms the fp32 y and k3 on `wgmma` in three bf16 passes
against the exact bf16 weights (every partial product exact in fp32; D
padded to a multiple of 8, `padded_width(D, 8)`), and `gat_layer_fused_f32`
is the bf16-activation instance's fused step (below) with x read and the
result written as fp32. The scores never leave the chip.

bf16 activations (CNN-DIGAT at bfloat16, whose news vectors are bf16): x,
query and the weights bf16, the result bf16, as the JAX kernel reads x in
its dtype, computes in fp32 and writes out in x's dtype
(`gat_layer.py:51,95`). Two launches: `gat_layer_project_bf16_act` forms
the fp32 y and k3 on `wgmma` in one bf16 pass (every product exact in
fp32; D padded to Dp, a multiple of 8), and `gat_layer_fused_bf16` forms
the scores, the mask, the softmax and relu(alpha h) + x of a tile of rows
of a graph in one block (`fused_plan`), reading x as bf16 and rounding
each output once; the scores never leave the chip. Counted on
`launches_bf16_act`. The plain version forms everything in fp32 from the
bf16 values and rounds the result once.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from digat_tpu_torch.layers import MASK_FILL
from digat_tpu_torch.ops import build
from digat_tpu_torch.ops.gat import interactive_gat_scores
from digat_tpu_torch.ops.gat_scores import (
    TilePlan,
    fwd_plan,
    slice_span,
    tile_plan,
    tile_stage_bytes,
    tile_threads,
)
from digat_tpu_torch.ops.msa_attention import MAX_SMEM_BYTES

MAX_ROWS = 32  # rows i of an attend block (kMaxRows in csrc/gat_layer.cu)
MAX_THREADS = 256  # an attend block: TI / 4 row groups x CG float4 columns


class AttendPlan(NamedTuple):
    TI: int  # rows i a block, a multiple of 4
    CG: int  # float4 columns of features a block
    row_tiles: int
    slices: int


class FusedPlan(NamedTuple):
    tile: TilePlan  # the score tiles (ops.gat_scores.tile_plan at fp32 rows)
    CG: int  # float4 columns of h a slice of the aggregation
    threads: int
    slices: int


def padded_width(D: int, multiple: int = 4) -> int:
    """D rounded up to a multiple of 4 (the fp32 projections' float4 loads)
    or of 8 (the bf16 instances' wgmma projections: rows 16 bytes apart for
    the TMA)."""
    return -(-D // multiple) * multiple


def alpha_stride(rows: int) -> int:
    """alpha^T's row stride in the fused kernel (`alpha_stride`): a tile's
    rows rounded up to 4, an odd number of float4s."""
    w = -(-rows // 4) * 4
    return w if (w // 4) % 2 else w + 4


def fused_smem_bytes(G: int, Dp: int, tile: TilePlan, CG: int) -> int:
    """Shared memory of a fused block (`fused_smem_floats`): a and k3, alpha^T
    [G][alpha_stride], and the staged slices of the scores or, after them,
    two slices of h [G][4 CG]."""
    return 4 * (2 * slice_span(Dp) + G * alpha_stride(tile.R * tile.TIb)) + max(
        tile_stage_bytes(tile), 4 * 2 * G * 4 * CG)


def fused_plan(G: int, D: int) -> FusedPlan:
    """The bf16 instances' fused step: the score tiles of
    `tile_plan` at fp32 rows (every column tile in one block, in turn), and
    the aggregation of the block's rows in groups of 4 a thread over D in
    the fewest slices of float4 columns that the block's threads cover, more
    while its shared memory would not fit. Raises ValueError for a graph too
    large for a block."""
    tile = tile_plan(G, 4)
    threads = tile_threads(tile.R, tile.TIb, tile.TJb, 4)
    groups = -(-tile.R * tile.TIb // 4)
    D4 = -(-D // 4)
    slices = -(-D4 // (threads // groups))
    while True:
        CG = -(-D4 // slices)
        if fused_smem_bytes(G, padded_width(D, 8), tile, CG) <= MAX_SMEM_BYTES:
            return FusedPlan(tile, CG, threads, -(-D4 // CG))
        if CG == 1:
            raise ValueError(f"interactive_gat_layer_fused: a graph of G={G} nodes needs "
                             f"{fused_smem_bytes(G, padded_width(D, 8), tile, 1)} B of shared "
                             f"memory in the fused step, more than the "
                             f"{MAX_SMEM_BYTES} B a block has")
        slices += 1


def attend_smem_bytes(G: int, TI: int, CG: int) -> int:
    """Shared memory of an attend block (`attend_smem_floats` in the C
    side): h's slice [G][4 CG] and alpha^T [G][TI]."""
    return 4 * G * (4 * CG + TI)


def attend_plan(G: int, D: int) -> AttendPlan:
    """The attend step's tiling: the fewest tiles of at most 32 rows, each a
    multiple of 4 as narrow as covers G; D in the fewest slices whose float4
    columns keep the block at <= 256 threads, more while its shared memory
    would not fit. Raises ValueError for a graph too large for a block of
    one float4 column."""
    row_tiles = math.ceil(G / MAX_ROWS)
    TI = 4 * math.ceil(math.ceil(G / row_tiles) / 4)
    D4 = math.ceil(D / 4)
    slices = math.ceil(D4 / (MAX_THREADS // (TI // 4)))
    while True:
        CG = math.ceil(D4 / slices)
        if attend_smem_bytes(G, TI, CG) <= MAX_SMEM_BYTES:
            return AttendPlan(TI, CG, row_tiles, math.ceil(D4 / CG))
        if CG == 1:
            raise ValueError(f"interactive_gat_layer_fused: a graph of G={G} nodes needs "
                             f"{attend_smem_bytes(G, TI, 1)} B of shared memory at 4 features "
                             f"a block, more than the {MAX_SMEM_BYTES} B a block has")
        slices += 1


def interactive_gat_layer_plain(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                negative_slope: float = 0.2):
    """Plain PyTorch version. x [B, G, D]; adj [B, G, G] bool; query [B, D];
    W, W1, W2, W3 [D, D] ([in, out] layout); bW, b3, a_vec [D]. Every
    product in fp32 at least (bf16 operands upcast), the result in x's
    dtype (a bf16 x: rounded once)."""
    out_dtype = x.dtype
    acc = torch.promote_types(functools.reduce(torch.promote_types, (
        t.dtype for t in (x, query, W, bW, W1, W2, W3, b3, a_vec))), torch.float32)
    x, query, W, bW, W1, W2, W3, b3, a_vec = (t.to(acc) for t in (
        x, query, W, bW, W1, W2, W3, b3, a_vec))
    h = x @ W + bW
    k1 = x @ W1
    k2 = x @ W2
    k3 = query @ W3 + b3
    s = interactive_gat_scores(k1, k2, k3, a_vec)
    e = torch.where(s > 0, s, negative_slope * s)
    e = torch.where(adj.to(torch.bool), e, torch.full_like(e, MASK_FILL))
    alpha = torch.softmax(e, dim=2)
    return (torch.relu(torch.einsum("bij,bjd->bid", alpha, h)) + x).to(out_dtype)


def stacked_weights(W, bW, W1, W2, W3, b3, a_vec, multiple: int = 4):
    """The weights as the kernels read them, each D padded with zeros to Dp
    (`padded_width(D, multiple)`): wy [3Dp, Dp] (W, W1, W2 stacked in
    nn.Linear layout, in their dtype), by [3Dp] ([bW | 0 | 0]), w3 [Dp, Dp],
    b3 [Dp] and a [Dp], the vectors in fp32 at least (bf16 ones upcast).
    W..W3 are given [in, out]."""
    D = W.shape[0]
    bW, b3, a_vec = (v.to(torch.promote_types(v.dtype, torch.float32)) for v in (bW, b3, a_vec))
    p = padded_width(D, multiple) - D
    lin = (lambda w: w.t()) if p == 0 else (lambda w: F.pad(w.t(), (0, p, 0, p)))
    vec = (lambda v: v) if p == 0 else (lambda v: F.pad(v, (0, p)))
    wy = torch.cat([lin(W), lin(W1), lin(W2)]).contiguous()
    by = torch.cat([vec(bW), torch.zeros(2 * (D + p), dtype=bW.dtype, device=bW.device)])
    return wy, by, lin(W3).contiguous(), vec(b3).contiguous(), vec(a_vec).contiguous()


def interactive_gat_layer_fused(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                negative_slope: float = 0.2):
    """Kernel B. Same arguments and result as `interactive_gat_layer_plain`.
    The kernels read W, W1 and W2 stacked [3D, D] in nn.Linear layout: the
    wrapper stacks them each call (1.92 MB at D 400, one copy on the
    device). Where D is not a multiple of 4 (of 8 with bf16 weights), x,
    query and the weights are padded with zeros to the next one (zero terms
    change no sum). Three instances: all fp32 (three launches: the 3xTF32
    projections, C's forward, the attend step); fp32 x and query with bf16
    weights (x's planes, the wgmma projections, the fused step on fp32 x);
    bf16 x, query and weights (the wgmma projections, the fused step on
    bf16 x, a bf16 result)."""
    if not build.use_kernel(x):
        return interactive_gat_layer_plain(x, adj, query, W, bW, W1, W2, W3, b3, a_vec,
                                           negative_slope)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, query, W, bW, W1, W2, W3, b3, a_vec)):
        raise RuntimeError("interactive_gat_layer_fused is the eval layer and passes no "
                           "gradient; the training layer runs Eq. (8) through "
                           "ops.gat_scores.interactive_gat_scores")
    B, G, D = x.shape
    xdt, wdt = x.dtype, W.dtype  # (fp32, fp32), (fp32, bf16) or (bf16, bf16)
    if (xdt, wdt) not in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                          (torch.bfloat16, torch.bfloat16)):
        raise TypeError(f"interactive_gat_layer_fused: x and the weights must be float32 and "
                        f"float32 or bfloat16, or both bfloat16, got {xdt} and {wdt}")
    if adj.dtype != torch.bool or tuple(adj.shape) != (B, G, G):
        raise TypeError(f"interactive_gat_layer_fused: adj must be bool [B, G, G], "
                        f"got {adj.dtype} {tuple(adj.shape)}")
    shapes = {"query": (query, (B, D)), "W": (W, (D, D)), "W1": (W1, (D, D)),
              "W2": (W2, (D, D)), "W3": (W3, (D, D)), "bW": (bW, (D,)), "b3": (b3, (D,)),
              "a_vec": (a_vec, (D,))}
    for name, (t, shape) in shapes.items():
        dtypes = (xdt,) if name == "query" or wdt == torch.float32 else \
            ((wdt,) if t.dim() == 2 else (wdt, torch.float32))
        if tuple(t.shape) != shape or t.dtype not in dtypes or t.device != x.device:
            raise ValueError(f"interactive_gat_layer_fused: {name} must be "
                             f"{' or '.join(map(str, dtypes))} {shape} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (x.is_contiguous() and adj.is_contiguous() and query.is_contiguous()):
        raise ValueError("interactive_gat_layer_fused: x, adj and query must be contiguous")
    if B == 0:
        return torch.empty_like(x)
    act = xdt == torch.bfloat16  # the bf16-activation instance
    wgmma = wdt == torch.bfloat16  # either bf16 instance: wgmma projections, the fused step
    Dp = padded_width(D, 8 if wgmma else 4)
    xk, qk = x.reshape(B * G, D), query
    if Dp != D or xk.data_ptr() % 16 or qk.data_ptr() % 16:
        xk, qk = F.pad(xk, (0, Dp - D)), F.pad(qk, (0, Dp - D))
    wy, by, w3, b3p, ap = stacked_weights(W, bW, W1, W2, W3, b3, a_vec, 8 if wgmma else 4)
    dev = x.device
    y = torch.empty((B * G, 3 * Dp), dtype=torch.float32, device=dev)
    k3 = torch.empty((B, Dp), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    what = "interactive_gat_layer_fused"
    if wgmma:
        plan = fused_plan(G, D)
        # the kernels read b3 and a by 16-byte loads
        b3p, ap = (v if v.data_ptr() % 16 == 0 else v.clone() for v in (b3p, ap))
        # x's and query's three bf16 planes (the bf16-weight instance)
        planes = None if act else torch.empty(3 * (B * G + B) * Dp, dtype=torch.bfloat16,
                                              device=dev)
        with build.launch_on(dev) as (lib, stream):
            ptrs = (xk.data_ptr(), qk.data_ptr(), wy.data_ptr(), by.data_ptr(), w3.data_ptr(),
                    b3p.data_ptr(), y.data_ptr(), k3.data_ptr())
            if act:
                build.check(lib, lib.gat_layer_project_bf16_act(*ptrs, B * G, B, Dp, stream),
                            what)
            else:
                build.check(lib, lib.gat_layer_project_bf16(*ptrs, planes.data_ptr(), B * G, B,
                                                            Dp, stream), what)
            t = plan.tile
            step = lib.gat_layer_fused_bf16 if act else lib.gat_layer_fused_f32
            build.check(lib, step(
                x.data_ptr(), adj.data_ptr(), y.data_ptr(), k3.data_ptr(), ap.data_ptr(),
                out.data_ptr(), B, G, D, Dp, t.R, t.TIb, t.TJb, plan.CG, float(negative_slope),
                stream), what)
        if act:
            interactive_gat_layer_fused.launches_bf16_act += 1
        else:
            interactive_gat_layer_fused.launches_bf16 += 1
        return out
    plan, splan = attend_plan(G, D), fwd_plan(G)
    s = torch.empty((B, G, G), dtype=torch.float32, device=dev)
    with build.launch_on(dev) as (lib, stream):
        build.check(lib, lib.gat_layer_project_f32(
            xk.data_ptr(), qk.data_ptr(), wy.data_ptr(), by.data_ptr(), w3.data_ptr(),
            b3p.data_ptr(), y.data_ptr(), k3.data_ptr(), B * G, B, Dp, stream), what)
        build.check(lib, lib.gat_scores_fwd_f32(
            y.data_ptr() + 4 * Dp, 3 * Dp, y.data_ptr() + 8 * Dp, 3 * Dp, k3.data_ptr(),
            ap.data_ptr(), s.data_ptr(), B, G, Dp, splan.R, splan.TIb, splan.TJb, stream), what)
        build.check(lib, lib.gat_layer_attend_f32(
            x.data_ptr(), adj.data_ptr(), s.data_ptr(), y.data_ptr(), 3 * Dp, out.data_ptr(), B,
            G, D, plan.TI, plan.CG, float(negative_slope), stream), what)
    interactive_gat_layer_fused.launches += 1
    return out


interactive_gat_layer_fused.launches = 0
interactive_gat_layer_fused.launches_bf16 = 0
interactive_gat_layer_fused.launches_bf16_act = 0
