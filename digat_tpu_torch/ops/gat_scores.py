"""Eq. (8) interactive graph-attention scores with their gradient (kernel C).

    score[b, i, j] = a . relu(k1[b, j] + k2[b, i] + k3[b])

Replaces `digat_tpu/ops/pallas/gat_scores.py::interactive_gat_scores_pallas`
(`_scores_kernel`, and the custom-VJP backward `_bwd_kernel`). The training
GAT layer calls `interactive_gat_scores`, an autograd Function: its forward
is `gat_scores_fwd` and its backward `gat_scores_bwd`, which give

    gk1[b, j] = a * sum_i g[b, i, j] m[b, i, j]
    gk2[b, i] = a * sum_j g[b, i, j] m[b, i, j]
    gk3[b]    = sum_i gk2[b, i]
    ga        = sum_b sum_ij g[b, i, j] relu(k1[b, j] + k2[b, i] + k3[b])

with m the relu mask, recomputed and never stored. On a CPU tensor both
run their plain versions, `interactive_gat_scores_plain` (the chunked
expression of `ops.gat`) and `interactive_gat_scores_bwd_plain` (the same
sums, chunked the same way: autograd through the plain forward would keep
the [chunk, G, G, D] intermediates). On a CUDA tensor they launch
`csrc/gat_scores.cu` or raise. k1 and k2 may be column blocks of the fused
projection y [B, G, 3D]; the kernel reads them in place. The training GAT
layer passes y itself to `interactive_gat_scores_fused_y`, the counterpart
of `interactive_gat_scores_fused_y_pallas` (C', whose backward reuses C's).

The kernels' launch plans are made here and passed to the C side, which
checks them: `fwd_plan` (register tiles of R x R scores a thread, the
threads' tiles of a block) and `bwd_plan` (tiles of JT columns held in
registers, blocks of DT features). `tests/test_torch_gat_scores_tiles.py`
replays the kernels' order of work from these plans on the CPU.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from digat_tpu_torch.ops import build, gat
from digat_tpu_torch.ops.gat import interactive_gat_scores as interactive_gat_scores_plain
from digat_tpu_torch.ops.msa_attention import MAX_SMEM_BYTES

SLICE = 32  # features of one forward slice (kDS in csrc/gat_scores.cu)
MAX_FWD_THREADS = 512  # a forward block
MAX_BWD_THREADS = 256  # a backward block: one slice of D
MAX_JT = 40  # backward columns j a thread holds in registers


class FwdPlan(NamedTuple):
    R: int  # a thread's tile: R x R scores
    TIb: int  # threads' tiles along i in a block
    TJb: int  # threads' tiles along j in a block
    row_blocks: int
    col_blocks: int


class BwdPlan(NamedTuple):
    ntiles: int  # tiles of JT columns j, walked in order
    JT: int
    DT: int  # features (threads) a block
    slices: int  # blocks of DT features over D


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def fwd_plan(G: int) -> FwdPlan:
    """The forward's tiling of one graph: R 4 where the graph has at least
    128 tiles of 4 x 4, else R 2; a block takes up to 32 threads' tiles
    along j and as many rows as keep it at <= 512 threads."""
    R = 4 if math.ceil(G / 4) ** 2 >= 128 else 2
    TI = math.ceil(G / R)
    TJb = math.ceil(TI / math.ceil(TI / 32))
    nbi = math.ceil(TI * TJb / MAX_FWD_THREADS)
    while _round32(math.ceil(TI / nbi) * TJb) > MAX_FWD_THREADS:
        nbi += 1
    TIb = math.ceil(TI / nbi)
    return FwdPlan(R, TIb, TJb, math.ceil(TI / TIb), math.ceil(TI / TJb))


def _slice_stride(w: int) -> int:
    return w if (w // 4) % 2 else w + 4


def fwd_smem_bytes(plan: FwdPlan) -> int:
    """Shared memory of a forward block (`fwd_smem_floats` in the C side):
    one slice of k2 + k3 and of k1, transposed, and of a."""
    return 4 * (SLICE * (_slice_stride(plan.TIb * plan.R) + _slice_stride(plan.TJb * plan.R))
                + SLICE)


def bwd_smem_bytes(G: int, JT: int, DT: int, ntiles: int) -> int:
    """Shared memory of a backward block (`bwd_smem_floats`): the tile's
    columns of g, and the rows' running sums where there are several tiles."""
    return 4 * (G * JT + (G * DT if ntiles > 1 else 0))


def bwd_plan(G: int, D: int) -> BwdPlan:
    """The backward's plan: the fewest tiles of at most 40 columns, each as
    narrow as covers G (a multiple of 4); D in the fewest slices of at most
    256 features (more while the block's shared memory would not fit).
    Raises ValueError for a graph too large for a block of 32 features."""
    ntiles = math.ceil(G / MAX_JT)
    JT = 4 * math.ceil(math.ceil(G / ntiles) / 4)
    slices = math.ceil(D / MAX_BWD_THREADS)
    while True:
        DT = _round32(math.ceil(D / slices))
        if bwd_smem_bytes(G, JT, DT, ntiles) <= MAX_SMEM_BYTES:
            return BwdPlan(ntiles, JT, DT, math.ceil(D / DT))
        if DT == 32:
            raise ValueError(f"gat_scores_bwd: a graph of G={G} nodes needs "
                             f"{bwd_smem_bytes(G, JT, DT, ntiles)} B of shared memory at 32 "
                             f"features a block, more than the {MAX_SMEM_BYTES} B a block has")
        slices += 1


def interactive_gat_scores_bwd_plain(k1, k2, k3, a_vec, g):
    """Plain PyTorch backward of Eq. (8): (gk1, gk2, gk3, ga), over batch
    chunks that keep [chunk, G, G, D] under `ops.gat._MAX_ELEMENTS`, with
    the sum formed in the order of `ops.gat` and the kernels."""
    B, G, D = k1.shape
    step = max(1, gat._MAX_ELEMENTS // (G * G * D))
    gk1, gk2 = [], []
    ga = torch.zeros_like(a_vec)
    for s in range(0, B, step):
        t = k1[s:s + step, None, :, :] + (k2[s:s + step, :, None, :]
                                          + k3[s:s + step, None, None, :])
        gs = g[s:s + step, :, :, None]
        w = torch.where(t > 0, gs, torch.zeros((), dtype=t.dtype, device=t.device))
        gk1.append(w.sum(dim=1) * a_vec)
        gk2.append(w.sum(dim=2) * a_vec)
        ga = ga + (gs * torch.relu(t)).sum(dim=(0, 1, 2))
    gk1 = torch.cat(gk1) if len(gk1) > 1 else gk1[0]
    gk2 = torch.cat(gk2) if len(gk2) > 1 else gk2[0]
    return gk1, gk2, gk2.sum(dim=1), ga


def _rows(k, G):
    """(k with unit column stride and graph stride G rows, its row stride)."""
    if k.stride(2) != 1 or k.stride(0) != G * k.stride(1):
        k = k.contiguous()
    return k, k.stride(1)


def _check(k1, k2, k3, a_vec, what):
    B, G, D = k1.shape
    shapes = {"k1": (k1, (B, G, D)), "k2": (k2, (B, G, D)), "k3": (k3, (B, D)),
              "a_vec": (a_vec, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != k1.device:
            raise ValueError(f"{what}: {name} must be float32 {shape} on {k1.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    return B, G, D


def gat_scores_fwd(k1, k2, k3, a_vec):
    """Kernel C, forward -> [B, G, G]."""
    if not build.use_kernel(k1):
        return interactive_gat_scores_plain(k1, k2, k3, a_vec)
    B, G, D = _check(k1, k2, k3, a_vec, "gat_scores_fwd")
    out = torch.empty((B, G, G), dtype=torch.float32, device=k1.device)
    if B == 0:
        return out
    (k1, ld1), (k2, ld2) = _rows(k1, G), _rows(k2, G)
    k3, a_vec = k3.contiguous(), a_vec.contiguous()
    plan = fwd_plan(G)
    with build.launch_on(k1.device) as (lib, stream):
        err = lib.gat_scores_fwd_f32(k1.data_ptr(), ld1, k2.data_ptr(), ld2, k3.data_ptr(),
                                     a_vec.data_ptr(), out.data_ptr(), B, G, D, plan.R,
                                     plan.TIb, plan.TJb, stream)
    build.check(lib, err, "gat_scores_fwd")
    gat_scores_fwd.launches += 1
    return out


def gat_scores_bwd(k1, k2, k3, a_vec, g):
    """Kernel C, backward -> (gk1, gk2, gk3, ga)."""
    if not build.use_kernel(k1):
        return interactive_gat_scores_bwd_plain(k1, k2, k3, a_vec, g)
    B, G, D = _check(k1, k2, k3, a_vec, "gat_scores_bwd")
    if tuple(g.shape) != (B, G, G) or g.dtype != torch.float32:
        raise ValueError(f"gat_scores_bwd: g must be float32 [{B}, {G}, {G}], got {g.dtype} "
                         f"{tuple(g.shape)}")
    plan = bwd_plan(G, D)
    dev = k1.device
    gk1 = torch.empty((B, G, D), dtype=torch.float32, device=dev)
    gk2 = torch.empty((B, G, D), dtype=torch.float32, device=dev)
    gk3 = torch.empty((B, D), dtype=torch.float32, device=dev)
    ga = torch.zeros(D, dtype=torch.float32, device=dev)
    if B == 0:
        return gk1, gk2, gk3, ga
    ga_part = torch.empty((B, D), dtype=torch.float32, device=dev)
    (k1, ld1), (k2, ld2) = _rows(k1, G), _rows(k2, G)
    k3, a_vec, g = k3.contiguous(), a_vec.contiguous(), g.contiguous()
    with build.launch_on(dev) as (lib, stream):
        err = lib.gat_scores_bwd_f32(k1.data_ptr(), ld1, k2.data_ptr(), ld2, k3.data_ptr(),
                                     a_vec.data_ptr(), g.data_ptr(), gk1.data_ptr(),
                                     gk2.data_ptr(), gk3.data_ptr(), ga.data_ptr(),
                                     ga_part.data_ptr(), B, G, D, plan.ntiles, plan.JT, plan.DT,
                                     stream)
    build.check(lib, err, "gat_scores_bwd")
    gat_scores_bwd.launches += 1
    return gk1, gk2, gk3, ga


class InteractiveGATScores(torch.autograd.Function):
    """Eq. (8) scores: kernel C forward and backward (plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, k1, k2, k3, a_vec):
        ctx.save_for_backward(k1, k2, k3, a_vec)
        return gat_scores_fwd(k1, k2, k3, a_vec)

    @staticmethod
    def backward(ctx, g):
        return gat_scores_bwd(*ctx.saved_tensors, g.contiguous())


def interactive_gat_scores(k1, k2, k3, a_vec):
    """k1, k2 [B, G, D]; k3 [B, D]; a_vec [D] -> [B, G, G] logits (before
    leaky ReLU and mask), differentiable in all four."""
    return InteractiveGATScores.apply(k1, k2, k3, a_vec)


class InteractiveGATScoresFusedY(torch.autograd.Function):
    """Eq. (8) scores read from the fused projection y (C'): kernel C
    forward and backward on y's k1 and k2 column blocks, in place."""

    @staticmethod
    def forward(ctx, y, k3, a_vec):
        ctx.save_for_backward(y, k3, a_vec)
        D = y.shape[-1] // 3
        return gat_scores_fwd(y[..., D:2 * D], y[..., 2 * D:], k3, a_vec)

    @staticmethod
    def backward(ctx, g):
        y, k3, a_vec = ctx.saved_tensors
        D = y.shape[-1] // 3
        gk1, gk2, gk3, ga = gat_scores_bwd(y[..., D:2 * D], y[..., 2 * D:], k3, a_vec,
                                           g.contiguous())
        return torch.cat([torch.zeros_like(gk1), gk1, gk2], dim=-1), gk3, ga


def interactive_gat_scores_fused_y(y, k3, a_vec):
    """Replaces `interactive_gat_scores_fused_y_pallas` (C'). y [B, G, 3D] =
    x [W|W1|W2], so k1 is its middle column block and k2 its last; k3
    [B, D]; a_vec [D] -> [B, G, G]. Its gradient into y is [0 | gk1 | gk2].
    On the CPU the plain versions run on the slices of y. A bf16 a_vec (the
    compute copy at `compute_dtype` bfloat16) is upcast to y's dtype, which
    is exact; its gradient comes back rounded to bf16."""
    return InteractiveGATScoresFusedY.apply(y, k3, a_vec.to(y.dtype))


gat_scores_fwd.launches = 0
gat_scores_bwd.launches = 0
