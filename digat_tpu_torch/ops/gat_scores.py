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

The ReLU kink. Where k1 + k2 + k3 lies within rounding of 0 the mask m,
and with it a whole a g term of the gradients, would depend on the order
of the sums (the TPU kernel sums (k1 + k3) + k2, the XLA path (k1 + k2) +
k3). The plain backward decides the mask of any t with |t| <= KINK_TOL
(|k1| + |k2| + |k3|), a band it bounds by the chunk's largest magnitudes,
by the float64 sum k1 + (k2 + k3) of its inputs (`relu_mask`); outside
that band the fp32 sum has the exact sum's sign in any order. The kernel takes the same side at no cost a term: its fp32 t =
k1 + fl(k2 + k3) can miss the exact sign only where t == +0, and there it
takes the sign of fl(k2 + k3)'s rounding error, formed once a row
(csrc/gat_scores.cu; `tests/test_torch_bf16_pair.py` replays its rule).

bf16 (`compute_dtype` bfloat16, bf16 activations: CNN-DIGAT). The forward
takes bf16 k1, k2, k3 and a and returns bf16 scores, its math in fp32 (the
kernel's bf16 instance `gat_scores_fwd_bf16`, counted on
`gat_scores_fwd.launches_bf16`; the plain version upcasts and rounds once),
as the TPU kernel does. Its kernel is the register tile of
`csrc/gat_score_tile.cuh`, which kernel B's bf16-activation instance shares
(each score as (P[j] + Q[i] + sum_d a |k1 + k2 + k3|) / 2, P and Q the
a-weighted sums of k1's and of k2 + k3's rows: two instructions an element):
`tile_plan` cuts a graph into blocks of rows (at least two here) and
columns, and the rows are copied by 16-byte vectors of eight bf16 where
`bf16_vector_copies` allows it (element by element otherwise). The
backward upcasts its inputs to fp32, runs the fp32 backward and casts the
gradients back to the inputs' dtypes, as the JAX package's custom VJP does
around its kernel.

The kernels' launch plans are made here and passed to the C side, which
checks them: `fwd_plan` (register tiles of R x R scores a thread, the
threads' tiles of a block), `tile_plan` (the bf16 forward's and kernel B's
bf16-activation tiles) and `bwd_plan` (tiles of JT columns held in
registers, blocks of DT features). `tests/test_torch_gat_scores_tiles.py`
and `tests/test_torch_gat_bf16_tiles.py` replay the kernels' order of work
from these plans on the CPU.
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
# the register tiles of csrc/gat_score_tile.cuh (the bf16 forward, kernel B's
# bf16-activation instance)
TILE_THREADS = 320  # a block (kMaxThreads)
TILE_SLICE = 32  # features of one staged slice (kSlice)
TILE_ROW = 36  # floats of a staged row (kRow)
TILE_PRE = 4  # 16-byte chunks a thread holds in flight (kMaxPre)
TILE_COLS = 24  # threads' tiles along j in a block at most
# the relative band around the ReLU's kink where the plain backward's mask
# is the float64 sum's: 8 times the largest fp32 error of a sum of three,
# 2^-23 (|k1| + |k2| + |k3|), in any order
KINK_TOL = 1e-6


class FwdPlan(NamedTuple):
    R: int  # a thread's tile: R x R scores
    TIb: int  # threads' tiles along i in a block
    TJb: int  # threads' tiles along j in a block
    row_blocks: int
    col_blocks: int


class TilePlan(NamedTuple):
    R: int  # a thread's tile: R x R scores, rows ti + q TIb, columns tj + r TJb
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


def tile_threads(R: int, TIb: int, TJb: int, itemsize: int) -> int:
    """Threads of a block of `csrc/gat_score_tile.cuh` (`tile_threads`): one
    a thread's tile, and enough to hold a slice's 16-byte chunks of its R TIb
    rows and R TJb columns (elements of `itemsize` bytes) TILE_PRE at a time;
    a multiple of 32."""
    chunks = R * (TIb + TJb) * (TILE_SLICE * itemsize // 16)
    return _round32(max(TIb * TJb, math.ceil(chunks / TILE_PRE)))


def tile_plan(G: int, itemsize: int, min_row_blocks: int = 1) -> TilePlan:
    """The register tiles of a graph of G nodes, rows of `itemsize` bytes a
    feature: R 4 where the graph has at least 128 tiles of 4 x 4, else R 2;
    the columns in the fewest blocks of at most TILE_COLS threads' tiles,
    the rows in at least `min_row_blocks` blocks (if the graph has that many
    rows of tiles), more while the block would pass TILE_THREADS."""
    R = 4 if math.ceil(G / 4) ** 2 >= 128 else 2
    TI = math.ceil(G / R)
    col_blocks = math.ceil(TI / TILE_COLS)
    TJb = math.ceil(TI / col_blocks)
    n = min(min_row_blocks, TI)
    while tile_threads(R, math.ceil(TI / n), TJb, itemsize) > TILE_THREADS:
        n += 1
    TIb = math.ceil(TI / n)
    return TilePlan(R, TIb, TJb, math.ceil(TI / TIb), col_blocks)


def slice_span(D: int) -> int:
    """D rounded up to whole slices: the staged a and k3 (`slice_span`)."""
    return math.ceil(D / TILE_SLICE) * TILE_SLICE


def tile_stage_bytes(plan: TilePlan) -> int:
    """Shared memory of the two staged slices of a block's tile
    (`stage_floats`): c's R TIb rows and k1's R TJb, TILE_ROW floats each,
    and each row's a-weighted sum (Q, P), rounded up to float4s."""
    rows = plan.R * (plan.TIb + plan.TJb)
    return 4 * (2 * rows * TILE_ROW + -(-rows // 4) * 4)


def fwd_bf16_smem_bytes(plan: TilePlan, D: int) -> int:
    """Shared memory of a block of the bf16 forward: a and k3 as fp32, and
    the staged slices."""
    return 4 * 2 * slice_span(D) + tile_stage_bytes(plan)


def bf16_vector_copies(pointers, ld1: int, ld2: int, D: int) -> bool:
    """The copy rule of the bf16 forward (the C side decides the same): 16-byte
    vectors of eight bf16 where D and both row strides are multiples of 8 and
    k1 and k2 (`data_ptr()`) are 16-byte aligned, element copies otherwise."""
    return D % 8 == 0 and ld1 % 8 == 0 and ld2 % 8 == 0 and all(p % 16 == 0 for p in pointers)


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


def relu_mask(k1, k2, k3, t):
    """t > 0 for t = k1 + (k2 + k3) ([chunk, G, G, D], k1 indexed by j, k2 by
    i; k1 [chunk, G, D], k2 [chunk, G, D], k3 [chunk, D]), except where |t|
    <= KINK_TOL (max |k1| + max |k2| + max |k3|) over the chunk, a band at
    least as wide as each term's own: there the sign of the float64 sum
    k1 + (k2 + k3), the side the kernel takes."""
    m = t > 0
    band = KINK_TOL * sum(float(k.abs().max()) if k.numel() else 0.0 for k in (k1, k2, k3))
    near = t.abs() <= band
    if bool(near.any()):
        b, i, j, d = near.nonzero(as_tuple=True)
        wide = torch.promote_types(t.dtype, torch.float64)
        exact = k1[b, j, d].to(wide) + (k2[b, i, d].to(wide) + k3[b, d].to(wide))
        m[b, i, j, d] = exact > 0
    return m


def interactive_gat_scores_bwd_plain(k1, k2, k3, a_vec, g):
    """Plain PyTorch backward of Eq. (8): (gk1, gk2, gk3, ga), over batch
    chunks that keep [chunk, G, G, D] under `ops.gat._MAX_ELEMENTS`, with
    the sum formed in the order of `ops.gat` and the kernels and the mask at
    the kink taken from `relu_mask`."""
    B, G, D = k1.shape
    step = max(1, gat._MAX_ELEMENTS // (G * G * D))
    gk1, gk2 = [], []
    ga = torch.zeros_like(a_vec)
    for s in range(0, B, step):
        t = k1[s:s + step, None, :, :] + (k2[s:s + step, :, None, :]
                                          + k3[s:s + step, None, None, :])
        gs = g[s:s + step, :, :, None]
        m = relu_mask(k1[s:s + step], k2[s:s + step], k3[s:s + step], t)
        w = torch.where(m, gs, torch.zeros((), dtype=t.dtype, device=t.device))
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


def _check(k1, k2, k3, a_vec, what, dtypes=(torch.float32,)):
    B, G, D = k1.shape
    shapes = {"k1": (k1, (B, G, D)), "k2": (k2, (B, G, D)), "k3": (k3, (B, D)),
              "a_vec": (a_vec, (D,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != k1.dtype or t.dtype not in dtypes or \
                t.device != k1.device:
            raise ValueError(f"{what}: {name} must be {' or '.join(map(str, dtypes))} {shape} "
                             f"(all one dtype) on {k1.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    return B, G, D


def gat_scores_fwd_plain(k1, k2, k3, a_vec):
    """Plain PyTorch version of the forward: the chunked expression of
    `ops.gat`; bf16 inputs upcast to fp32 and the scores rounded once."""
    if k1.dtype == torch.bfloat16:
        return interactive_gat_scores_plain(k1.float(), k2.float(), k3.float(),
                                            a_vec.float()).to(k1.dtype)
    return interactive_gat_scores_plain(k1, k2, k3, a_vec)


def gat_scores_fwd(k1, k2, k3, a_vec):
    """Kernel C, forward -> [B, G, G] in the inputs' dtype (fp32, or bf16 by
    its bf16 instance)."""
    if not build.use_kernel(k1):
        return gat_scores_fwd_plain(k1, k2, k3, a_vec)
    B, G, D = _check(k1, k2, k3, a_vec, "gat_scores_fwd", (torch.float32, torch.bfloat16))
    out = torch.empty((B, G, G), dtype=k1.dtype, device=k1.device)
    if B == 0:
        return out
    (k1, ld1), (k2, ld2) = _rows(k1, G), _rows(k2, G)
    k3, a_vec = k3.contiguous(), a_vec.contiguous()
    bf16 = k1.dtype == torch.bfloat16
    plan = tile_plan(G, 2, min_row_blocks=2) if bf16 else fwd_plan(G)
    with build.launch_on(k1.device) as (lib, stream):
        fn = lib.gat_scores_fwd_bf16 if bf16 else lib.gat_scores_fwd_f32
        err = fn(k1.data_ptr(), ld1, k2.data_ptr(), ld2, k3.data_ptr(), a_vec.data_ptr(),
                 out.data_ptr(), B, G, D, plan.R, plan.TIb, plan.TJb, stream)
    build.check(lib, err, "gat_scores_fwd")
    if bf16:
        gat_scores_fwd.launches_bf16 += 1
    else:
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


def gat_scores_bwd_any(k1, k2, k3, a_vec, g):
    """The backward for inputs of any dtype the forward takes: bf16 ones
    upcast to fp32 for `gat_scores_bwd` and its gradients cast back to each
    input's dtype, as the JAX package's custom VJP does."""
    if k1.dtype != torch.bfloat16:
        return gat_scores_bwd(k1, k2, k3, a_vec, g.contiguous())
    gk1, gk2, gk3, ga = gat_scores_bwd(k1.float(), k2.float(), k3.float(), a_vec.float(),
                                       g.float().contiguous())
    return gk1.to(k1.dtype), gk2.to(k2.dtype), gk3.to(k3.dtype), ga.to(a_vec.dtype)


class InteractiveGATScores(torch.autograd.Function):
    """Eq. (8) scores: kernel C forward and backward (plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, k1, k2, k3, a_vec):
        ctx.save_for_backward(k1, k2, k3, a_vec)
        return gat_scores_fwd(k1, k2, k3, a_vec)

    @staticmethod
    def backward(ctx, g):
        return gat_scores_bwd_any(*ctx.saved_tensors, g)


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
        gk1, gk2, gk3, ga = gat_scores_bwd_any(y[..., D:2 * D], y[..., 2 * D:], k3, a_vec, g)
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
gat_scores_fwd.launches_bf16 = 0  # the bf16 instance
gat_scores_bwd.launches = 0
