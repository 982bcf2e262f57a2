#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (digat_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `digat_tpu_torch/csrc` (one nvcc call)
and, beside them in a thread, its host loader (`digat_tpu_torch/native`,
g++), and drives the production MSA-DIGAT model (full width: 300-d words, L 32,
16 x 25 heads, depth 3, Gn 26, Gu 68; random weights from a seed) and the
production NRMS-SA model (300-d words, L 32, 20 x 20 heads, history 50,
M 10 augmented neighbours) on a seeded 20,000-news corpus along the port's
paths:

  serving  - kernels A and B against their plain versions at the serving
             shapes (A and B with their device ms by launch and their bounds
             on two lines, fp32 CUDA cores and their products at 3xTF32; B
             on graphs of 6, 26, 68 and 96 nodes and at a D not a multiple
             of 4), the two-stage cached scorer with the launch counters
             reset (stage 1 must run A, stage 2 B), and a smaller corpus
             scored on the card against the plain path on the CPU;
  training - kernels A'' (the fused dropout forward and backward, and the
             keep mask, bit for bit at every graph dropout site, beside
             torch's own dropout), A with dropout, A' (encoder backward: its
             bound on two lines, fp32 CUDA cores and its products at 3xTF32,
             the same bits twice for every output), C (Eq. 8 scores forward
             and backward, the same bits twice for every output) and D
             (embedding gradient, on the uniform token stream and on the pad
             stream, each beside embedding_dense_backward) against their
             plain versions at the training shapes, with A's, A''s, C's and
             D's device ms by launch (torch.profiler), ptxas's registers and
             spills of their kernels and B's, and a cuobjdump check that the
             products of A, A' and B issue TF32 tensor-core instructions; one
             epoch of `Trainer` (>= 20 steps at B 64, unique-title dedup,
             dropout 0.2) with the launch counters reset, whose launches per
             step are checked; and three steps at B 8 on the card against
             the CPU (the CPU taking the card's side at each ReLU kink of
             Eq. 8, the kinks counted);
  NRMS-SA  - the masked attention pair (forward and backward, standing in
             for TPU kernels E and F) against its plain version at the
             serving and training shapes, packed and head-padded, timed
             beside scaled_dot_product_attention (forward, backward alone,
             both) and by its C entry points alone, with ptxas's registers
             and spills for every instantiation of the pair; the dual
             cached scorer with the counters reset (one forward launch per
             stage-1 chunk and per stage-2 batch) and card against CPU; one
             `Trainer` epoch (>= 10 steps at B 64, no dedup, dropout 0.2:
             4 forward and 4 backward attention launches and 7 dropouts,
             forward and backward, per step); and three steps at B 8 on the
             card against the CPU;
  titles   - kernels A and A' at titles shorter than 32: L 16 at the parity
             matrix's widths (Din 100, 10 x 20 heads, A 64, N 4,096) and
             L 7 at the production widths, title 0 all pad, against their
             plain versions (in phases 3 and 7); and past the short unit
             (phase 16): L 48, 64 and 128 at the production widths and
             heads of dk 128, with A's and A''s device ms by launch at
             L 128; the attention pair's wide instance (dk 65-128,
             `csrc/msa_attention_wide.cu`: at 4 x 128 heads and L 32,
             2 x 128 and L 160, 4 x 80 and L 64, and the titles of an
             NRMS-SA 4 x 100 training step, fp32 in phase 10 and bf16 in
             phase 21, beside SDPA, its backward's three launches by
             stage at L 160, its own kernels-line entries) and, in phase
             24, NRMS-SA at 4 x 100 heads (D 400), fp32 and bf16: the
             cached scorer over 1,024 news and one B-8 training step card
             against CPU, the wide launches counted; titles of L 160 through the news
             encoder (phase 17: the attention pair, its launches counted,
             card against CPU);
  ablations- the five DIGAT ablations (wo_SA, Seq_SA, wo_interaction,
             news_graph_wo_inter, user_graph_wo_inter) and CNN-DIGAT
             (cnn_kernel_num 400, naive, window 3) at full width (phase
             18), each: serving over 1,024 news on the card with the
             counters reset (A per chunk for MSA, B per interactive layer
             and batch) and against the CPU and one B-8 training step
             card against CPU, both at graph depth 2; 5 untraced steps at
             B 64 (depth 3, dedup, dropout 0.2) with
             the counters reset, their launches per step and dropout sites
             checked, and the median step time;
  bf16     - phase 20, MSA-DIGAT at compute_dtype bfloat16 (bf16 compute
             copies of the fp32 weights): the bf16 instances of A (N 1,024
             serving; N of the dedup capacity with dropout 0.2), A' (that N,
             dropout 0.2; its dx bf16, within one bf16 ulp of the plain
             element plus the bound) and B (bf16 weights, B 1,024 at G 68
             and 26: x's three bf16 planes, the wgmma projections, the
             fused step on fp32 x) against their plain versions, the same
             bits twice, each with its bound (the bf16 x bf16 product at
             the dense bf16 rate; A''s products at their wgmma bf16 passes;
             B's by issue, its projections at three bf16 passes, the
             fp32-rate figure beside it) and the SASS check that A's two,
             A''s seven and B's two wgmma products issue HGMMA; A's (at
             both N), A''s and B's stage split (A's and A''s with each
             product's rate; B's with no launch of C's forward or the
             attend step); the
             cached scorer over the corpus with the counters reset (stage 1
             A's bf16 instance, stage 2 B's, no fp32 launch of either) and a
             2,048-news corpus card against CPU; three B-8 steps card against
             CPU (each step-1 gradient within max(1e-3 * max |cpu|, one bf16
             ulp of the element)); one Trainer epoch at B 64 (dedup, dropout
             0.2) with its launches per step checked, its median step beside
             phase 8's;
  bf16 more- phase 21, the other models at compute_dtype bfloat16: the bf16
             instances of the attention pair (the NRMS title shapes, the
             serving chunk and the user batch, [256, 160, 16 x 25] and the
             wide instance at dk 80 and 128, forward and backward, SDPA on
             the same bf16 inputs beside it), A'' (bit for bit at the NRMS
             and CNN word sites and the CNN bank's, forward and backward,
             F.dropout beside it), B with bf16 activations (B 1,024 at G 68
             and 26) and C's forward (B 320 at G 68 and 26) against their
             plain versions, the same bits twice, each one's launches at G
             68 with their device ms, and its bound by issue beside the
             FLOP-rate one; then NRMS-SA, NRMS, CNN-DIGAT and MSA-DIGAT at
             titles of L 160 (the DIGAT models at graph depth 2, CNN-DIGAT
             with a GloVe-scale word table, L 160 on a SAG of 10 nodes),
             each: the cached scorer over 1,024 news with the counters reset
             (only the bf16 instances where the JAX package runs bf16, the
             fp32 pair for the NRMS user tower) and card against CPU
             (within one bf16 ulp of the score scale); B-8 steps card
             against CPU, three for the NRMS models and two for the DIGAT
             ones, whose CPU side takes 8-20 s a step (phase 20's gates,
             every tensor at one bf16 ulp of its largest element; for the
             DIGAT models also a control run with k3 left out of C's
             backward, which must fail that gate);
             5 untraced steps at B 64 with their
             launches per step and the shapes of A''s sites checked;
  DP       - phase 22, data parallelism (`parallel.dist`): MSA-DIGAT (B 64,
             depth 3, dedup per shard) and NRMS-SA stepped by two ranks on
             the card over gloo (child processes of this script with
             torchrun's environment; NCCL refuses two ranks on one device)
             against one process stepping the same global batches from the
             same weights, the ranks' row groups in turn: three steps at
             dropout 0 (each loss within 1e-5 relative, each step-1
             gradient within 1e-4 of its tensor's max, whether the forward
             logits are bit-identical; against the whole batch in one pass,
             which sees a row split that drops or repeats rows, each loss
             within 1e-5 relative and the logits within 2e-6 of their
             max); the step-1 gradients of the one pass and of the two
             ranks each against the same step on the CPU (the CPU taking
             the one pass's side at every kink; each within 1e-3 of its
             tensor's max, the entries beyond 1e-4 of it counted, and the
             kinks where the ranks' rows took the other side counted),
             then
             three at 0.2 with each rank's launches of A, A', A'', C and D
             checked and its step time (both ranks share the card: not a
             scaling number); both sharded scorers over 1,024 news against
             one process (within 1e-6 of the score scale, the same ranks,
             B and the pair launched on each rank), their stage times; the
             all-reduce of a step's gradients timed at gloo world 2 and at
             NCCL world 1. Then the same two ranks as a 1 x 2 grid over the
             same gloo world (`parallel.dist.make_grid`, `--mesh_model` 2:
             each rank the whole batch and rows 0-19,999 or 20,000-39,999
             of the V 40,000 word table, `parallel.sharded_table`): the
             MSA-DIGAT steps against the one process's, three at dropout 0
             (each loss within 1e-5 relative, each step-1 gradient within
             1e-4 of its tensor's max with the table's put together from
             the shards, whether the forward logits are bit-identical;
             step 1 against the CPU reference above at 1e-3, its entries
             beyond 1e-4 counted, and the kinks where the grid took
             another side than the card's one pass counted by digests of
             each call's mask) and three at 0.2 (the one process's seeds:
             the ranks of a model group draw one mask; losses within
             1e-5), each rank's launches checked (D once a step on its
             own rows; A, A', A'' and C as in the data-parallel leg); one
             NRMS-SA step against one process; both scorers over 1,024
             news after the table's gather against one process (1e-6 of
             the score scale, the same ranks); the lookups' all-reduce
             bytes and ms at gloo world 2 and each rank's table and
             moment MB. Phase 7 holds D on rows 20,000-39,999 of V
             40,000 (the uniform and the pad stream) against its plain
             version;
  slice 13 - phase 23: the MPNet sentence encoder at all-mpnet-base-v2's
             widths (random weights from the seed at HuggingFace's initial
             law, a tokenizer double): 16 texts at max_length 128 card
             against CPU (within 1e-4 of the unit-norm embeddings), then
             4,096 texts at batch 256 (texts/s, ms a batch beside its
             bound); the `jax_mpnet` embedder through the SAG miner on 128
             news in 4 categories, card against CPU (lists differ only at
             near-ties); every `layers_ext` module at B 64, N 26 and 68,
             D 400, forward and backward, the graph modules in training
             at dropout 0.2, card against CPU (outputs 1e-4, gradients
             1e-3, kinks replayed), A'' launches counted; and phase 22's
             one-pass step with `sorted_emb_grad=False` (the library's
             scatter-add word gradient), against the CPU at phase 9's
             gates, D launched no time, the word table's gradient within
             1e-4 of the D step's;
  CLI      - `digat_tpu_torch.cli` from MIND-layout TSV files that the
             port's generator writes, prepared through the native host
             loader (the GloVe file, behaviors.tsv and the SAG's BFS in
             `native/loader.cpp`; phase 14's train run with torchrun's
             environment of one rank: `init_distributed`, NCCL at world 1,
             the data-parallel step): the production cell of
             scripts/torch_parity_cells.py (word 300, L 32, 16 x 25 heads,
             B 32, lr 1e-3, 5 of its 6 epochs, dedup; its news graph mined on the
             card against the CPU; the loader's three results on the cell's
             own files, its GloVe file, each split's behaviors.tsv and the
             BFS over the lists mined on the CPU, equal to its plain Python
             versions', each with its native and plain host seconds) with a
             best dev AUC of at least 0.55, and the matrix cell at L 16 (B
             32, lr 1e-3, 4 of its 8 epochs) with at least 0.66, and the
             matrix cell of wo_interaction (phase 19, 5 of its 8 epochs)
             with at least 0.6675 (the JAX mean 0.6951 less 3 sigma); each
             epoch's rank file through the official scorer, and best.ckpt
             scored again by `--mode test`.

Prints progress lines, the card's name and power limit, a `kernels` JSON
line, and as its last line `{"ok": true, "device": {...}}`. Exits nonzero,
without that line, if CUDA is missing, the package is missing, any phase
fails, or the run passes the watchdog. Imports nothing of JAX or of the
JAX package; writes nothing but the build directory (kernels and loader) and a
temporary directory it removes.
"""

from __future__ import annotations

import functools
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from dataclasses import replace

import numpy as np

WATCHDOG_S = 600
SEED = 0

# Tolerances on the card. Kernel vs plain: fp32 sums in another order, so
# max |kernel - plain| <= 1e-4 * max(1, max |plain|). Slice, card vs CPU:
# three GAT layers and two contexts compound the same differences, so
# max |card - cpu| <= 1e-4 * max(1, max |cpu score|), and the per-impression
# rank order must agree except between scores closer than that bound.
KERNEL_RTOL = 1e-4
SLICE_RTOL = 1e-4
# Training, card vs CPU, from the same weights, batches and dropout seeds
# (the masks are the same bits on both): three steps compound fp32
# summation-order differences through depth 3 and Adam, so each step's loss
# must satisfy |card - cpu| <= 1e-3 * max(1, |cpu|), and every parameter's
# step-1 gradient max |card - cpu| <= 1e-3 * max |cpu| of that tensor, a
# limit that a zeroed or lost gradient (which reads 1) cannot pass.
TRAIN_RTOL = 1e-3
# the parameters a DIGAT forward uses more than once (the news and user
# contexts, at every depth), by state_dict prefix
MULTI_USE = tuple(f"graph_encoder.{n}" for n in (
    "candidate_attention.", "news_graph_W.", "user_news_K.", "user_news_Q.", "featureAffine.",
    "userAttention."))
TRAIN_STEPS = 20  # full-width training steps at B 64
NRMS_TRAIN_STEPS = 10  # full-width NRMS-SA training steps at B 64

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on the CUDA
# cores and HBM3 bandwidth. A card below 700 W runs slower under load.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores


def say(msg: str) -> None:
    print(msg, flush=True)


def bf16_ulp(torch, t):
    """One bf16 ulp at each element's magnitude: 2^(e - 8) for |t| in
    [2^(e-1), 2^e); an element of 0 takes that of the smallest normal."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


CHILDREN: list = []  # processes this run started (phase 22's ranks), killed by the watchdog
# seconds and calls of the run's measuring tools, printed beside [total]
TOOL_S = {"stage_split": [0.0, 0], "cuobjdump": [0.0, 0]}


def tool_time(what: str, t0: float) -> None:
    TOOL_S[what][0] += time.perf_counter() - t0
    TOOL_S[what][1] += 1


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog: run exceeded {WATCHDOG_S} s", file=sys.stderr, flush=True)
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
    os._exit(3)


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def msa_work(N, L, Din, D, A):
    flops = (2 * N * L * Din * 3 * D  # Q|K|V projections
             + 4 * N * L * L * D  # QK^T and PV over all heads
             + 2 * N * L * D * A + 2 * N * L * A  # pool MLP and its v-product
             + 2 * N * L * D)  # pooled sum
    nbytes = 4 * N * L * Din + N * L + 4 * (Din * 3 * D + 3 * D + D * A + 2 * A) + 4 * N * D
    return flops, nbytes


def gat_work(B, G, D):
    flops = (2 * B * G * D * 3 * D + 2 * B * D * D  # projections, k3
             + 4 * B * G * G * D  # Eq. 8: add, add, relu, multiply-add per (i, j, d)
             + 2 * B * G * G * D)  # alpha h
    nbytes = 4 * B * G * D + B * G * G + 4 * B * D + 4 * (4 * D * D + 3 * D) + 4 * B * G * D
    return flops, nbytes


def msa_bwd_work(N, L, Din, D, A):
    """Kernel A': the forward recomputed, then dx and dW of the projections,
    dh and dW1 of the pool, and the attention backward (dP, dq, dk, dv)."""
    flops = (msa_work(N, L, Din, D, A)[0] + 2 * (2 * N * L * Din * 3 * D)
             + 2 * (2 * N * L * D * A) + 8 * N * L * L * D)
    weights = Din * 3 * D + 3 * D + D * A + 2 * A
    nbytes = 8 * N * L * Din + N * L + 4 * N * D + 8 * weights
    return flops, nbytes


def msa_products(N, L, Din, D, A):
    """The FLOP of kernel A's two matrix products, out of msa_work's: the
    Q|K|V projections and the pool's product."""
    return 2 * N * L * Din * 3 * D + 2 * N * L * D * A


def msa_bwd_products(N, L, Din, D, A):
    """The FLOP of kernel A''s six matrix products, out of msa_bwd_work's:
    the Q|K|V projections three times (recompute, dx, dW) and the pool's
    product three times (u, dh, dW1)."""
    return 3 * msa_products(N, L, Din, D, A)


def bound_3xtf32(flops, nbytes, products):
    """A kernel's bound with its matrix products (`products` of its `flops`)
    on the tensor cores at 3xTF32: three TF32 products per fp32 product at
    the dense TF32 peak, plus the rest of its FLOP at the fp32 CUDA-core
    peak, plus its bytes at the memory rate (ms)."""
    return (3 * products / PEAK_TF32_FLOPS + (flops - products) / PEAK_FP32_FLOPS
            + nbytes / PEAK_BYTES) * 1e3


def say_bound_3xtf32(work, products, fp32_ms) -> None:
    say(f"    bound with the products at 3xTF32: {bound_3xtf32(*work, products):.4f} ms "
        f"({products / 1e9:.1f} GFLOP of products); fp32 CUDA-core bound {fp32_ms:.4f} ms")


def scores_work(B, G, D, backward: bool):
    """Kernel C: per (b, i, j, d) an add, a relu and a multiply-add forward;
    backward also the mask select and three accumulations."""
    flops = (6 if backward else 4) * B * G * G * D + B * G * D
    nbytes = 4 * (2 * B * G * D + B * D + D + B * G * G)
    if backward:
        nbytes += 4 * (2 * B * G * D + B * D + D)
    return flops, nbytes


def emb_work(ntok, V, D):
    """Kernel D: one add per gradient element; g and tok read, dW written."""
    return ntok * D, 4 * ntok * D + 8 * ntok + 4 * V * D


def mask_work(rows, cols):
    """Kernel A'': one Philox4x32-10 block (about 104 integer operations)
    per four mask bytes, counted at the fp32 CUDA-core rate."""
    return 26 * rows * cols, rows * cols


def dropout_work(rows, cols):
    """Kernel A'' as the fused dropout, one direction: a Philox block per
    four elements and a multiply each (27 operations an element, at the
    fp32 CUDA-core rate), each element read and written once."""
    return 27 * rows * cols, 8 * rows * cols


def mask_sites(cfg, cap: int = 0):
    """The dropout sites of one training step that kernel A'' draws, as it
    sees them: (what, rows, cols, rate, launches per step). The graph
    encoder's: B graphs of Gn and Gu nodes D wide, their alpha Gn and Gu
    wide, C topic nodes and C + 1 topics per graph, as many as the variant
    calls (wo_SA: no news context and no news graph; Seq_SA: the news
    context once and no news graph). The CNN news encoder's two, over the
    `cap` unique titles of a dedup batch: its words and its bank's output
    (the MSA encoder draws its word dropout inside kernel A up to titles of
    128; past them, before the attention pair, it is one more site)."""
    B = cfg.batch_size * (1 + cfg.negative_sample_num)
    D, C, depth, p = cfg.news_embedding_dim, cfg.category_num, cfg.graph_depth, cfg.dropout_rate
    Gn, Gu, v = cfg.news_graph_size, cfg.user_graph_size, cfg.graph_encoder
    news_contexts = {"wo_SA": 0, "Seq_SA": 1}.get(v, 1 + depth)
    user_contexts = 1 if v == "wo_SA" else 1 + depth
    news_layers = 0 if v in ("wo_SA", "Seq_SA") else depth
    sites = [("topic nodes", B * C, D, p / 2, 1),
             ("gate logits", B, D, p / 2, news_contexts),
             ("topics", B * (C + 1), D, p, user_contexts),
             ("GAT x news", B * Gn, D, p / 2, news_layers),
             ("GAT alpha news", B * Gn, Gn, p, news_layers),
             ("GAT x user", B * Gu, D, p / 2, depth),
             ("GAT alpha user", B * Gu, Gu, p, depth)]
    L = cfg.max_title_length
    if cfg.news_encoder == "CNN":
        sites += [("CNN words", cap * L, cfg.word_embedding_dim, p, 1),
                  ("CNN bank", cap * L, D, p, 1)]
    else:
        from digat_tpu_torch.ops.msa_attention_grouped import group_size

        if group_size(cfg.MSA_head_num, L, cfg.MSA_head_dim) <= 0:
            # past kernel A's titles: the word dropout before the attention pair
            sites += [("MSA words", cap * L, cfg.word_embedding_dim, p, 1)]
    return [site for site in sites if site[4]]


def site_launches(cfg, cap: int = 0) -> tuple:
    """(fp32, bf16) launches of kernel A'' per training step, forward and
    backward at each of `mask_sites`: at compute_dtype bfloat16 a site drops
    a bf16 tensor (A''s bf16 instance) where its activations are bf16 (the
    topic nodes, a bf16 weight; behind the CNN every site; the word
    dropout before the pair)."""
    fp32 = bf16 = 0
    for what, _, _, _, per_step in mask_sites(cfg, cap):
        if cfg.compute_dtype == "bfloat16" and (
                cfg.news_encoder == "CNN" or what in ("topic nodes", "MSA words")):
            bf16 += 2 * per_step
        else:
            fp32 += 2 * per_step
    return fp32, bf16


def time_ms(torch, fn, warmup: int = 3, iters: int = 10) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, launch, reps: int = 20, windows: int = 5) -> float:
    """A C entry point's own time: the median over `windows` of CUDA events
    around `reps` back-to-back calls of launch() (which returns a CUDA error
    code), divided by `reps`, after one checked warm-up call."""
    if launch() != 0:
        raise RuntimeError("the C entry point returned a CUDA error")
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def stage_split(torch, fn, reps: int = 5) -> list:
    """Device ms of each launch that one call of fn() makes, in launch order
    and averaged over `reps` traced calls (torch.profiler, CUDA activity),
    consecutive launches of one kernel merged: [(kernel, launches, ms)].
    After earlier profiler sessions in the process a session can lose its
    first launches, so each session first calls fn() twice, then waits 50
    ms and counts only the launches after that gap; a trace whose calls
    still do not show the same kernels in the same order is taken again,
    up to three times."""
    import re

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and e.device_time_total > 0), key=lambda e: e.time_range.start)
        gaps = [j for j in range(1, len(kernels))
                if kernels[j].time_range.start - kernels[j - 1].time_range.end > 20_000]
        kernels = kernels[gaps[-1]:] if gaps else kernels  # us: the 50 ms wait
        per_call = len(kernels) // reps
        names = [e.name for e in kernels]
        if len(kernels) == per_call * reps and all(
                names[r * per_call:(r + 1) * per_call] == names[:per_call] for r in range(reps)):
            break
    stages = []
    for k in range(per_call):
        name = re.sub(r"\(anonymous namespace\)::|void |at::native::|\(.*$", "", kernels[k].name)
        ms = sum(kernels[r * per_call + k].device_time_total for r in range(reps)) / reps / 1e3
        if stages and stages[-1][0] == name[:70]:
            stages[-1] = (stages[-1][0], stages[-1][1] + 1, stages[-1][2] + ms)
        else:
            stages.append((name[:70], 1, ms))
    tool_time("stage_split", t0)
    return stages


def say_stages(what: str, stages: list) -> None:
    total = sum(s[2] for s in stages)
    say(f"    stages of {what} (device ms per call, {total:.4f} in all):")
    for name, n, ms in stages:
        say(f"      {ms:10.4f}  x{n:<3d} {name}")


def make_tables(torch, cfg, news_num: int, device, seed: int):
    """Seeded corpus tables made on `device` (as bench.py makes them for the
    JAX package): title lengths 1..L as valid prefixes, news 0 the all-pad
    padding news, SAG node 0 the news itself, random graphs with
    self-loops, slot 0 of the graph mask zeroed."""
    from digat_tpu_torch.models.model import CorpusTables

    g = torch.Generator(device=device).manual_seed(seed)
    L, Gn, V = cfg.max_title_length, cfg.news_graph_size, cfg.vocabulary_size
    lengths = torch.randint(1, L + 1, (news_num, 1), generator=g, device=device)
    mask = torch.arange(L, device=device)[None, :] < lengths
    mask[0] = False
    node_id = torch.randint(0, news_num, (news_num, Gn), generator=g, device=device)
    node_id[:, 0] = torch.arange(news_num, device=device)
    graph = torch.rand((news_num, Gn, Gn), generator=g, device=device) < 0.25
    graph |= torch.eye(Gn, dtype=torch.bool, device=device)
    gmask = torch.rand((news_num, Gn), generator=g, device=device) < 0.9
    gmask[:, 0] = False
    return CorpusTables(
        news_title_text=torch.randint(0, V, (news_num, L), generator=g, device=device),
        news_title_mask=mask, news_node_id=node_id, news_graph=graph, news_graph_mask=gmask,
    )


def make_impressions(cfg, news_num: int, n_imp: int, per_imp: int, seed: int):
    """Seeded impressions on the host: H-slot histories with 1..H valid
    items (pads: news 0, category C), per_imp candidates, 0/1 labels with
    one positive and one negative per impression at least."""
    rng = np.random.default_rng(seed)
    H, C = cfg.max_history_num, cfg.category_num
    hist = rng.integers(1, news_num, (n_imp, H))
    cat = rng.integers(0, C, (n_imp, H))
    for r, n in enumerate(rng.integers(1, H + 1, n_imp)):
        hist[r, n:] = 0
        cat[r, n:] = C
    imp_index = np.repeat(np.arange(n_imp), per_imp)
    cand = rng.integers(1, news_num, n_imp * per_imp)
    labels = (rng.random(n_imp * per_imp) < 0.2).astype(np.float32)
    labels[0::per_imp], labels[1::per_imp] = 1.0, 0.0
    return hist, cat, imp_index, cand, labels


def make_train_corpus(cfg, tables, samples: int, rows: int, dev_imps: int, seed: int):
    """A seeded training corpus over `tables`, with the fields the port's
    `Trainer` reads: `rows` behaviours, `samples` clicks with 1..20 ragged
    non-clicks each, and a dev split of `dev_imps` impressions of 8."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    news_num = tables.news_title_text.shape[0]
    hist, cat, _, _, _ = make_impressions(cfg, news_num, rows, 1, seed)
    dev = make_impressions(cfg, news_num, dev_imps, 8, seed + 1)
    neg_len = rng.integers(1, 21, samples)
    return SimpleNamespace(
        tables=lambda: tables,
        news_node_id=tables.news_node_id.cpu().numpy(),
        splits={"train": SimpleNamespace(history_idx=hist, cat_idx=cat),
                "dev": SimpleNamespace(history_idx=dev[0], cat_idx=dev[1])},
        train_behavior_row=rng.integers(0, rows, samples),
        train_pos=rng.integers(1, news_num, samples).astype(np.int32),
        train_neg_flat=rng.integers(1, news_num, int(neg_len.sum())).astype(np.int32),
        train_neg_offsets=np.concatenate([[0], np.cumsum(neg_len)]),
        dev_imp_index=dev[2], dev_cand=dev[3], dev_labels=dev[4],
    )


def check_kernel(torch, name, kernel, plain, args, flops, nbytes, exact=False, library=None,
                 bound_ms=None):
    """Kernel vs plain on the same inputs, timed; returns the kernels-line
    entry without launches (filled from the main-path run). A kernel with
    several outputs is held to the limit output by output; a bf16 output
    may also lie one bf16 ulp of the plain element apart (a rounding of
    fp32 sums that differ within the limit); `exact` asks for the same
    bits; `library` is one PyTorch call computing the same function, timed
    as a yardstick; `bound_ms` replaces the fp32 bound with (ms, by)."""
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err, ok, limits = 0.0, True, []
    for o, r in zip(outs, refs):
        d = (o.double() - r.double()).abs()
        e = float(d.max()) if o.numel() else 0.0
        limit = 0.0 if exact else KERNEL_RTOL * max(1.0, float(r.double().abs().max()))
        if o.dtype == torch.bfloat16 and not exact and o.numel():
            d = (d - bf16_ulp(torch, r).double()).clamp(min=0)
        ok = ok and bool(torch.isfinite(o.double()).all()) and \
            (float(d.max()) if o.numel() else 0.0) <= limit
        err = max(err, e)
        limits.append(limit)
    ms = time_ms(torch, lambda: kernel(*args))
    plain_ms = time_ms(torch, lambda: plain(*args))
    library_ms = time_ms(torch, lambda: library(*args)) if library is not None else None
    bound_ms, bound_by = bound(flops, nbytes) if bound_ms is None else bound_ms
    lim = f"limit {limits[0]:.3e}" if len(limits) == 1 else \
        f"limits {min(limits):.3e}-{max(limits):.3e}"
    say(f"  {name}: max_abs_err {err:.3e} ({'exact' if exact else f'{lim} per output'}) "
        f"ms {ms:.4f} plain_ms {plain_ms:.4f} "
        + (f"library_ms {library_ms:.4f} " if library is not None else "")
        + f"bound_ms {bound_ms:.4f} ({bound_by}) ok {ok}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, ok=ok)


def gat_products(B, G, D):
    """The FLOP of kernel B's projections, out of gat_work's: y = x [W|W1|W2]
    and k3 = q W3."""
    return 2 * B * G * D * 3 * D + 2 * B * D * D


def gat_layer_kernels(torch, cfg, model, bs: int, dev):
    """Phase 4: kernel B against its plain version at the serving batch on
    graphs of 6, 26, 68 and 96 nodes (the model's news-graph weights up to
    26 nodes, its user-graph weights above) and, with random weights, at
    D 398 (not a multiple of 4: padded to 400); a row with no neighbour in
    each. At G 26 and 68 the device ms of each of B's launches and both
    bounds (fp32 CUDA cores, and the projections at 3xTF32)."""
    from digat_tpu_torch.ops.gat_layer import (
        interactive_gat_layer_fused,
        interactive_gat_layer_plain,
    )

    ge, D = model.graph_encoder, cfg.news_embedding_dim
    cases = [(bs, G, D) for G in (6, cfg.news_graph_size, cfg.user_graph_size, 96)]
    cases.append((256, cfg.news_graph_size, D - 2))
    by_shape = {}
    for B, G, Dc in cases:
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + G + Dc)
            r = lambda *s, sc=0.5: torch.randn(s, generator=g, device=dev) * sc
            xb, q = r(B, G, Dc), r(B, Dc)
            adj = (torch.rand((B, G, G), generator=g, device=dev) < 0.25) \
                | torch.eye(G, dtype=torch.bool, device=dev)
            adj[0, 1] = False  # a row with no neighbour
            if Dc == D:
                prefix = "news_graph_attention" if G <= cfg.news_graph_size \
                    else "user_graph_attention"
                W, W1, W2, W3 = (getattr(ge, f"{prefix}_{n}")[0]
                                 for n in ("W", "ffn1", "ffn2", "ffn3"))
                weights = tuple(t.detach() for t in (
                    W.weight.t(), W.bias, W1.weight.t(), W2.weight.t(), W3.weight.t(), W3.bias,
                    getattr(ge, f"{prefix}_a")[0].weight[0]))
            else:
                sc = Dc ** -0.5
                weights = (r(Dc, Dc, sc=sc), r(Dc, sc=0.05), r(Dc, Dc, sc=sc), r(Dc, Dc, sc=sc),
                           r(Dc, Dc, sc=sc), r(Dc, sc=0.05), r(Dc, sc=sc))
            args = (xb, adj, q, *weights)
            work = gat_work(B, G, Dc)
            entry = check_kernel(torch, f"interactive_gat_layer_fused B={B} G={G} D={Dc}",
                                 interactive_gat_layer_fused, interactive_gat_layer_plain, args,
                                 *work)
            again = torch.equal(interactive_gat_layer_fused(*args),
                                interactive_gat_layer_fused(*args))
            say(f"    same bits twice: {again}")
            entry["ok"] = entry["ok"] and again
            if Dc == D and G in (cfg.news_graph_size, cfg.user_graph_size):
                say_bound_3xtf32(work, gat_products(B, G, Dc), entry["bound_ms"])
                stages = stage_split(torch, lambda: interactive_gat_layer_fused(*args))
                say_stages(f"interactive_gat_layer_fused G {G}", stages)
                entry["stages"] = [dict(kernel=k, launches=n, device_ms=ms)
                                   for k, n, ms in stages]
            by_shape[f"G{G} D{Dc}"] = entry
        except Exception:
            traceback.print_exc()
            by_shape[f"G{G} D{Dc}"] = dict(ok=False)
    big = by_shape.get(f"G{cfg.user_graph_size} D{D}", {})
    return dict(big, ok=all(v.get("ok") for v in by_shape.values()),
                max_abs_err=max(v.get("max_abs_err", math.inf) for v in by_shape.values()),
                by_shape=by_shape)


def training_kernels(torch, cfg, model, tables, cap: int, dev):
    """Phase 7: A'', A with dropout, A', C and D against their plain versions
    at the training shapes: `cap` unique titles (the dedup capacity), 320
    graphs of 26 and of 68 nodes."""
    from digat_tpu_torch.ops import dropout as DR
    from digat_tpu_torch.ops import emb_grad as EG
    from digat_tpu_torch.ops import gat_scores as GS
    from digat_tpu_torch.ops import msa_encoder as ME

    L, Din, D, A = cfg.max_title_length, cfg.word_embedding_dim, cfg.news_embedding_dim, \
        cfg.attention_dim
    p, heads, V = cfg.dropout_rate, cfg.MSA_head_num, cfg.vocabulary_size
    entries = {}

    def guarded(name, fn):
        try:
            entries[name] = fn()
        except Exception:
            traceback.print_exc()
            entries[name] = dict(ok=False)

    # A'': at every graph dropout site's shape, as the main path launches it,
    # the fused dropout forward and forward + backward the same bits as its
    # plain version (the topic nodes an expanded view of their [C, D]
    # parameter, the gradient summed back into it), and the keep mask the
    # same bits as the plain Philox; torch's own dropout timed beside each
    # (the same work on torch's stream, another function). The keep
    # fraction within 0.002 of 1 - p over the word-dropout shape's >= 1e7
    # draws (A and A' draw those inline).
    def dropout_check():
        import torch.nn.functional as F

        by_shape, work, errs = {}, np.zeros(2), []
        for k, (what, rows, cols, rate, per_step) in enumerate(mask_sites(cfg)):
            g = torch.Generator(device=dev).manual_seed(SEED + 11 + k)
            if what == "topic nodes":
                leaf = torch.randn((cfg.category_num, cols), generator=g, device=dev)
                view = lambda t: t[None].expand(rows // cfg.category_num, *t.shape)
            else:
                leaf = torch.randn((rows, cols), generator=g, device=dev)
                view = lambda t: t
            up = torch.randn((rows, cols), generator=g, device=dev).reshape(view(leaf).shape)
            lg = leaf.clone().requires_grad_(True)
            name = f"{what} [{rows},{cols}] rate {rate:g}"
            fwd = check_kernel(torch, f"dropout fwd {name}",
                               lambda: DR.dropout(view(leaf), rate, 4321, k),
                               lambda: DR.dropout_plain(view(leaf), rate, 4321, k), (),
                               *dropout_work(rows, cols), exact=True)
            # the backward is the same launch on the gradient: timed so,
            # apart from autograd's own host path
            grad = check_kernel(torch, f"dropout on the gradient {name}",
                                lambda: DR.dropout(up, rate, 4321, k),
                                lambda: DR.dropout_plain(up, rate, 4321, k), (),
                                *dropout_work(rows, cols), exact=True)
            both = check_kernel(
                torch, f"dropout fwd + bwd through autograd.grad {name}",
                lambda: torch.autograd.grad(DR.dropout(view(lg), rate, 4321, k), lg, up)[0],
                lambda: torch.autograd.grad(DR.dropout_plain(view(lg), rate, 4321, k), lg,
                                            up)[0],
                (), *(2 * w for w in dropout_work(rows, cols)), exact=True)
            mask = check_kernel(torch, f"keep_mask {name}",
                                lambda: DR.keep_mask(rows, cols, rate, 4321, k, device=dev),
                                lambda: DR.keep_mask_plain(rows, cols, rate, 4321, k,
                                                           device=dev),
                                (), *mask_work(rows, cols), exact=True)
            torch_fwd = time_ms(torch, lambda: F.dropout(view(leaf), rate, training=True))
            torch_both = time_ms(torch, lambda: torch.autograd.grad(
                F.dropout(view(lg), rate, training=True), lg, up)[0])
            say(f"    torch.nn.functional.dropout at this shape (the same work on torch's "
                f"stream, not the same function): fwd {torch_fwd:.4f} ms, fwd + bwd "
                f"{torch_both:.4f} ms")
            by_shape[what] = dict(fwd=fwd, on_gradient=grad, fwd_bwd=both, keep_mask=mask,
                                  torch_dropout_ms=dict(fwd=torch_fwd, fwd_bwd=torch_both),
                                  ok=fwd["ok"] and grad["ok"] and both["ok"] and mask["ok"])
            errs += [fwd["max_abs_err"], grad["max_abs_err"], both["max_abs_err"],
                     mask["max_abs_err"]]
            work += per_step * 2 * np.array(dropout_work(rows, cols), dtype=float)
        total = dict(zip(("bound_ms", "bound_by"), bound(*work)))

        # one training step's sites, forward and backward through autograd,
        # timed as a whole: the fused dropout against its plain version
        g = torch.Generator(device=dev).manual_seed(SEED + 19)
        step_inputs = [(torch.randn((rows, cols), generator=g, device=dev).requires_grad_(True),
                        torch.randn((rows, cols), generator=g, device=dev), rate, k, per_step)
                       for k, (_, rows, cols, rate, per_step) in enumerate(mask_sites(cfg))]

        def step_dropouts(fn):
            for x, up, rate, k, n in step_inputs:
                for _ in range(n):
                    torch.autograd.grad(fn(x, rate, 4321, k), x, up)

        torch_dropout = lambda x, rate, seed, site: F.dropout(x, rate, training=True)
        total["ms"] = time_ms(torch, lambda: step_dropouts(DR.dropout))
        total["plain_ms"] = time_ms(torch, lambda: step_dropouts(DR.dropout_plain))
        # the library: torch's own dropout at the same sites, timed as a whole
        # the same way, and its device time by launch
        total["library_ms"] = time_ms(torch, lambda: step_dropouts(torch_dropout))
        stages = stage_split(torch, lambda: step_dropouts(DR.dropout))
        fused = [st for st in stages if "dropout_site_kernel" in st[0]]
        lib_stages = stage_split(torch, lambda: step_dropouts(torch_dropout))
        say(f"    one step's {sum(s[4] for s in mask_sites(cfg))} sites, forward and backward: "
            f"{sum(st[1] for st in fused)} launches of the fused kernel, device "
            f"{sum(st[2] for st in fused):.4f} ms; torch.nn.functional.dropout "
            f"{sum(st[1] for st in lib_stages)} launches, device "
            f"{sum(st[2] for st in lib_stages):.4f} ms, timed as a whole "
            f"{total['library_ms']:.4f} ms")
        rows = max(cap, 1100)
        word = check_kernel(torch, f"keep_mask word dropout [{rows},{L * Din}] rate {p:g}",
                            lambda: DR.keep_mask(rows, L * Din, p, 4321, 99, device=dev),
                            lambda: DR.keep_mask_plain(rows, L * Din, p, 4321, 99, device=dev),
                            (), *mask_work(rows, L * Din), exact=True)
        frac = float((~DR.keep_mask(rows, L * Din, p, 4321, 99, device=dev)).float().mean())
        say(f"    dropped fraction {frac:.5f} over {rows * L * Din} draws (rate {p})")
        word["ok"] = word["ok"] and abs(frac - p) < 0.002
        by_shape["word dropout mask (drawn inline on the main path)"] = word
        errs.append(word["max_abs_err"])
        say(f"    one step's {sum(s[4] for s in mask_sites(cfg))} site dropouts, forward and "
            f"backward through autograd (timed as a whole): ms {total['ms']:.4f} plain_ms "
            f"{total['plain_ms']:.4f} bound_ms {total['bound_ms']:.4f}")
        return dict(total, ok=all(v["ok"] for v in by_shape.values()),
                    max_abs_err=max(errs), by_shape=by_shape,
                    step_device_ms=sum(st[2] for st in fused),
                    step_launches=sum(st[1] for st in fused),
                    library_device_ms=sum(st[2] for st in lib_stages))

    guarded("dropout", dropout_check)

    ne = model.news_encoder
    mha, pool = ne.multiheadSelfattention, ne.attention
    text, tmask = tables.news_title_text[:cap], tables.news_title_mask[:cap].contiguous()
    with torch.no_grad():
        x = ne.word_embedding.weight[text].contiguous()
    w = [t.detach() for t in (mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(),
                              mha.W_V.weight.t(), mha.W_V.bias, pool.affine1.weight.t(),
                              pool.affine1.bias, pool.affine2.weight[0])]

    def encoder_dropout_check():
        seed = 987
        fwd = lambda: ME.msa_encoder_pooled(x, tmask, *w, heads, p, seed, 0)
        e = check_kernel(
            torch, f"msa_encoder_pooled [{cap},{L},{Din}] dropout {p}", fwd,
            lambda: ME.msa_encoder_pooled_plain(ME.drop_titles_plain(x, p, seed, 0), tmask,
                                                *w, heads),
            (), *msa_work(cap, L, Din, D, A))
        say_bound_3xtf32(msa_work(cap, L, Din, D, A), msa_products(cap, L, Din, D, A),
                         e["bound_ms"])
        again = torch.equal(fwd(), fwd())
        say(f"    same bits twice for one seed: {again}")
        stages = stage_split(torch, fwd)
        say_stages("msa_encoder_pooled", stages)
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        e["ok"] = e["ok"] and again
        return e

    guarded("msa_encoder_pooled", encoder_dropout_check)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    dp = torch.randn((cap, D), generator=g, device=dev)

    def encoder_bwd_check():
        args = (x, tmask, *w, dp, heads, p, 987, 0)
        e = check_kernel(
            torch, f"msa_encoder_bwd [{cap},{L},{Din}] dropout {p} (dx + 8 weight grads)",
            ME.msa_encoder_bwd, ME.msa_encoder_bwd_plain, args, *msa_bwd_work(cap, L, Din, D, A))
        say_bound_3xtf32(msa_bwd_work(cap, L, Din, D, A), msa_bwd_products(cap, L, Din, D, A),
                         e["bound_ms"])
        again = all(torch.equal(a, b) for a, b in zip(ME.msa_encoder_bwd(*args),
                                                      ME.msa_encoder_bwd(*args)))
        say(f"    same bits twice, every output: {again}")
        stages = stage_split(torch, lambda: ME.msa_encoder_bwd(*args))
        say_stages("msa_encoder_bwd", stages)
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        e["ok"] = e["ok"] and again
        return e

    guarded("msa_encoder_bwd", encoder_bwd_check)

    by_shape = {}
    B = cfg.batch_size * (1 + cfg.negative_sample_num)
    for G in (cfg.news_graph_size, cfg.user_graph_size):
        def scores_check(G=G):
            r = lambda *s: torch.randn(s, generator=g, device=dev) * 0.5
            y = r(B, G, 3 * D)  # k1, k2 as column blocks of the fused projection
            args = (y[..., D:2 * D], y[..., 2 * D:], r(B, D), r(D))
            bargs = (*args, r(B, G, G))
            fwd = check_kernel(torch, f"gat_scores_fwd B={B} G={G} D={D} {GS.fwd_plan(G)}",
                               GS.gat_scores_fwd, GS.interactive_gat_scores_plain, args,
                               *scores_work(B, G, D, False))
            bwd = check_kernel(torch, f"gat_scores_bwd B={B} G={G} D={D} {GS.bwd_plan(G, D)}",
                               GS.gat_scores_bwd, GS.interactive_gat_scores_bwd_plain, bargs,
                               *scores_work(B, G, D, True))
            again = torch.equal(GS.gat_scores_fwd(*args), GS.gat_scores_fwd(*args)) and all(
                torch.equal(a, b) for a, b in zip(GS.gat_scores_bwd(*bargs),
                                                  GS.gat_scores_bwd(*bargs)))
            say(f"    same bits twice, forward and every backward output: {again}")
            for e, fn in ((fwd, lambda: GS.gat_scores_fwd(*args)),
                          (bwd, lambda: GS.gat_scores_bwd(*bargs))):
                stages = stage_split(torch, fn)
                say_stages(f"gat_scores_{'fwd' if e is fwd else 'bwd'} G {G}", stages)
                e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
            return dict(fwd=fwd, bwd=bwd, ok=fwd["ok"] and bwd["ok"] and again)

        try:
            by_shape[f"G{G}"] = scores_check()
        except Exception:
            traceback.print_exc()
            by_shape[f"G{G}"] = dict(ok=False)
    big = by_shape.get(f"G{cfg.user_graph_size}", {})
    sum_of = lambda key: (big["fwd"][key] + big["bwd"][key]) if big.get("ok") else None
    entries["interactive_gat_scores"] = dict(
        ok=all(v.get("ok") for v in by_shape.values()),
        max_abs_err=max((max(v["fwd"]["max_abs_err"], v["bwd"]["max_abs_err"])
                         for v in by_shape.values() if v.get("ok")), default=math.inf),
        ms=sum_of("ms"), plain_ms=sum_of("plain_ms"), bound_ms=sum_of("bound_ms"),
        bound_by="operations", library_ms=None, by_shape=by_shape)

    # D on the uniform stream (the seeded corpus's tokens, as the training
    # phase reads them) and on the pad stream (token 0 wherever the title
    # mask is False, as the corpus writes real titles)
    gr = torch.randn((text.numel(), Din), generator=g, device=dev)

    def emb_check():
        by_shape = {}
        streams = {"uniform": text.reshape(-1),
                   "pad": torch.where(tmask, text, torch.zeros_like(text)).reshape(-1)}
        for what, tok in streams.items():
            pad = float((tok == 0).float().mean())
            e = check_kernel(
                torch, f"embedding_grad {what} stream (token 0 on {pad:.3f}) ntok={tok.numel()} "
                f"V={V} D={Din}", EG.embedding_grad, EG.embedding_grad_plain, (tok, gr, V),
                *emb_work(tok.numel(), V, Din),
                library=lambda t, gg, v: torch.ops.aten.embedding_dense_backward(gg, t, v, -1,
                                                                                 False))
            again = torch.equal(EG.embedding_grad(tok, gr, V), EG.embedding_grad(tok, gr, V))
            stages = stage_split(torch, lambda: EG.embedding_grad(tok, gr, V))
            say_stages(f"embedding_grad ({what})", stages)
            e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
            e["ok"] = e["ok"] and again
            by_shape[what] = e
            # one rank's rows of a table row-sharded over two (phase 22's
            # tensor-parallel leg): rows V/2 .. V-1, the stream cut to them
            lo = V // 2
            ntok = int(((tok >= lo) & (tok < V)).sum())
            e = check_kernel(
                torch, f"embedding_grad {what} stream, rows {lo}-{V - 1} of V {V} ({ntok} of "
                f"{tok.numel()} tokens in range)",
                lambda t, gg, v: EG.embedding_grad(t, gg, v, row_start=lo),
                lambda t, gg, v: EG.embedding_grad_plain(t, gg, v, row_start=lo),
                (tok, gr, V - lo), ntok * Din,
                4 * ntok * Din + 8 * tok.numel() + 4 * (V - lo) * Din)
            e["ok"] = e["ok"] and torch.equal(EG.embedding_grad(tok, gr, V - lo, row_start=lo),
                                              EG.embedding_grad(tok, gr, V - lo, row_start=lo))
            by_shape[f"{what} rows {lo}-{V - 1}"] = e
        return dict(by_shape["uniform"], by_shape=by_shape,
                    ok=all(v["ok"] for v in by_shape.values()))

    guarded("embedding_grad", emb_check)
    return entries


def counters():
    """The launch counter of every kernel wrapper, by kernels-line name:
    (wrapper, attribute). The bf16 instances of A, A', B (bf16 weights), C's
    forward, the pair and A'' count on their wrappers' `launches_bf16`, B's
    bf16-activation instance on `launches_bf16_act`, the pair's wide
    instance on `launches_wide` and `launches_wide_bf16`."""
    from digat_tpu_torch.ops import (dropout, emb_grad, gat_layer, gat_scores, msa_attention,
                                     msa_encoder)

    return {"msa_encoder_pooled": (msa_encoder.msa_encoder_pooled, "launches"),
            "msa_encoder_bwd": (msa_encoder.msa_encoder_bwd, "launches"),
            "dropout": (dropout.dropout, "launches"),
            "keep_mask": (dropout.keep_mask, "launches"),
            "interactive_gat_layer_fused": (gat_layer.interactive_gat_layer_fused, "launches"),
            "gat_scores_fwd": (gat_scores.gat_scores_fwd, "launches"),
            "gat_scores_bwd": (gat_scores.gat_scores_bwd, "launches"),
            "embedding_grad": (emb_grad.embedding_grad, "launches"),
            "msa_attention_fwd": (msa_attention.attention_fwd, "launches"),
            "msa_attention_bwd": (msa_attention.attention_bwd, "launches"),
            "msa_encoder_pooled_bf16": (msa_encoder.msa_encoder_pooled, "launches_bf16"),
            "msa_encoder_bwd_bf16": (msa_encoder.msa_encoder_bwd, "launches_bf16"),
            "interactive_gat_layer_fused_bf16": (gat_layer.interactive_gat_layer_fused,
                                                 "launches_bf16"),
            "interactive_gat_layer_fused_bf16_act": (gat_layer.interactive_gat_layer_fused,
                                                     "launches_bf16_act"),
            "gat_scores_fwd_bf16": (gat_scores.gat_scores_fwd, "launches_bf16"),
            "msa_attention_fwd_bf16": (msa_attention.attention_fwd, "launches_bf16"),
            "msa_attention_bwd_bf16": (msa_attention.attention_bwd, "launches_bf16"),
            "dropout_bf16": (dropout.dropout, "launches_bf16"),
            # the pair's wide instance (dk 65-128), fp32 and bf16
            "msa_attention_wide_fwd": (msa_attention.attention_fwd, "launches_wide"),
            "msa_attention_wide_bwd": (msa_attention.attention_bwd, "launches_wide"),
            "msa_attention_wide_fwd_bf16": (msa_attention.attention_fwd, "launches_wide_bf16"),
            "msa_attention_wide_bwd_bf16": (msa_attention.attention_bwd, "launches_wide_bf16")}


def reset_counters():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def training_slice(torch, cfg, model, corpus, run_dir, failures, label="training"):
    """Phase 8 (and phase 20 at bf16): one epoch of the port's Trainer at
    B 64 with the launch counters reset; returns (epoch record, median step
    ms, launches of that run). At compute_dtype bfloat16 A, A' and B must
    run their bf16 instances and never their fp32 ones."""
    from digat_tpu_torch import layers
    from digat_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, cfg, corpus, run_dir, verbose=False)
    # the shapes at which the dropout sites call kernel A'', to hold them
    # against those phase 7 checked
    drawn, apply_dropout = Counter(), layers.apply_dropout

    def recording(x, rate, seed, site):
        drawn[(x.numel() // x.shape[-1], x.shape[-1], rate)] += 1
        return apply_dropout(x, rate, seed, site)

    layers.apply_dropout = recording
    reset_counters()
    try:
        (rec,) = trainer.train()
    finally:
        layers.apply_dropout = apply_dropout
    launches = read_counters()
    b16 = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    steps, over = len(rec["step_losses"]), rec["overflow_batches"]
    bs = cfg.effective_eval_batch_size()
    dev_chunks = -(-corpus.tables().news_title_text.shape[0] // bs)
    dev_batches = -(-len(corpus.dev_cand) // bs)
    depth = cfg.graph_depth
    sites = sum(site[4] for site in mask_sites(cfg))
    checked = Counter()
    for _, rows, cols, rate, per_step in mask_sites(cfg):
        checked[(rows, cols, rate)] += per_step * steps
    fp32_drops, bf16_drops = site_launches(cfg)
    want = {"msa_encoder_pooled" + b16: steps + over + dev_chunks,
            "msa_encoder_bwd" + b16: steps + over,
            "embedding_grad": steps + over, "gat_scores_fwd": 2 * depth * steps,
            "gat_scores_bwd": 2 * depth * steps, "dropout": fp32_drops * steps,
            "dropout_bf16": bf16_drops * steps, "keep_mask": 0,
            "interactive_gat_layer_fused" + b16: 2 * depth * dev_batches}
    # the other instance of A, A' and B launched no time
    want.update({k.replace(b16, "") if b16 else k + "_bf16": 0
                 for k in ("msa_encoder_pooled" + b16, "msa_encoder_bwd" + b16,
                           "interactive_gat_layer_fused" + b16)})
    step_ms = rec["step_ms"]
    warm = float(np.median(step_ms[2:]))
    say(f"  {steps} steps at B {cfg.batch_size} (dedup overflow {over}); step ms median after "
        f"warm-up {warm:.3f} (first {step_ms[0]:.3f}); train samples/s "
        f"{cfg.batch_size * 1e3 / warm:.1f} (epoch wall {rec['samples_per_s']:.1f})")
    say(f"  step losses: {[round(v, 6) for v in rec['step_losses']]}")
    a_key = "msa_encoder_pooled" + b16
    per_step = {k: (launches[k] - (dev_chunks if k == a_key else 0)) / steps
                for k in launches if not k.startswith("interactive_gat_layer_fused")}
    say(f"  launches per step: A {per_step[a_key]:g}, "
        f"A' {per_step['msa_encoder_bwd' + b16]:g}, C-fwd {per_step['gat_scores_fwd']:g}, "
        f"C-bwd {per_step['gat_scores_bwd']:g}, D {per_step['embedding_grad']:g}, "
        f"A'' {per_step['dropout']:g} + bf16 {per_step['dropout_bf16']:g} (forward and backward "
        f"at {sites} graph dropout sites); "
        f"dev scoring: "
        f"A {dev_chunks}, B {launches['interactive_gat_layer_fused' + b16]}"
        + (" (the bf16 instances)" if b16 else ""))
    say(f"  dev on random weights: auc {rec['auc']:.4f} mrr {rec['mrr']:.4f}")
    if steps < TRAIN_STEPS or not np.isfinite(rec["step_losses"]).all():
        failures.append(f"{label}: too few steps or a loss not finite")
    for k, n in want.items():
        if launches[k] != n:
            failures.append(f"{label}: {k} launched {launches[k]} times, want {n}")
    if drawn != checked:
        failures.append(f"{label}: A'' drew masks at {dict(drawn)}, phase 7 checked "
                        f"{dict(checked)}")
    return rec, warm, launches


def grad_rel(torch, name, got, want, b16: bool, act_bf16: bool) -> float:
    """A step-1 gradient's error on the card, max |got - want| / max |want|
    (a zeroed or lost gradient reads 1). At bf16, where all but the word
    table's gradient are bf16-rounded values, an element within one bf16
    ulp of the CPU's passes whatever its size, and for a parameter that a
    forward uses more than once (the news and user contexts' weights, at
    every depth) within one bf16 ulp of its tensor's largest |want|: its
    uses' bf16 gradients are summed in bf16, as JAX sums them, and where
    they cancel a partial sum that rounds the other way moves an element by
    an ulp of the partial. Where the activations are bf16 (`act_bf16`)
    every gradient sums bf16 terms that the card's products may round to
    the neighbouring value (fp32 sums of another order): each tensor takes
    that rule."""
    d = (got - want).abs()
    if b16:
        ulp = bf16_ulp(torch, want.abs().max() if act_bf16 or name.startswith(MULTI_USE)
                       else want)
        d = torch.where(d <= ulp, torch.zeros_like(d), d)
    return float(d.max()) / max(float(want.abs().max()), 1e-12)


class KinkReplay:
    """The kinks in a card-against-CPU training check. Where the input of a
    ReLU lies within rounding of 0, the card and the CPU, whose inputs come
    from sums of other orders (and, at bf16 activations, may round to
    neighbouring bf16 values), can take opposite sides: a step-1 gradient
    then moves by a whole term, rounding and not a fault. The kinks are the
    Eq. (8) sums of C's backward (t = k1 + k2 + k3, a whole a g term each),
    the leaky ReLU of the GAT scores and the model's ReLUs (the CNN bank,
    MSA titles past 128, the topic nodes' feature affine, each GAT layer's
    output; and the ReLUs and leaky ReLUs of `layers_ext`). `record` (around
    the card's run) keeps, call by call, the side
    each input takes on the card by the port's own rule (`relu_mask` on the
    card's k1, k2, k3 for C; t > 0, or t >= 0 for a bf16 leaky ReLU, for
    the rest); `replay` (around the CPU's run) makes the CPU take those
    sides, in the same order, and counts by kind the terms where its own
    input lies on the other side (`flips` of `terms`). The values still
    come from each side's own inputs, so everything but the side taken at
    a kink shows in the comparison; C's own mask is held to the plain rule
    by the kernel checks and the card tests."""

    KINDS = ("C", "relu", "leaky_relu")

    def __init__(self, torch):
        self.torch = torch
        self.masks = {k: [] for k in self.KINDS}
        self.flips, self.terms = Counter(), Counter()

    @staticmethod
    def _leaky_side(torch, t):
        return t >= 0 if t.dtype == torch.bfloat16 else t > 0

    def _patches(self, relu, leaky_relu, bwd_any=None):
        from digat_tpu_torch import layers, layers_ext
        from digat_tpu_torch.models import graph_encoders, news_encoders

        proxy = _TorchWith(self.torch, relu=relu)
        patches = [_Patched(m, torch=proxy) for m in (layers, news_encoders, graph_encoders,
                                                       layers_ext)]
        patches += [_Patched(m, leaky_relu=leaky_relu) for m in (graph_encoders, layers_ext)]
        if bwd_any is not None:
            from digat_tpu_torch.ops import gat_scores as GS

            # the wrapper of every dtype's backward, so that the kernel's
            # own wrapper (and its launch counter) stays as it is
            patches.append(_Patched(GS, gat_scores_bwd_any=bwd_any))
        return _Stack(patches)

    def record(self):
        from digat_tpu_torch import layers
        from digat_tpu_torch.ops import gat, gat_scores as GS

        torch, masks = self.torch, self.masks
        bwd = GS.gat_scores_bwd_any

        def relu(t):
            masks["relu"].append(self._keep(t > 0))
            return torch.relu(t)

        def leaky_relu(t, negative_slope=0.2):
            masks["leaky_relu"].append(self._keep(self._leaky_side(torch, t)))
            return layers.leaky_relu(t, negative_slope)

        def bwd_any(k1, k2, k3, a_vec, g):
            B, G, D = k1.shape
            step = max(1, gat._MAX_ELEMENTS // (G * G * D))
            parts = []
            for s in range(0, B, step):
                c1, c2, c3 = (k[s:s + step].float() for k in (k1, k2, k3))
                t = c1[:, None, :, :] + (c2[:, :, None, :] + c3[:, None, None, :])
                parts.append(self._keep(GS.relu_mask(c1, c2, c3, t)))
            masks["C"].append(self._join(parts))
            return bwd(k1, k2, k3, a_vec, g)

        return self._patches(relu, leaky_relu, bwd_any)

    def _keep(self, mask):
        """What a record keeps of one mask: the mask, on the host."""
        return mask.cpu()

    def _join(self, parts):
        """One call's record from the records of its parts in order."""
        return self.torch.cat(parts)

    def _next(self, kind, own):
        """The card's side for the CPU's next call of this kind, its flips
        against the CPU's own side `own` counted."""
        if not self.pending[kind]:
            raise RuntimeError(f"kink replay: the CPU ran more {kind} calls than the card")
        m = self.pending[kind].pop(0)
        if m.shape != own.shape:
            raise RuntimeError(f"kink replay: the CPU's {kind} calls are not the card's")
        self.flips[kind] += int((m != own).sum())
        self.terms[kind] += m.numel()
        return m

    def replay(self):
        from digat_tpu_torch import layers
        from digat_tpu_torch.ops import gat_scores as GS

        torch = self.torch
        self.pending = {k: list(v) for k, v in self.masks.items()}
        bwd_plain, own_mask, state = GS.interactive_gat_scores_bwd_plain, GS.relu_mask, {}

        def relu(t):
            m = self._next("relu", t > 0)
            return torch.where(m, t, torch.zeros((), dtype=t.dtype))

        def leaky_relu(t, negative_slope=0.2):
            m = self._next("leaky_relu", self._leaky_side(torch, t))
            return torch.where(m, t, t * layers._weak(negative_slope, t))

        def replaying_bwd(k1, *rest):
            if not self.pending["C"]:
                raise RuntimeError("kink replay: the CPU ran more C calls than the card")
            state.update(mask=self.pending["C"].pop(0), at=0)
            if state["mask"].shape[0] != k1.shape[0]:
                raise RuntimeError("kink replay: the CPU's C calls are not the card's")
            return bwd_plain(k1, *rest)

        def replayed_mask(k1, k2, k3, t):
            own = own_mask(k1, k2, k3, t)
            m = state["mask"][state["at"]:state["at"] + k1.shape[0]]
            if m.shape != own.shape:
                raise RuntimeError("kink replay: the CPU's C calls are not the card's")
            state["at"] += k1.shape[0]
            self.flips["C"] += int((m != own).sum())
            self.terms["C"] += m.numel()
            return m

        stack = self._patches(relu, leaky_relu)
        stack.patches.append(_Patched(GS, interactive_gat_scores_bwd_plain=replaying_bwd,
                                      relu_mask=replayed_mask))
        return stack

    def summary(self) -> str:
        return "; ".join(f"{k} {self.flips[k]} of {self.terms[k]}" for k in self.KINDS)

    def same_sides(self, other) -> bool:
        """Whether another record took the same side at every kink, call by
        call."""
        torch = self.torch
        return all(len(self.masks[k]) == len(other.masks[k])
                   and all(torch.equal(a, b) for a, b in zip(self.masks[k], other.masks[k]))
                   for k in self.KINDS)


DIGEST_PIECE = 1 << 27  # mask elements digested at once (2 GB of int64 indices at most)


def mask_digest(torch, mask) -> tuple:
    """(size, how many True, the sum of their flat indices) of a mask, taken
    where it lies (on the card for the records below)."""
    flat, pieces = mask.reshape(-1), []
    for lo in range(0, flat.numel(), DIGEST_PIECE):
        part = flat[lo:lo + DIGEST_PIECE]
        idx = torch.arange(part.numel(), device=part.device, dtype=torch.int64)
        pieces.append((part.numel(), int(part.sum()), int((idx * part).sum())))
    return join_digests(pieces)


def join_digests(parts) -> tuple:
    """One mask's digest from its consecutive parts' digests."""
    n = count = index_sum = 0
    for size, c, s in parts:
        n, count, index_sum = n + size, count + c, index_sum + s + n * c
    return (n, count, index_sum)


class KinkDigest(KinkReplay):
    """A `KinkReplay` record that keeps, of each call's mask, only its
    `mask_digest`: the tensor-parallel ranks of phase 22 send it back
    instead of 2 GB of masks."""

    def _keep(self, mask):
        return mask_digest(self.torch, mask)

    def _join(self, parts):
        return join_digests(parts)


class KinkRecord(KinkReplay):
    """A `KinkReplay` record whose calls also keep their `mask_digest`,
    taken while each mask is still on the card: `digests` after `split`."""

    def _keep(self, mask):
        return mask.cpu(), mask_digest(self.torch, mask)

    def _join(self, parts):
        return self.torch.cat([m for m, _ in parts]), join_digests([d for _, d in parts])

    def split(self) -> None:
        """Masks (for `replay`) and digests apart, once a record is done."""
        self.digests = {k: [d for _, d in v] for k, v in self.masks.items()}
        self.masks = {k: [m for m, _ in v] for k, v in self.masks.items()}


def kink_digests_apart(got: dict, want: dict) -> dict:
    """By kind, (calls whose digests differ, the sum over calls of |True
    counts apart|, calls), or None where the call counts or sizes differ:
    0 calls apart means the same side at every kink up to a swap that keeps
    both the count and the index sum."""
    out = {}
    for kind in KinkReplay.KINDS:
        a, b = got[kind], want[kind]
        if len(a) != len(b) or any(x[0] != y[0] for x, y in zip(a, b)):
            out[kind] = None
            continue
        out[kind] = (sum(x != y for x, y in zip(a, b)),
                     sum(abs(x[1] - y[1]) for x, y in zip(a, b)), len(a))
    return out


class _TorchWith:
    """The torch module with some of its functions replaced."""

    def __init__(self, torch, **over):
        self._torch, self._over = torch, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._torch, name)


class _Stack:
    """Several `_Patched` as one context."""

    def __init__(self, patches):
        self.patches = patches

    def __enter__(self):
        for p in self.patches:
            p.__enter__()

    def __exit__(self, *exc):
        for p in reversed(self.patches):
            p.__exit__(*exc)


class _Patched:
    """Sets a module's attributes for the span of a `with` and restores
    them."""

    def __init__(self, module, **attrs):
        self.module, self.attrs, self.saved = module, attrs, {}

    def __enter__(self):
        for k, v in self.attrs.items():
            self.saved[k] = getattr(self.module, k)
            setattr(self.module, k, v)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            setattr(self.module, k, v)


def k3_left_out():
    """The control of phase 21's training gate: C's backward on the card
    with k3 left out of its sums t (as a graph-encoder backward that drops
    a term would be); the gate must fail it."""
    from digat_tpu_torch.ops import gat_scores as GS

    bwd = GS.gat_scores_bwd_any
    return _Patched(GS, gat_scores_bwd_any=lambda k1, k2, k3, a, g: bwd(k1, k2, k3 * 0, a, g))


def training_parity(torch, cfg, corpus, dev, failures, nrms: bool = False, label: str = "",
                    word_embedding=None, act_bf16: bool = False, steps: int = 3,
                    norm_limit: float = 0.0):
    """Phase 9 (MSA-DIGAT, dedup batches), phase 13 (NRMS-SA, plain batches),
    phase 18 (each variant, `label`; two steps) and phases 20-21 (bf16):
    `steps` steps at B 8, full width, dropout on, from the same weights
    (`word_embedding` the word table where given), batches and seeds on the
    card and on the CPU
    plain path; for DIGAT the CPU takes the card's side at each ReLU kink of
    Eq. (8) (`KinkReplay`; the kinks are counted). `act_bf16`: the model's
    activations are bf16 (phase 21), so every tensor takes the
    one-bf16-ulp-of-its-largest-element rule that the contexts' weights take
    at bf16; for DIGAT the card runs once more with k3 left out of C's
    backward (`k3_left_out`), a control that the same gate must fail.
    `norm_limit` (phase 24 at bf16): each step-1 gradient gated by its
    |card - cpu| / |cpu| in norm instead, the elementwise rule printed."""
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.models.model import CorpusTables, Model
    from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import step_seed, train_step

    B = 8
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(SEED))
    cap = 0 if nrms else \
        B * ((1 + cfg.negative_sample_num) * cfg.news_graph_size + cfg.max_history_num)
    split = corpus.splits["train"]
    batches = list(batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg, B,
        epoch_seed=SEED + 1, news_node_id=None if nrms else corpus.news_node_id,
        dedup_titles=cap))[:steps]

    def run(device):
        generator = torch.Generator().manual_seed(SEED + 7)
        if nrms:
            model = NRMSModel(cfg, device=device, generator=generator)
            tables = NRMSTables.from_arrays(corpus.nrms_tables(), device)
        else:
            model = Model(cfg, device=device, generator=generator,
                          word_embedding=word_embedding)
            tables = CorpusTables.from_arrays(corpus.tables(), device)
        opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
        losses, grads = [], None
        for k, b in enumerate(batches):
            losses.append(float(train_step(model, opt, tables, batching.to_device(b, device),
                                           step_seed(SEED, 1, k), cfg.lr)))
            if k == 0:
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return losses, grads

    kinks = KinkReplay(torch)
    control, secs = None, {}

    def timed(what, device):
        t0 = time.perf_counter()
        out = run(device)
        secs[what] = time.perf_counter() - t0
        return out

    if nrms:
        l_gpu, g_gpu = timed("card", dev)
        l_cpu, g_cpu = timed("cpu", torch.device("cpu"))
    else:
        with kinks.record():
            l_gpu, g_gpu = timed("card", dev)
        if act_bf16:
            with k3_left_out():
                control = timed("control", dev)
        with kinks.replay():
            l_cpu, g_cpu = timed("cpu", torch.device("cpu"))
    b16 = cfg.compute_dtype == "bfloat16"
    rel = lambda g_a, n, g: grad_rel(torch, n, g_a[n], g, b16, act_bf16)
    # the DIGAT graph encoder on bf16 activations (phase 21): the losses
    # within one bf16 ulp of their scale, the gradients within
    # BF16_ACT_GRAD_RTOL; elsewhere TRAIN_RTOL
    bf16_graph = act_bf16 and not nrms
    loss_limit = BF16_SLICE_RTOL if bf16_graph else TRAIN_RTOL
    grad_limit = BF16_ACT_GRAD_RTOL if bf16_graph else TRAIN_RTOL

    def loss_err(la):
        return max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(la, l_cpu))

    def worst(g_a):
        return max(rel(g_a, n, g) for n, g in g_cpu.items()) / grad_limit

    def norm_rel(g_a):
        return max(float((g_a[n] - g).norm()) / max(float(g.norm()), 1e-30)
                   for n, g in g_cpu.items())

    rows = sorted(((rel(g_gpu, n, g), float((g_gpu[n] - g).abs().max()), float(g.abs().max()), n)
                   for n, g in g_cpu.items()), reverse=True)
    err = loss_err(l_gpu)
    name = label or ('NRMS-SA' if nrms else 'MSA-DIGAT')
    say(f"  {label + ': ' if label else ''}losses card {[round(v, 7) for v in l_gpu]} "
        f"cpu {[round(v, 7) for v in l_cpu]}; "
        f"max loss err {err:.3e} (limit {loss_limit:g} * max(1, |cpu|)); step-1 "
        f"gradients of {len(g_cpu)} tensors, max |card - cpu| "
        + (("beyond one bf16 ulp of the tensor's max " if act_bf16 else
            "beyond one bf16 ulp of the element (of the tensor's max for the contexts' "
            "weights) ") if b16 else "")
        + f"/ max |cpu| per tensor: worst {rows[0][0]:.3e} (limit {grad_limit:g}); smallest "
        f"max |cpu| {min(r[2] for r in rows):.3e} ({min(rows, key=lambda r: r[2])[3]}); "
        f"largest |card - cpu| / |cpu| in norm {norm_rel(g_gpu):.3e}"
        + ("" if nrms else f"; kinks where the CPU took the card's side against its own: "
           f"{kinks.summary()}")
        + "; seconds " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    for err_rel, e, top, n in rows[:4]:
        say(f"    {n}: max |cpu| {top:.3e} max |card - cpu| {e:.3e} relative {err_rel:.3e}")
    grads_ok = norm_rel(g_gpu) <= norm_limit if norm_limit else rows[0][0] <= grad_limit
    if norm_limit:
        say(f"    gradients gated in norm: {norm_rel(g_gpu):.3e} (limit {norm_limit:.3e})")
    if not (err <= loss_limit and grads_ok and np.isfinite(l_gpu).all()):
        failures.append(f"{name} training parity card vs cpu")
    if control is not None:
        c_err, c_worst = loss_err(control[0]), worst(control[1])
        caught = c_err > loss_limit or c_worst > 1.0
        say(f"    control, k3 left out of C's backward on the card: max loss err {c_err:.3e}, "
            f"worst gradient {c_worst * grad_limit:.3e}, in norm {norm_rel(control[1]):.3e}: "
            + ("fails the gate, as it must" if caught else "PASSES the gate"))
        if not caught:
            failures.append(f"{name} training parity: the control passed the gate")


# Kernels A and A' at titles shorter than 32 (the lanes past L idle): the
# parity matrix's L 16 at its widths, and an odd L at the production widths
# whose N * L rows are 1 past a multiple of 4 (the weight gradients of A'
# sum over them as their K); title 0 all pad. (what, N, L, Din, heads, dk, A)
SHORT_TITLES = [("matrix L16", 4096, 16, 100, 10, 20, 64),
                ("odd L7", 1023, 7, 300, 16, 25, 256)]


def short_title_args(torch, dev, N, L, Din, heads, dk, A, seed):
    """Random encoder inputs and weights at one shape, title 0 all pad."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D = heads * dk
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
    x = r(N, L, Din)
    mask = torch.rand((N, L), generator=g, device=dev) < 0.75
    mask[0] = False
    return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
            r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
            r(A, sc=A ** -0.5))


def short_title_kernels(torch, dev, train: bool) -> dict:
    """Phase 3 (A, eval) or phase 7 (A with dropout 0.2, and A') at
    SHORT_TITLES: each against its plain version, the same bits on a second
    run; -> {kernel name: {shape: entry}}."""
    from digat_tpu_torch.ops import msa_encoder as ME

    out = {"msa_encoder_pooled": {}}
    if train:
        out["msa_encoder_bwd"] = {}
    for k, (what, N, L, Din, heads, dk, A) in enumerate(SHORT_TITLES):
        D, p, seed = heads * dk, 0.2 if train else 0.0, 555
        args = short_title_args(torch, dev, N, L, Din, heads, dk, A, SEED + 30 + k)
        name = f"{what} [{N},{L},{Din}] {heads}x{dk} A {A}"
        tag = f"{what} N{N}" + (f" dropout {p:g}" if train else "")
        try:
            fwd = lambda: ME.msa_encoder_pooled(*args, heads, p, seed, 1)
            e = check_kernel(
                torch, f"msa_encoder_pooled {name}" + (f" dropout {p:g}" if train else ""), fwd,
                lambda: ME.msa_encoder_pooled_plain(ME.drop_titles_plain(args[0], p, seed, 1),
                                                    *args[1:], heads),
                (), *msa_work(N, L, Din, D, A))
            again = torch.equal(fwd(), fwd())
            say(f"    same bits twice: {again}")
            e["ok"] = e["ok"] and again
        except Exception:
            traceback.print_exc()
            e = dict(ok=False)
        out["msa_encoder_pooled"][tag] = e
        if not train:
            continue
        try:
            dp = torch.randn((N, D), generator=torch.Generator(device=dev).manual_seed(SEED + k),
                             device=dev)
            bargs = (*args, dp, heads, p, seed, 1)
            e = check_kernel(torch, f"msa_encoder_bwd {name} dropout {p:g}", ME.msa_encoder_bwd,
                             ME.msa_encoder_bwd_plain, bargs, *msa_bwd_work(N, L, Din, D, A))
            again = all(torch.equal(a, b) for a, b in zip(ME.msa_encoder_bwd(*bargs),
                                                          ME.msa_encoder_bwd(*bargs)))
            say(f"    same bits twice, every output: {again}")
            e["ok"] = e["ok"] and again
        except Exception:
            traceback.print_exc()
            e = dict(ok=False)
        out["msa_encoder_bwd"][tag] = e
    return out


def parity_cells():
    """scripts/torch_parity_cells.py: the JAX study's cell settings, the
    corpus and GloVe writers, and the CLI's command line for a cell."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_parity_cells.py")
    spec = importlib.util.spec_from_file_location("torch_parity_cells", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def neighbour_lists_differ(card: dict, cpu: dict, tie: float) -> tuple:
    """(lists that differ card against CPU, those of them at near-ties: the
    same length, and the CPU's cosine at each place within `tie` of the
    card's)."""
    differ, near_tie = 0, 0
    for news_id, c in cpu.items():
        g = card[news_id]
        if [n for n, _ in g] == [n for n, _ in c]:
            continue
        differ += 1
        near_tie += len(g) == len(c) and all(abs(a[1] - b[1]) <= tie for a, b in zip(g, c))
    return differ, near_tie


def loader_native_vs_plain(cfg, roots, news_dict, sims, failures) -> tuple:
    """The native host loader (`digat_tpu_torch/native`) against its plain
    Python versions on the cell's own files: the GloVe file, each split's
    behaviors.tsv, and the BFS of the news graph over the lists mined on
    the CPU. Each pair must be equal (`np.array_equal`, dict equality);
    prints each one's native and plain host seconds. Returns the native
    graph."""
    from digat_tpu_torch.data import corpus as C
    from digat_tpu_torch.data import sag
    from digat_tpu_torch.data import tokenize as tok

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t0

    report = []
    (stoi, vecs), t_nat = timed(tok.load_glove_txt, cfg.glove_path, cfg.word_embedding_dim)
    (pstoi, pvecs), t_py = timed(tok._load_glove_txt_py, cfg.glove_path, cfg.word_embedding_dim)
    same = stoi == pstoi and np.array_equal(vecs, pvecs)
    report.append(("glove", f"{len(stoi)} x {vecs.shape[1]}", t_nat, t_py, same))
    for split in C.SPLITS:
        path = os.path.join(roots[split], "behaviors.tsv")
        got, t_nat = timed(C._parse_behaviors, path, news_dict)
        want, t_py = timed(C._parse_behaviors_py, path, news_dict)
        same = sorted(got) == sorted(want) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
        report.append((f"behaviors {split}", f"{len(got['cand_offsets']) - 1} rows", t_nat,
                       t_py, same))
    args = (sims, news_dict, cfg.SAG_neighbors, cfg.SAG_hops, cfg.news_graph_size)
    graph, t_nat = timed(sag.expand_graph, *args)
    plain, t_py = timed(sag.expand_graph, *args, use_native=False)
    same = all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(graph, plain))
    report.append(("SAG BFS", f"{len(news_dict)} news, G {cfg.news_graph_size}", t_nat, t_py,
                   same))
    for what, size, t_nat, t_py, same in report:
        say(f"  loader {what} ({size}): native {t_nat:.4f}s plain {t_py:.4f}s, "
            f"native == plain {same}")
        if not same:
            failures.append(f"loader: native {what} differs from its plain version")
    return graph


def sag_card_vs_cpu(torch, cfg, failures) -> None:
    """The news graph's neighbour lists mined on the card against the same
    lists mined on the CPU: a list may differ only where the CPU's cosines
    at each of its places lie within 1e-6 of the card's (a near-tie of the
    fp32 sums); and the graph the CLI cached (built on the card) against
    the graph expanded from the CPU's lists. The native loader is held
    against its plain versions on the way (`loader_native_vs_plain`)."""
    from digat_tpu_torch.data import corpus as C
    from digat_tpu_torch.data import sag

    p = C._paths(cfg)
    with open(p["dicts"], encoding="utf-8") as f:
        dicts = json.load(f)
    roots = {s: os.path.join(cfg.data_root, cfg.dataset, s) for s in C.SPLITS}
    rows = C._rows_by_category(roots, dicts["category"])
    sims = {d: sag.mine_similarity(rows, dicts["news"], cfg.SAG_neighbors,
                                   exclude_test_from_corpus=cfg.dataset != "MIND-large",
                                   seed=cfg.seed, device=d) for d in ("cuda", "cpu")}
    differ, near_tie = neighbour_lists_differ(sims["cuda"], sims["cpu"], 1e-6)
    node_id, graph, mask = loader_native_vs_plain(cfg, roots, dicts["news"], sims["cpu"],
                                                  failures)
    graph = graph | np.eye(cfg.news_graph_size, dtype=bool)[None]
    cached = np.load(p["graph"])
    graph_rows = int(((cached["news_node_id"] != node_id).any(1)
                      | (cached["news_graph"] != graph).any((1, 2))
                      | (cached["news_graph_mask"] != mask).any(1)).sum())
    say(f"  SAG card vs cpu: {len(sims['cpu'])} neighbour lists, {differ} differ, {near_tie} of "
        f"them at near-ties (cosines within 1e-6); cached graph rows differing from the CPU's "
        f"{graph_rows}")
    if differ != near_tie:
        failures.append(f"SAG: {differ - near_tie} neighbour lists differ card vs cpu beyond "
                        f"near-ties")


def cli_cell(torch, cells, cell, workdir, gate, failures, sag_check=False, epochs=0,
             launched=False) -> dict:
    """Phases 14, 15 and 19: one cell of scripts/torch_parity_cells.py through
    `digat_tpu_torch.cli.main` on the card, seed 0 (`epochs` of them, 0: the
    cell's own count): the corpus from the port's generator, its GloVe file
    and cache (the SAG mined on the card), then the train run with the
    launch counters reset; `launched` (phase 14): the train run with
    torchrun's environment of one rank, so through `init_distributed`, NCCL
    at world 1 and the data-parallel step. Checks the run's
    files, every epoch's rank file against the official scorer, a
    standalone `--mode test` run of best.ckpt (one process) against the
    auto-test (1e-6) and the best dev AUC against `gate`."""
    from digat_tpu_torch import cli
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.parallel import dist as dist_lib

    t0 = time.perf_counter()
    corpus_dir = cells.prepare_cell(cell, workdir, "cuda")
    flags = cells.cell_flags(cell, corpus_dir, 0, "cuda", epochs)
    cfg = Config.from_args(flags)
    prep_s = time.perf_counter() - t0
    if sag_check:
        sag_card_vs_cpu(torch, cfg, failures)
    reset_counters()
    t0 = time.perf_counter()
    joined, init = [], dist_lib.init_distributed
    dist_lib.init_distributed = lambda *a, **k: joined.append(init(*a, **k)) or joined[-1]
    try:
        with _Env(launcher_env(0, 1, free_port()) if launched else {}):
            rec = cli.main(flags)
    finally:
        dist_lib.init_distributed = init
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    ctx = joined[0]
    say(f"  through init_distributed: backend {ctx.backend}, world {ctx.world}, device "
        f"{ctx.device}")
    if launched and (ctx.backend, ctx.world) != ("nccl", 1):
        failures.append(f"{cell}: launched at world 1 but joined {ctx.backend} world {ctx.world}")
    keys = ("auc", "mrr", "ndcg5", "ndcg10")
    name = "NRMS-SA" if cfg.model_family == "nrms" else cfg.model_name
    results = os.path.join(cfg.run_root, "results", cfg.dataset, name)
    truth = os.path.join(cfg.run_root, "dev", cfg.dataset, "ref", "truth.txt")
    scorer_err = 0.0
    for h in rec["history"]:
        got = M.scoring_from_files(truth, os.path.join(rec["run_dir"],
                                                       f"dev-epoch{h['epoch']}.txt"))
        scorer_err = max(scorer_err, max(abs(a - h[k]) for a, k in zip(got, keys)))
        say(f"  epoch {h['epoch']}: loss {h['loss']:.4f} dev auc {h['auc']:.4f} mrr "
            f"{h['mrr']:.4f} ndcg5 {h['ndcg5']:.4f} ndcg10 {h['ndcg10']:.4f}; "
            f"{len(h['step_ms'])} steps, median step {np.median(h['step_ms']):.3f} ms")
    steps = [t for h in rec["history"] for t in h["step_ms"][2:]]
    best = max(h["auc"] for h in rec["history"])
    retest = cli.main(flags + ["--mode", "test", "--test_model_path",
                               os.path.join(rec["run_dir"], "best.ckpt")])
    test_err = max(abs(a - b) for a, b in zip(retest, rec["test"])) if rec["test"] else math.inf
    files = all(os.path.exists(os.path.join(results, f"#{rec['run_index']}-{s}"))
                for s in ("dev", "test"))
    say(f"  {cell}: L {cfg.max_title_length}, {cfg.MSA_head_num} x {cfg.MSA_head_dim} heads, "
        f"B {cfg.batch_size}, lr {cfg.lr:g}, {cfg.epoch} epochs; preparation {prep_s:.2f}s, "
        f"train + dev + test wall {wall:.2f}s, median step {np.median(steps):.3f} ms; best dev "
        f"auc {best:.4f} (gate {gate}) at epoch {rec['best_epoch']}; test "
        f"{np.round(rec['test'], 4).tolist() if rec['test'] else None}, again from best.ckpt "
        f"within {test_err:.2e}; official scorer within {scorer_err:.2e}; #N-dev and #N-test "
        f"written {files}")
    say(f"  launches: {launches}")
    # the kernels of the cell's model: C and B where it has interactive layers
    need = ["msa_encoder_pooled", "msa_encoder_bwd", "embedding_grad", "dropout"]
    if cfg.model_family == "digat" and interactive_layers(cfg):
        need += ["gat_scores_fwd", "gat_scores_bwd", "interactive_gat_layer_fused"]
    for k in need:
        if launches[k] == 0:
            failures.append(f"{cell}: kernel {k} was launched no time")
    if not (files and test_err <= 1e-6 and scorer_err <= 1e-6 and best >= gate
            and all(np.isfinite(h["loss"]) for h in rec["history"])):
        failures.append(f"{cell}: files {files}, test again {test_err:.2e}, scorer "
                        f"{scorer_err:.2e}, best dev auc {best:.4f} (gate {gate})")
    return launches


def attention_work(N, L, heads, dk, rs, backward: bool):
    """The attention pair: 4 N H L^2 dk FLOP forward (q k^T and a v), 10
    backward (the scores again, do v^T, ds k, ds^T q and a^T do), against
    q, k, v (and do) read and out (dq, dk, dv) written once, each [N, L, rs]
    in its layout, and the mask read once."""
    flops = (10 if backward else 4) * N * heads * L * L * dk
    return flops, 4 * N * L * rs * (7 if backward else 4) + N * L


def ptxas_report(build, needle: str) -> dict:
    """Registers and spill bytes of every kernel whose mangled name holds
    `needle`, from the build's `nvcc.log` (`-Xptxas -v`): mangled name ->
    (registers, spill stores, spill loads)."""
    import re

    log = build.BUILD_DIR / "nvcc.log"
    report, name, spills = {}, None, (0, 0)
    for line in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if needle in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name] = (int(m.group(1)), *spills)
    return report


# The kernels whose SASS the smoke reads: each names one source's ELF file in
# the library (A, A' and B: their products; A'' at bf16: its integer
# instructions; C's bf16 forward: its score loop).
SASS_OWNERS = ("msa_pool_fwd_kernel", "msa_attn_relu_fix_kernel", "gat_layer_attend_kernel",
               "dropout_bf16_kernel", "msa_attention_bf16_", "gat_scores_fwd_bf16_kernel")


@functools.lru_cache(maxsize=2)
def library_sass(path: str) -> str:
    """The SASS (`cuobjdump -sass`) of the library's ELF files that hold a
    kernel of SASS_OWNERS, each after a "Fatbin elf code" line as a dump of
    the whole library prints them; read once a run. The ELF files are
    extracted (`-xelf all`) and only those disassembled, all at once: the
    fp32 and wide attention pair's many instantiations are not."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([tool, "-xelf", "all", os.path.abspath(path)], cwd=tmp,
                       capture_output=True, text=True, timeout=300)
        names = []
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name), "rb") as f:
                raw = f.read()
            if any(owner.encode() in raw for owner in SASS_OWNERS):
                names.append(name)
        dump = lambda name: subprocess.run([tool, "-sass", os.path.join(tmp, name)],
                                           capture_output=True, text=True, timeout=300).stdout
        with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
            parts = [f"Fatbin elf code: {name}\n{sass}"
                     for name, sass in zip(names, pool.map(dump, names))]
    tool_time("cuobjdump", t0)
    return "\n".join(parts)


def sass_tensor_core_check(build) -> dict:
    """Tensor-core instructions in each instantiation of the product kernels
    of tc_gemm.cuh and tc_wgmma.cuh in the built library, read with
    `cuobjdump -sass`: label -> (instruction the product must issue,
    count). The fp32 products (gemm_kernel: 3xTF32) must issue TF32 HMMA;
    the bf16 products of A, A' and B's two bf16 instances (wg_gemm_kernel)
    the warpgroup HGMMA on bf16.
    Each source's code is its own ELF section of the library; a product is
    labelled by its kernel (A, A' or B: the section that holds that
    kernel's own pool, ReLU-fix or attend kernel) and its template
    arguments."""
    import re

    sass = library_sass(str(build.library_path()))
    owners = {"msa_pool_fwd_kernel": "A", "msa_attn_relu_fix_kernel": "A'",
              "gat_layer_attend_kernel": "B"}
    epilogues = ["store", "bias", "pool", "dh", "dropout", "logits"]
    types = {"f": "fp32", "13__nv_bfloat16": "bf16", "S2_": "bf16"}
    tf32, hgmma = r"HMMA\.\S*TF32", r"HGMMA\.\S*BF16"
    counts = {}
    for section in re.split(r"^Fatbin elf code", sass, flags=re.M):
        owner = next((o for marker, o in owners.items() if marker in section), "?")
        name = None
        for line in section.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                name = None
                k = re.search(r"2tc11gemm_kernelILb([01])ELb([01])ELi(\d+)ELi(\d)ELb([01])E"
                              r"(f|13__nv_bfloat16)E", m.group(1))
                w = re.search(r"2wg14wg_gemm_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELi(\d)ELi(\d)"
                              r"ELi(\d)E(f|13__nv_bfloat16)Lb([01])E", m.group(1))
                if k:
                    name = (f"{owner}: A fp32 {'K' if k.group(1) == '1' else 'M'}-major, B "
                            f"fp32 {'K' if k.group(2) == '1' else 'N'}-major (3xTF32), C "
                            f"{types[k.group(6)]}, BN {k.group(3)}, "
                            f"{epilogues[int(k.group(4))]} epilogue"
                            + (", k-tile sums rounded to nearest" if k.group(5) == "1" else ""))
                    counts[name] = [tf32, 0]
                elif w:
                    major = lambda bit, other: "K" if bit == "1" else other
                    name = (f"{owner}: wgmma, A {w.group(5)} bf16 term(s) "
                            f"{major(w.group(3), 'M')}-major, B {w.group(6)} "
                            f"{major(w.group(4), 'N')}-major, C {types[w.group(8)]}, BN "
                            f"{w.group(1)}{' x 2 side by side' if w.group(9) == '1' else ''}, "
                            f"k-tile {w.group(2)}, {epilogues[int(w.group(7))]} epilogue")
                    counts[name] = [hgmma, 0]
                continue
            if name and re.search(counts[name][0], line):
                counts[name][1] += 1
    kinds = {tf32: "HMMA TF32", hgmma: "HGMMA BF16"}
    out = {label: (kinds[pat], n) for label, (pat, n) in counts.items()}
    out.update(pair_bf16_sass(sass))
    return out


# the bf16 register-row pair's kernels (csrc/msa_attention_bf16.cu and
# msa_attention_bf16_long.cu): 5 kinds x 4 widths x even or odd head offsets
PAIR_BF16_KERNELS = 40


def pair_bf16_sass(sass: str) -> dict:
    """bf16 tensor-core instructions in each instantiation of the pair's bf16
    register-row kernels: label -> ("HMMA 16816.F32.BF16", count)."""
    import re

    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*msa_attention_bf16_(fwd|bwd|fwd_long|bwd_long)_kernel"
                      r"ILi(\d)E((?:Lb[01]E)+)", line)
        if m:
            bools = re.findall(r"Lb([01])E", m.group(3))
            kind = m.group(1) + ({"1": " short", "0": " mid"}[bools[1]] if m.group(1) == "bwd"
                                 else "")
            name = (f"pair bf16: {kind}, dk padded to {8 * int(m.group(2))}, "
                    f"{'even' if bools[0] == '1' else 'odd'} head offsets")
            counts[name] = ("HMMA 16816.F32.BF16", 0)
            continue
        if re.search(r"Function : ", line):
            name = None
        elif name and re.search(r"HMMA\.16816\.F32\.BF16", line):
            counts[name] = (counts[name][0], counts[name][1] + 1)
    return counts


# the product instantiations of kernels A, A' and B, as
# sass_tensor_core_check labels them: on mma.sync (tc_gemm.cuh) fp32 A' six,
# A two, B one; on wgmma (tc_wgmma.cuh) bf16 A two (q|k|v and the pool
# logits), A' seven (q|k|v, u, dW1, dO, dx with and without the dropout
# mask, dWqkv), B two (the bf16-activation projections, one bf16 term; the
# bf16-weight ones, x's three terms)
PRODUCT_KERNELS = 19


def redesign_report(build) -> bool:
    """Prints ptxas's registers and spills of the kernels of A, A', A'', B,
    C and D and the SASS check that the products of A, A' and B issue
    tensor-core instructions (TF32, or the warpgroup's bf16 for the bf16 x
    bf16 products), and the instructions of the bf16 Eq. (8) score loop;
    False if a product kernel issues none of its kind or B's two bf16
    instances' projections are not on wgmma."""
    ok = True
    for needle in ("tc11gemm_kernel", "wg14wg_gemm_kernel", "msa_attn_",
                   "msa_pool", "split3", "relayout", "gat_scores_", "gat_layer_", "dropout_",
                   "emb_grad_"):
        for mangled, (n_regs, st, ld) in sorted(ptxas_report(build, needle).items()):
            say(f"  ptxas {mangled[:90]}: {n_regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")
    counts = sass_tensor_core_check(build)
    for label, (kind, n) in counts.items():
        say(f"  SASS {label}: {n} {kind} instructions")
    wgmma = [label for label, (kind, _) in counts.items() if kind.startswith("HGMMA")]
    pair = [label for label in counts if label.startswith("pair bf16:")]
    if len(counts) - len(pair) < PRODUCT_KERNELS or not all(n for _, n in counts.values()) or \
            sum(label.startswith("A:") for label in wgmma) < 2 or \
            sum(label.startswith("A':") for label in wgmma) < 7 or \
            sum(label.startswith("B:") for label in wgmma) < 2 or \
            len(pair) != PAIR_BF16_KERNELS:
        say("  SASS check FAILED: a product kernel of A, A' or B, or a kernel of the pair's "
            "bf16 register-row instance, issues no tensor-core instruction of its kind, or one "
            "of A's two, A''s seven or B's two wgmma products or of the pair's forty bf16 "
            "kernels is missing")
        ok = False
    for kernel, n in score_loop_sass(build).items():
        say(f"  SASS {kernel}: " + ", ".join(f"{k} {v}" for k, v in n.items()))
    return ok


def score_loop_sass(build) -> dict:
    """The instructions of the Eq. (8) score loop (gat_score_tile.cuh `sweep`,
    shared by C's bf16 forward and B's fused bf16-activation kernel) in C's
    bf16 forward at R 4 with 16-byte copies: the static counts of FADD,
    FMNMX, FFMA and LDS.128 in the loop body (from the first to the last
    FFMA that reads an absolute value, |R..|, which only the loop issues),
    and their sum per score element (one such FFMA an element)."""
    import re

    sass = library_sass(str(build.library_path()))
    out = {}
    body = re.search(r"Function : \S*gat_scores_fwd_bf16_kernelILi4ELb1E\S*(.*?)"
                     r"(?:Function : |\Z)", sass, flags=re.S)
    if body is None:
        return {"gat_scores_fwd_bf16_kernel<4, true>": {"found": 0}}
    lines = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9.]*)([^;]*);",
                       body.group(1))
    marks = [i for i, (op, args) in enumerate(lines) if op.startswith("FFMA") and "|" in args]
    loop = [op for op, _ in lines[marks[0]:marks[-1] + 1]] if marks else []
    n = {k: sum(op.startswith(k) for op in loop) for k in ("FADD", "FMNMX", "FFMA")}
    n["LDS.128"] = sum(op.startswith("LDS.128") for op in loop)
    n["others"] = len(loop) - sum(n.values())
    n["issued an element"] = round(len(loop) / max(1, len(marks)), 3)
    out["score loop of gat_scores_fwd_bf16_kernel<4, true>"] = n
    return out


# The INT32 issue rate of an H100 SXM: 64 integer lanes an SM a clock (half
# the fp32 lanes), 132 SMs at the 1.98 GHz boost clock: integer
# instructions (per thread) a second. A card below 700 W runs slower.
PEAK_INT32_OPS = 132 * 64 * 1.98e9


def dropout_bf16_int_ops(build) -> float:
    """Integer instructions an element of A''s bf16 instance, from the SASS
    of its 16-byte kernel (`dropout_bf16_kernel<2>`, two Philox blocks, eight
    elements a thread): its integer-pipe instructions (IMAD, IADD3, LOP3,
    SHF, ISETP, SEL, LEA, VIADD, PRMT and their variants) over the two
    blocks' eight elements; the one-group tail's few are counted too, so
    the count errs high."""
    import re

    sass = library_sass(str(build.library_path()))
    body = re.search(r"Function : \S*dropout_bf16_kernelILi2E\S*(.*?)(?:Function : |\Z)", sass,
                     flags=re.S)
    if body is None:
        raise RuntimeError("no dropout_bf16_kernel<2> in the library's SASS")
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", body.group(1))
    ints = sum(op in ("IMAD", "IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "VIADD", "PRMT",
                      "IABS", "IMNMX") for op in ops)
    return ints / 8


# The pair's wide instance (dk 65-128) at the shapes phases 10 and 21 time it:
# 4 x 128 heads at L 32 (MSA titles with such heads), 2 x 128 at L 160 (past
# the 128 of A), 4 x 80 at L 64; and the titles of a B-64 training step of
# NRMS-SA at 4 x 100 heads (the new path's, phase 24). (what, N, L, heads, dk)
WIDE_SHAPES = [("wide heads dk 128", 2048, 32, 4, 128),
               ("wide heads dk 128, L > 128", 256, 160, 2, 128),
               ("wide heads dk 80", 512, 64, 4, 80)]
WIDE_SPLIT = (256, 160)  # (N, L) of the wide shape whose stages are traced
WIDE_NRMS = dict(nrms_head_num=4, nrms_head_dim=100)  # phase 24's NRMS-SA heads
# Phase 24's bf16 step, card against CPU: each step-1 gradient within one
# bf16 ulp (2^-8) of the CPU's in norm. Phase 21's elementwise rule (one
# ulp of the tensor's largest element, then 1e-3) is printed, not gated:
# at 4 x 100 heads one bf16 rounding of a large dq element on either side
# moves W_Q's and W_K's gradients by more than an ulp of their largest, and
# the plain attention on the card fails it as the kernel does on this
# corpus (5.8e-3 and 6.7e-3 of 1e-3; both 0 on three other corpora).
WIDE_BF16_GRAD_NORM = 2.0 ** -8


def n_train_titles(cfg) -> int:
    """Titles of one NRMS training step at cfg's batch: the candidates with
    their augmented neighbours, and the history."""
    B = cfg.batch_size
    return B * (1 + cfg.negative_sample_num) * (1 + cfg.augmented_news_num) \
        + B * cfg.max_history_num


def pair_registers(build) -> dict:
    """ptxas's registers and spills of every instantiation of the pair, from
    the build's log: (kernel, W, float4 loads, dtype) -> (registers, spill
    stores, spill loads). The wide instance's kernels are `fwd_wide`,
    `bwd_wide_stats`, `bwd_wide_cols` and `bwd_wide_dq` (W 128). The bf16
    register-row instance's are `bf16_fwd`, `bf16_bwd_short`, `bf16_bwd_mid`
    (resident), `bf16_fwd_long` and `bf16_bwd_long` (streamed), W the padded
    width and the third item "even head offsets" (its copy width is chosen at
    run time)."""
    import re

    from digat_tpu_torch.ops import msa_attention as MA

    regs = {}
    for mangled, report in sorted(ptxas_report(build, "msa_attention_").items()):
        m = re.search(r"msa_attention_bf16_(fwd|bwd|fwd_long|bwd_long)_kernel"
                      r"ILi(\d)E((?:Lb[01]E)+)", mangled)
        if m:
            bools = re.findall(r"Lb([01])E", m.group(3))
            kind = "bf16_" + m.group(1) + ({"1": "_short", "0": "_mid"}[bools[1]]
                                           if m.group(1) == "bwd" else "")
            regs[kind, 8 * int(m.group(2)), bools[0] == "1", "bf16"] = report
            continue
        m = re.search(r"msa_attention_(fwd|bwd|bwd_long|fwd_wide|bwd_wide_rows|bwd_wide_cols)"
                      r"_kernelI(?:Li(\d+)E)?((?:Lb[01]E)+)(f|13__nv_bfloat16)E", mangled)
        if not m:
            continue
        bools = re.findall(r"Lb([01])E", m.group(3))
        kind = m.group(1)
        if kind == "bwd_wide_rows":
            kind = "bwd_wide_dq" if bools[0] == "1" else "bwd_wide_stats"
        dtype = "fp32" if m.group(4) == "f" else "bf16"
        regs[kind, int(m.group(2) or MA.WIDE), bools[-1] == "1", dtype] = report
    return regs


def say_pair_registers(regs) -> None:
    for (kind, W, vec, dtype), (n_regs, st, ld) in sorted(regs.items()):
        how = (f"{'even' if vec else 'odd'} head offsets" if kind.startswith("bf16_")
               else f"{'float4' if vec else 'scalar'} loads")
        say(f"  ptxas {kind} W {W} {dtype} {how}: {n_regs} registers, spill stores {st} B, "
            f"spill loads {ld} B")


def pair_entry(by_shape: dict, main: str) -> dict:
    """A kernels-line entry of the pair from its shapes' checks: the largest
    error over the shapes, the main shape's fwd + bwd times and bound, its
    SDPA forward and backward as `library_ms`."""
    shape = by_shape.get(main, {})
    ok = shape.get("ok")
    pair = lambda key: (shape["fwd"][key] + shape["bwd"][key]) if ok else None
    return dict(
        ok=bool(by_shape) and all(v.get("ok") for v in by_shape.values()),
        max_abs_err=max((max(v["fwd"]["max_abs_err"], v["bwd"]["max_abs_err"])
                         for v in by_shape.values() if v.get("ok")), default=math.inf),
        ms=pair("ms"), plain_ms=pair("plain_ms"), bound_ms=pair("bound_ms"),
        bound_by=shape["fwd"]["bound_by"] if ok else None,
        library_ms=shape["bwd"]["library_ms"] if ok else None,
        main_shape=main, by_shape=by_shape)


def attention_kernels(torch, cfg, dev):
    """Phase 10: the attention pair (E and F) forward and backward against its
    plain version at the NRMS-SA shapes, packed and head-padded, and its wide
    instance (dk 65-128) at WIDE_SHAPES and at the titles of an NRMS-SA
    4 x 100 training step, each key mask with an all-masked sequence (the
    pad news). Yardsticks: `scaled_dot_product_attention` with an additive
    float mask, forward (`library_ms` of the fwd entry), forward with its
    autograd backward (`library_ms` of the bwd entry, as in the kernels
    line) and its backward alone on a kept graph (`library_bwd_ms`).
    `device_ms` is the C entry point's own time: CUDA events around 20
    back-to-back launches on preallocated outputs, without the wrapper's
    host path; the wide backward's three launches by stage at WIDE_SPLIT.
    -> (register-row entry, wide entry)."""
    import torch.nn.functional as F

    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import msa_attention as MA

    heads, dk = cfg.nrms_head_num, cfg.nrms_head_dim
    L_t, L_u = cfg.max_title_length, cfg.max_history_num
    n_titles = n_train_titles(cfg)
    bs = cfg.effective_eval_batch_size()
    wide_nrms = ("NRMS-SA 4 x 100 titles, training step", n_titles, L_t,
                 WIDE_NRMS["nrms_head_dim"], WIDE_NRMS["nrms_head_num"],
                 WIDE_NRMS["nrms_head_dim"])
    shapes = [  # (name, N, L, head stride[, heads, dk])
        ("titles, serving chunk", bs, L_t, dk),
        ("titles, training step", n_titles, L_t, dk),
        ("user, serving batch", bs, L_u, dk),
        ("user, training step", cfg.batch_size, L_u, dk),
        ("titles, E layout dkp 32", bs, L_t, 32),
        ("user, E layout dkp 64", bs, L_u, 64),
        ("F only (L > 128)", 256, 150, dk),
        *((what, N, L, d, H, d) for what, N, L, H, d in WIDE_SHAPES),
        wide_nrms,
    ]
    sm_smem = torch.cuda.get_device_properties(dev).shared_memory_per_multiprocessor
    all_regs = pair_registers(build)
    say_pair_registers(all_regs)
    regs = {(kind, W, vec): r[0] for (kind, W, vec, dtype), r in all_regs.items()
            if dtype == "fp32"}
    by_shape, wide_shapes = {}, {}
    for what, N, L, hs, *width in shapes:
        heads, dk = width or (cfg.nrms_head_num, cfg.nrms_head_dim)
        name = f"{what} [{N},{L},{heads}x{hs}]"
        wide = MA.head_width(dk) == MA.WIDE
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + N + L + hs)
            rs = heads * hs
            q, k, v, do = (F.pad(torch.randn((N, L, heads, dk), generator=g, device=dev),
                                 (0, hs - dk)).reshape(N, L, rs) for _ in range(4))
            mask = torch.rand((N, L), generator=g, device=dev) < 0.8
            mask[:, 0] = True
            mask[0] = False
            bias = torch.zeros((N, 1, 1, L), device=dev).masked_fill(~mask[:, None, None, :],
                                                                    -1e9)
            heads_view = lambda t: t.view(N, L, heads, hs).transpose(1, 2)
            sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                heads_view(a), heads_view(b), heads_view(c), attn_mask=bias,
                scale=1.0 / math.sqrt(dk))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            do_view = heads_view(do)
            fwd = check_kernel(
                torch, f"msa_attention fwd {name}",
                lambda *a: MA.attention_fwd(*a, heads, dk),
                lambda a, b, c, m: MA.attention_plain_strided(a, b, c, heads, dk, m),
                (q, k, v, mask), *attention_work(N, L, heads, dk, rs, False),
                library=lambda a, b, c, m: sdpa(a, b, c))
            bwd = check_kernel(
                torch, f"msa_attention bwd {name}",
                lambda *a: MA.attention_bwd(*a, heads, dk),
                lambda *a: MA.attention_bwd_plain(*a, heads, dk),
                (q, k, v, mask, do), *attention_work(N, L, heads, dk, rs, True),
                library=lambda *a: torch.autograd.grad(sdpa(*leaves), leaves, do_view))
            kept = sdpa(*leaves)
            bwd["library_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                kept, leaves, do_view, retain_graph=True))
            del kept
            out, dq, dkk, dv = (torch.empty_like(q) for _ in range(4))
            scale = 1.0 / math.sqrt(float(dk))
            with build.launch_on(dev) as (lib, stream):
                fwd["device_ms"] = device_ms(torch, lambda: lib.msa_attention_fwd_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                    N, heads, L, dk, rs, hs, scale, stream))
                bwd["device_ms"] = device_ms(torch, lambda: lib.msa_attention_bwd_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(),
                    dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(), N, heads, L, dk, rs, hs, scale,
                    stream))
            plan = MA.launch_plan([t.data_ptr() for t in (q, k, v, do, dq)], rs, hs, dk)
            for entry, backward in ((fwd, False), (bwd, True)):
                kernel = ("bwd_long" if L > MA.SHORT_L else "bwd") if backward else "fwd"
                kinds = [kernel]
                if wide:
                    kinds = ["bwd_wide_stats", "bwd_wide_cols", "bwd_wide_dq"] if backward \
                        else ["fwd_wide"]
                n_regs = [regs.get((kind, *plan)) for kind in kinds]
                warps, shared = MA.block_shape(L, dk, backward, sm_smem, n_regs[0] or 0)
                entry["block"] = dict(kernel="+".join(kinds), width=plan[0], float4=plan[1],
                                      registers=n_regs if wide else n_regs[0], warps=warps,
                                      shared_bytes=shared)
            say(f"    device_ms (20 launches of the C entry): fwd {fwd['device_ms']:.4f} bwd "
                f"{bwd['device_ms']:.4f}; SDPA bwd alone {bwd['library_bwd_ms']:.4f}; "
                f"blocks: fwd {fwd['block']}, bwd {bwd['block']}")
            if wide:  # its products run on the tensor cores at 3xTF32
                for entry, backward in ((fwd, False), (bwd, True)):
                    work = attention_work(N, L, heads, dk, rs, backward)
                    say_bound_3xtf32(work, work[0], entry["bound_ms"])
            if wide and (N, L) == WIDE_SPLIT:
                stages = stage_split(torch, lambda: MA.attention_bwd(q, k, v, mask, do, heads,
                                                                     dk))
                say_stages(f"the wide backward {name}", stages)
                bwd["stages"] = stages
            pads = all(not t.reshape(N, L, heads, hs)[..., dk:].any()
                       for t in (MA.attention_fwd(q, k, v, mask, heads, dk),
                                 *MA.attention_bwd(q, k, v, mask, do, heads, dk)))
            first, second = (MA.attention_bwd(q, k, v, mask, do, heads, dk) for _ in range(2))
            again = all(torch.equal(a, b) for a, b in zip(first, second))
            say(f"    pad lanes zero: {pads}; the same backward bits twice: {again}")
            (wide_shapes if wide else by_shape)[name] = dict(
                fwd=fwd, bwd=bwd, ok=fwd["ok"] and bwd["ok"] and pads and again)
        except Exception:
            traceback.print_exc()
            (wide_shapes if wide else by_shape)[name] = dict(ok=False)
    heads, dk = cfg.nrms_head_num, cfg.nrms_head_dim
    wide_main = f"{wide_nrms[0]} [{n_titles},{L_t},{wide_nrms[4]}x{wide_nrms[3]}]"
    return (pair_entry(by_shape, f"titles, training step [{n_titles},{L_t},{heads}x{dk}]"),
            pair_entry(wide_shapes, wide_main))


def nrms_tables_for(torch, cfg, tables, seed: int):
    """The NRMS tables over a corpus's titles: M augmented neighbours per
    news drawn from a seed, a fifth of them the pad news 0, none for news 0."""
    from types import SimpleNamespace

    dev = tables.news_title_text.device
    n = tables.news_title_text.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    aug = torch.randint(1, n, (n, cfg.augmented_news_num), generator=g, device=dev)
    aug[torch.rand(aug.shape, generator=g, device=dev) < 0.2] = 0
    aug[0] = 0
    return SimpleNamespace(news_title_text=tables.news_title_text,
                           news_title_mask=tables.news_title_mask, augmented_news=aug)


def nrms_serving(torch, cfg, model, ntables, imps, dev, failures):
    """Phase 11: `NRMSCachedScorer` over the seeded corpus with the launch
    counters reset (stage 1 one forward launch per chunk, stage 2 one per
    batch, no backward), then a smaller corpus on the card against the CPU
    plain path."""
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.eval.scorer import NRMSCachedScorer
    from digat_tpu_torch.models.nrms import NRMSModel

    hist, cat, imp_index, cand, labels = imps
    bs = cfg.effective_eval_batch_size()
    news_num = ntables.news_title_text.shape[0]
    chunks = -(-news_num // bs)
    scorer = NRMSCachedScorer(model, bs)
    reset_counters()
    scorer.cache_news(ntables)
    torch.cuda.synchronize()
    stage1 = read_counters()
    reset_counters()
    scores = scorer.score_items(ntables, hist, cat, imp_index, cand)
    launches = read_counters()
    tm = dict(scorer.timings)
    batches = tm["stage2_batches"]
    scorer.score_items(ntables, hist, cat, imp_index, cand)  # warm pass, timing only
    warm = scorer.timings
    auc, mrr, n5, n10 = M.score_impressions_flat(imp_index, labels, scores)
    say(f"  stage 1: {tm['stage1_s']:.3f}s ({news_num} news, warm {warm['stage1_s']:.3f}s); "
        f"stage 2: {tm['items'] / tm['stage2_s']:.1f} items/s ({tm['items']} items, {batches} "
        f"batches, warm {warm['items'] / warm['stage2_s']:.1f} items/s)")
    say(f"  attention launches: stage 1 alone {stage1['msa_attention_fwd']} (want {chunks}); "
        f"stage 1 + 2 fwd {launches['msa_attention_fwd']} (want {chunks} + {batches}), bwd "
        f"{launches['msa_attention_bwd']}; other kernels "
        f"{sum(v for k, v in launches.items() if not k.startswith('msa_attention'))}")
    say(f"  metrics on random weights: auc {auc:.4f} mrr {mrr:.4f} ndcg5 {n5:.4f} "
        f"ndcg10 {n10:.4f}")
    if not (scores.shape == (len(cand),) and np.isfinite(scores).all()):
        failures.append("NRMS-SA serving: scores not finite or of the wrong shape")
    if stage1["msa_attention_fwd"] != chunks or launches["msa_attention_fwd"] != chunks + batches \
            or launches["msa_attention_bwd"] != 0:
        failures.append("NRMS-SA serving did not run the attention kernel once per chunk and "
                        "once per stage-2 batch")
    # card against the CPU plain path on a smaller corpus
    small_news, small_bs = 2048, 256
    small = nrms_tables_for(torch, cfg, make_tables(torch, cfg, small_news, dev, SEED + 2),
                            SEED + 3)
    small_cpu = type(small)(**{k: t.cpu() for k, t in vars(small).items()})
    simps = make_impressions(cfg, small_news, 32, 8, SEED + 3)
    cpu_model = NRMSModel(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, m, t in (("gpu", model, small), ("cpu", cpu_model, small_cpu)):
            sc = NRMSCachedScorer(m, small_bs).score_items(t, *simps[:4])
            rank_file = os.path.join(tmp, f"{tag}.txt")
            M.write_rank_file(rank_file, M.group_by_impression(simps[2], sc))
            with open(rank_file, encoding="utf-8") as f:
                out[tag] = (sc, f.read())
    (s_gpu, r_gpu), (s_cpu, r_cpu) = out["gpu"], out["cpu"]
    err = float(np.abs(s_gpu - s_cpu).max())
    limit = SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
    say(f"  {small_news} news, {len(simps[3])} items: max |gpu - cpu| {err:.3e} (limit "
        f"{limit:.3e}); rank files identical {r_gpu == r_cpu}")
    if not (err <= limit and r_gpu == r_cpu and np.isfinite(s_gpu).all()):
        failures.append("NRMS-SA serving parity card vs cpu")
    return launches, tm, warm


def nrms_training(torch, cfg, model, corpus, run_dir, failures):
    """Phase 12: one `Trainer` epoch of NRMS-SA at B 64 (dropout, no dedup)
    with the launch counters reset: per step 4 forward and 4 backward
    attention launches (three title-tower calls and the user tower) and 7
    A'' dropouts, forward and backward; then the dev scoring's forward
    launches."""
    from digat_tpu_torch.train.trainer import Trainer

    trainer = Trainer(model, cfg, corpus, run_dir, verbose=False)
    reset_counters()
    (rec,) = trainer.train()
    launches = read_counters()
    steps = len(rec["step_losses"])
    bs = cfg.effective_eval_batch_size()
    dev_launches = -(-corpus.nrms_tables().news_title_text.shape[0] // bs) \
        + -(-len(corpus.dev_cand) // bs)
    want = {"msa_attention_fwd": 4 * steps + dev_launches, "msa_attention_bwd": 4 * steps,
            "dropout": 14 * steps, "keep_mask": 0}
    warm = float(np.median(rec["step_ms"][2:]))
    say(f"  {steps} steps at B {cfg.batch_size} (no dedup); step ms median after warm-up "
        f"{warm:.3f} (first {rec['step_ms'][0]:.3f}); train samples/s "
        f"{cfg.batch_size * 1e3 / warm:.1f} (epoch wall {rec['samples_per_s']:.1f})")
    say(f"  step losses: {[round(v, 6) for v in rec['step_losses']]}")
    say(f"  launches per step: attention fwd "
        f"{(launches['msa_attention_fwd'] - dev_launches) / steps:g}, bwd "
        f"{launches['msa_attention_bwd'] / steps:g}, A'' {launches['dropout'] / steps:g} "
        f"(7 sites forward and backward); "
        f"dev scoring: attention fwd {dev_launches}; other kernels "
        f"{sum(v for k, v in launches.items() if k not in want)}")
    if steps < NRMS_TRAIN_STEPS or not np.isfinite(rec["step_losses"]).all():
        failures.append("NRMS-SA training: too few steps or a loss not finite")
    for k, n in want.items():
        if launches[k] != n:
            failures.append(f"NRMS-SA training: {k} launched {launches[k]} times, want {n}")
    return launches, warm, steps


def wide_path_phase(torch, cfg, tables, dev, failures) -> dict:
    """Phase 24: the pair's wide instance on a model path. NRMS-SA at phase
    11's configuration but for 4 heads of dk 100 (D 400, DIGAT's news
    vector), so that `layers.mha` sends the title and user attentions to the
    wide instance; at fp32 and at compute_dtype bfloat16 (the title tower
    on its bf16 instance, the user tower on its fp32 one): the cached scorer
    over 1,024 news (64 impressions of 8) on the card with the counters
    reset, against the CPU plain path (fp32: phase 11's gate, 1e-4 of the
    score scale and the same rank file; bf16: phase 21's), and one B-8
    training step card against CPU with its launches counted: fp32 at
    phase 13's gates; bf16 the loss at phase 21's and each gradient within
    WIDE_BF16_GRAD_NORM of the CPU's in norm (phase 21's elementwise rule
    printed). -> launches by path."""
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.eval.scorer import NRMSCachedScorer
    from digat_tpu_torch.models.nrms import NRMSModel

    news_num, bs = 1024, 256
    chunks = -(-news_num // bs)
    small = nrms_tables_for(torch, cfg, head_tables(torch, tables, news_num), SEED + 90)
    small_cpu = type(small)(**{k: x.cpu() for k, x in vars(small).items()})
    imps = make_impressions(cfg, news_num, 64, 8, SEED + 91)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        c = replace(cfg, model_family="nrms", compute_dtype=dtype, **WIDE_NRMS)
        b16 = dtype == "bfloat16"
        tag = f"NRMS-SA {c.nrms_head_num} x {c.nrms_head_dim}{' bf16' if b16 else ''}"
        scores, ranks, serve = {}, {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for d, t in ((dev, small), ("cpu", small_cpu)):
                model = NRMSModel(c, device=d, generator=torch.Generator().manual_seed(SEED + 92))
                scorer = NRMSCachedScorer(model, bs)
                reset_counters()
                scores[d] = scorer.score_items(t, *imps[:4])
                if d != "cpu":
                    torch.cuda.synchronize()
                    serve = {k: v for k, v in read_counters().items() if v}
                    batches = scorer.timings["stage2_batches"]
                rank_file = os.path.join(tmp, f"{'cpu' if d == 'cpu' else 'card'}.txt")
                M.write_rank_file(rank_file, M.group_by_impression(imps[2], scores[d]))
                with open(rank_file, encoding="utf-8") as f:
                    ranks[d] = f.read()
        s_gpu, s_cpu = scores[dev], scores["cpu"]
        err = float(np.abs(s_gpu - s_cpu).max())
        limit = (BF16_SLICE_RTOL if b16 else SLICE_RTOL) * max(1.0, float(np.abs(s_cpu).max()))
        flips = 0
        for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                          M.group_by_impression(imps[2], s_cpu)):
            og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
            flips += sum(a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit
                         for a, b in zip(og, oc))
        # the title tower per stage-1 chunk (bf16 at bf16), the user tower
        # per stage-2 batch (fp32)
        want = {"msa_attention_wide_fwd_bf16" if b16 else "msa_attention_wide_fwd": chunks}
        want["msa_attention_wide_fwd"] = want.get("msa_attention_wide_fwd", 0) + batches
        same = ranks[dev] == ranks["cpu"]
        say(f"  {tag} serving: {len(imps[3])} items, max |card - cpu| {err:.3e} (limit "
            f"{limit:.3e}), " + (f"rank flips beyond ties {flips}" if b16 else
                                 f"rank files identical {same}") + f"; launches {serve}")
        if not (err <= limit and (flips == 0 if b16 else same) and np.isfinite(s_gpu).all()):
            failures.append(f"{tag} serving card vs cpu")
        if serve != want:
            failures.append(f"{tag} serving launches {serve}, want {want}")
        corpus = make_train_corpus(c, tables, 2 * c.batch_size, 2000, 32, SEED + 93)
        ntables = nrms_tables_for(torch, c, tables, SEED + 94)
        corpus.nrms_tables = lambda: ntables
        reset_counters()
        training_parity(torch, c, corpus, dev, failures, nrms=True, label=f"{tag}",
                        act_bf16=b16, steps=1, norm_limit=WIDE_BF16_GRAD_NORM if b16 else 0.0)
        step = {k: v for k, v in read_counters().items() if v}
        # three title-tower calls and the user tower, forward and backward;
        # A'' at the word and title sites as phase 12 (21 at bf16) counts them
        calls = {"msa_attention_wide_fwd_bf16": 3, "msa_attention_wide_bwd_bf16": 3,
                 "msa_attention_wide_fwd": 1, "msa_attention_wide_bwd": 1} if b16 else \
            {"msa_attention_wide_fwd": 4, "msa_attention_wide_bwd": 4}
        say(f"  {tag} training step launches: {step}")
        for k, n in calls.items():
            if step.get(k) != n:
                failures.append(f"{tag} training step: {k} launched {step.get(k)} times, want "
                                f"{n}")
        if any(k in step for k in ("msa_attention_fwd", "msa_attention_bwd",
                                   "msa_attention_fwd_bf16", "msa_attention_bwd_bf16")):
            failures.append(f"{tag}: the register-row pair ran at dk {c.nrms_head_dim}")
        runs[tag] = {"serving": serve, "training": step}
    return runs


# Kernels A and A' past the short unit (the long unit of msa_title.cuh): titles
# of 48, 64 and 128 at the production widths, about 131,072 rows each, and
# heads of dk 128 at L 32; title 0 all pad. (what, N, L, Din, heads, dk, A)
LONG_TITLES = [("L48", 2730, 48, 300, 16, 25, 256), ("L64", 2048, 64, 300, 16, 25, 256),
               ("L128", 1024, 128, 300, 16, 25, 256), ("dk128", 1024, 32, 300, 4, 128, 256)]


def long_title_kernels(torch, dev) -> dict:
    """Phase 16: kernels A (eval) and A' (dropout 0.2) at LONG_TITLES against
    their plain versions, the same bits on a second run, with their bounds
    (msa_work, msa_bwd_work) and device ms by launch at L 128; -> {kernel
    name: {shape: entry}}."""
    from digat_tpu_torch.ops import msa_encoder as ME

    out = {"msa_encoder_pooled": {}, "msa_encoder_bwd": {}}
    for k, (what, N, L, Din, heads, dk, A) in enumerate(LONG_TITLES):
        D, p, seed = heads * dk, 0.2, 777
        args = short_title_args(torch, dev, N, L, Din, heads, dk, A, SEED + 40 + k)
        name = f"{what} [{N},{L},{Din}] {heads}x{dk} A {A}"
        try:
            fwd = lambda: ME.msa_encoder_pooled(*args, heads)
            e = check_kernel(torch, f"msa_encoder_pooled {name}", fwd,
                             lambda: ME.msa_encoder_pooled_plain(*args, heads), (),
                             *msa_work(N, L, Din, D, A))
            e["ok"] = e["ok"] and torch.equal(fwd(), fwd())
            if what == "L128":
                stages = stage_split(torch, fwd)
                say_stages(f"msa_encoder_pooled {name}", stages)
                e["stages"] = [dict(kernel=kn, launches=n, device_ms=ms) for kn, n, ms in stages]
        except Exception:
            traceback.print_exc()
            e = dict(ok=False)
        out["msa_encoder_pooled"][f"{what} N{N}"] = e
        try:
            dp = torch.randn((N, D), generator=torch.Generator(device=dev).manual_seed(SEED + k),
                             device=dev)
            bargs = (*args, dp, heads, p, seed, 1)
            e = check_kernel(torch, f"msa_encoder_bwd {name} dropout {p:g}", ME.msa_encoder_bwd,
                             ME.msa_encoder_bwd_plain, bargs, *msa_bwd_work(N, L, Din, D, A))
            again = all(torch.equal(a, b) for a, b in zip(ME.msa_encoder_bwd(*bargs),
                                                          ME.msa_encoder_bwd(*bargs)))
            say(f"    same bits twice, every output: {again}")
            e["ok"] = e["ok"] and again
            if what == "L128":
                stages = stage_split(torch, lambda: ME.msa_encoder_bwd(*bargs))
                say_stages(f"msa_encoder_bwd {name}", stages)
                e["stages"] = [dict(kernel=kn, launches=n, device_ms=ms) for kn, n, ms in stages]
        except Exception:
            traceback.print_exc()
            e = dict(ok=False)
        out["msa_encoder_bwd"][f"{what} N{N} dropout {p:g}"] = e
    return out


def long_route(torch, dev, failures) -> dict:
    """Phase 17: MSA titles of L 160 at the production widths (group_size 0),
    through the news encoder as the model calls it: the attention pair,
    ReLU and the pool. Eval and a training forward and backward (dropout
    0.2) of 512 titles with the counters reset (A 0; the pair one forward
    and one backward; A'' the word dropout forward and backward; D once),
    the eval output and the training step's gradients on the card against
    the CPU; -> the training run's launches."""
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.models.model import Model

    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18,
                 max_title_length=160)
    models = {d: Model(cfg, device=d, generator=torch.Generator().manual_seed(SEED + 9))
              for d in (dev, "cpu")}
    g = torch.Generator().manual_seed(SEED + 10)
    text = torch.randint(0, cfg.vocabulary_size, (512, 160), generator=g)
    mask = torch.arange(160)[None, :] < torch.randint(1, 161, (512, 1), generator=g)
    mask[0] = False
    up = torch.randn((512, cfg.news_embedding_dim), generator=g)
    out = {}
    launches = {}
    for d, m in models.items():
        enc = m.news_encoder
        t, mk, u = text.to(d), mask.to(d), up.to(d)
        with torch.inference_mode():
            ev = enc(t, mk)
        reset_counters()
        m.zero_grad()
        (enc(t, mk, seed=21, site=0) * u).sum().backward()
        if d != "cpu":
            torch.cuda.synchronize()
            launches = read_counters()
        out[d] = (ev.cpu(), {n: p.grad.detach().cpu() for n, p in enc.named_parameters()})
    (ev_gpu, g_gpu), (ev_cpu, g_cpu) = out[dev], out["cpu"]
    err = float((ev_gpu - ev_cpu).abs().max())
    limit = KERNEL_RTOL * max(1.0, float(ev_cpu.abs().max()))
    worst = max(float((g_gpu[n] - gc).abs().max()) / max(float(gc.abs().max()), 1e-12)
                for n, gc in g_cpu.items())
    want = {"msa_encoder_pooled": 0, "msa_encoder_bwd": 0, "msa_attention_fwd": 1,
            "msa_attention_bwd": 1, "dropout": 2, "embedding_grad": 1}
    say(f"  L 160, 16 x 25 heads, 512 titles: eval max |card - cpu| {err:.3e} (limit "
        f"{limit:.3e}); training gradients, worst max |card - cpu| / max |cpu| {worst:.3e} "
        f"(limit {TRAIN_RTOL:g}); launches {launches}")
    if not (err <= limit and worst <= TRAIN_RTOL):
        failures.append("L 160 route card vs cpu")
    for k, n in want.items():
        if launches.get(k) != n:
            failures.append(f"L 160 route: {k} launched {launches.get(k)} times, want {n}")
    return launches


# The five DIGAT ablations and CNN-DIGAT at full width (phase 18): the
# production configuration with `graph_encoder` or the CNN news encoder
# (cnn_kernel_num 400, naive bank of window 3).
VARIANTS = [("wo_SA", dict(graph_encoder="wo_SA")), ("Seq_SA", dict(graph_encoder="Seq_SA")),
            ("wo_interaction", dict(graph_encoder="wo_interaction")),
            ("news_graph_wo_inter", dict(graph_encoder="news_graph_wo_inter")),
            ("user_graph_wo_inter", dict(graph_encoder="user_graph_wo_inter")),
            ("CNN-DIGAT", dict(news_encoder="CNN", cnn_kernel_num=400, cnn_method="naive",
                               cnn_window_size=3))]
VARIANT_STEPS = 5  # the median untraced step at B 64 is taken over steps 3-5
# Phase 21 runs its DIGAT models at graph depth 2 (production 3), and phase
# 18 its card-against-CPU checks (serving and the B-8 steps; its B-64 steps
# stay at 3): the depth loop's later layers and contexts still run, and the
# CPU sides of those checks, which set the smoke's time, shrink by a third.
CUT_DEPTH = 2
# Phase 18's card-against-CPU training steps: one (two until slice 13, whose
# phases 22-23 took the time): step 1's loss and every step-1 gradient are
# gated as before; the loss after an Adam step is left to phase 9's three
# MSA-DIGAT steps, whose optimizer the variants share. The CPU's steps set
# the phase's time (4.8-11.3 s a variant for two).
VARIANT_PARITY_STEPS = 1


def interactive_layers(cfg) -> int:
    """GAT layers a forward runs that are interactive (kernel B in eval, C in
    training)."""
    from digat_tpu_torch.models.graph_encoders import VARIANT_GATS

    return VARIANT_GATS[cfg.graph_encoder].count("interactive") * cfg.graph_depth


def variant_phase(torch, name, cfg, tables, dev, failures) -> dict:
    """Phase 18 for one variant: serving over 1,024 news and 64 impressions of
    8 on the card with the counters reset (stage 1 A once per chunk for MSA,
    none for CNN; stage 2 B once per interactive layer and batch) and
    against the CPU plain path (phase 6's gates); VARIANT_PARITY_STEPS B-8
    training steps
    card against CPU (phase 9's gates); both at CUT_DEPTH; then
    VARIANT_STEPS untraced steps at B 64 (production depth) with dedup and
    dropout, the counters reset: per step A and A' once
    (MSA), C forward and backward once per interactive layer, D once, A''
    twice per dropout site (whose shapes must be `mask_sites`'s), no B and
    no keep mask; -> launches by path, timings."""
    from digat_tpu_torch import layers
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.eval.scorer import CachedScorer
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import step_seed, train_step

    msa = cfg.news_encoder == "MSA"
    result = {}
    cut = replace(cfg, graph_depth=CUT_DEPTH)  # the card-against-CPU checks
    # serving: main path on the card, then card against the CPU
    news_num, bs = 1024, 256
    small = head_tables(torch, tables, news_num)
    imps = make_impressions(cfg, news_num, 64, 8, SEED + 12)
    models = {d: Model(cut, device=d, generator=torch.Generator().manual_seed(SEED + 13))
              for d in (dev, "cpu")}
    scores = {}
    for d, m in models.items():
        t = small if d != "cpu" else type(small)(*(x.cpu() for x in small))
        reset_counters()
        scorer = CachedScorer(m, bs)
        scores[d] = scorer.score_items(t, *imps[:4])
        if d != "cpu":
            serve = read_counters()
            batches = scorer.timings["stage2_batches"]
            want_a = -(-news_num // bs) if msa else 0
            want_b = interactive_layers(cut) * batches
            result["serving"] = {k: serve[k] for k in ("msa_encoder_pooled",
                                                       "interactive_gat_layer_fused")}
            if serve["msa_encoder_pooled"] != want_a or \
                    serve["interactive_gat_layer_fused"] != want_b:
                failures.append(f"{name} serving: A {serve['msa_encoder_pooled']} (want "
                                f"{want_a}), B {serve['interactive_gat_layer_fused']} (want "
                                f"{want_b})")
    s_gpu, s_cpu = scores[dev], scores["cpu"]
    err = float(np.abs(s_gpu - s_cpu).max())
    limit = SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
    flips = 0
    for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                      M.group_by_impression(imps[2], s_cpu)):
        og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
        flips += sum(a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit
                     for a, b in zip(og, oc))
    say(f"  {name} serving: {len(imps[3])} items, max |card - cpu| {err:.3e} (limit "
        f"{limit:.3e}), rank flips beyond ties {flips}; launches {result.get('serving')}")
    if not (err <= limit and flips == 0 and np.isfinite(s_gpu).all()):
        failures.append(f"{name} serving card vs cpu")
    del models
    # B-8 steps, card against the CPU
    corpus = make_train_corpus(cfg, tables, (VARIANT_STEPS + 2) * cfg.batch_size, 2000, 32,
                               SEED + 14)
    training_parity(torch, cut, corpus, dev, failures, label=name, steps=VARIANT_PARITY_STEPS)
    # untraced steps at B 64, dedup and dropout on
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED + 15))
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(SEED))
    split = corpus.splits["train"]
    cap = batching.estimate_dedup_capacity(split.history_idx, corpus.train_behavior_row,
                                           corpus.train_pos, neg, corpus.news_node_id,
                                           cfg.batch_size, seed=cfg.seed)
    batches = [b for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        cfg.batch_size, epoch_seed=SEED, news_node_id=corpus.news_node_id, dedup_titles=cap)
        if isinstance(b, batching.DedupTrainBatch)][:VARIANT_STEPS]
    from digat_tpu_torch.models.model import CorpusTables

    t = CorpusTables.from_arrays(tables, dev)
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    drawn, apply_dropout = Counter(), layers.apply_dropout

    def recording(x, rate, seed, site):
        drawn[(x.numel() // x.shape[-1], x.shape[-1], rate)] += 1
        return apply_dropout(x, rate, seed, site)

    layers.apply_dropout = recording
    reset_counters()
    step_ms, losses = [], []
    try:
        for k, b in enumerate(batches):
            b = batching.to_device(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(model, opt, t, b, step_seed(SEED, 1, k), cfg.lr)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        layers.apply_dropout = apply_dropout
    launches = read_counters()
    steps = len(batches)
    sites = mask_sites(cfg, cap)
    checked = Counter()
    for _, rows, cols, rate, per_step in sites:
        checked[(rows, cols, rate)] += per_step * steps
    n_int = interactive_layers(cfg)
    want = {"msa_encoder_pooled": steps if msa else 0, "msa_encoder_bwd": steps if msa else 0,
            "embedding_grad": steps, "gat_scores_fwd": n_int * steps,
            "gat_scores_bwd": n_int * steps,
            "dropout": 2 * sum(site[4] for site in sites) * steps, "keep_mask": 0,
            "interactive_gat_layer_fused": 0, "msa_attention_fwd": 0, "msa_attention_bwd": 0}
    median = float(np.median(step_ms[2:]))
    say(f"  {name} training: {steps} steps at B {cfg.batch_size} (dedup capacity {cap}), "
        f"median step {median:.3f} ms after 2 (first {step_ms[0]:.3f}); train samples/s "
        f"{cfg.batch_size * 1e3 / median:.1f}; losses {[round(v, 5) for v in losses]}; "
        f"launches per step {({k: v / steps for k, v in launches.items() if v})}")
    if steps < VARIANT_STEPS or not np.isfinite(losses).all():
        failures.append(f"{name} training: too few steps or a loss not finite")
    for k, n in want.items():
        if launches[k] != n:
            failures.append(f"{name} training: {k} launched {launches[k]} times, want {n}")
    if drawn != checked:
        failures.append(f"{name} training: A'' drew masks at {dict(drawn)}, want "
                        f"{dict(checked)}")
    result.update(training=launches, steps=steps, step_ms_median=median,
                  samples_per_s=cfg.batch_size * 1e3 / median, cap=cap)
    return result


# ---------------------------------------------------------------------------
# Phase 20: compute_dtype bfloat16 (MSA-DIGAT; the bf16 instances of A, A'
# and B). The work counts: the bf16 x bf16 products at the dense bf16 rate,
# the rest as the fp32 kernels' (fp32 CUDA-core rate), the bytes as each
# array's dtype gives them; A's and A''s products all at their wgmma bf16
# passes (`bound_bf16_passes`).
# ---------------------------------------------------------------------------
def bf16_bound(flops, bf16_flops, nbytes) -> tuple:
    """(least ms, what bounds it): bf16_flops (bf16 x bf16 products) at the
    dense bf16 rate plus the rest of `flops` at the fp32 rate, against the
    bytes at the memory rate."""
    t_ops = bf16_flops / PEAK_BF16_FLOPS + (flops - bf16_flops) / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# The fp32 issue rate of an H100 SXM: 128 fp32 lanes an SM a clock, 132 SMs
# at the 1.98 GHz boost clock (the 67 TFLOP/s counts each multiply-add as
# two): fp32 instructions (per thread) a second. A card below 700 W runs
# slower.
PEAK_FP32_ISSUE = 132 * 128 * 1.98e9


def bound_issue(fp32_instructions, bf16_flops, nbytes) -> tuple:
    """(least ms, what bounds it) of a kernel whose CUDA-core work is
    `fp32_instructions` issued fp32 instructions (each Eq. (8) element an
    FADD and an FFMA, each alpha h term an FFMA, as the SASS of
    `gat_score_tile.cuh`'s loop and the aggregation issue them:
    `score_loop_sass`) at the issue rate, plus `bf16_flops` of bf16 products
    at the dense bf16 rate, against its bytes at the memory rate."""
    t_ops = fp32_instructions / PEAK_FP32_ISSUE + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound_bf16_passes(flops, nbytes, products, pass_flops) -> tuple:
    """A bf16's and A' bf16's bound, (least ms, what bounds it): its products (`products`
    of its `flops`) as `pass_flops` of bf16 tensor-core passes at the dense
    bf16 rate plus the rest at the fp32 rate, against its bytes at the
    memory rate."""
    t_ops = pass_flops / PEAK_BF16_FLOPS + (flops - products) / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# Kernel A''s six products in launch order (csrc/msa_encoder_bwd.cu steps 2,
# 4, 6, 7, 9 and 10) and the tensor-core passes each takes in its bf16
# instance: on wgmma (tc_wgmma.cuh) q|k|v one bf16 pass, dW1 six, the rest
# three; on mma.sync (tc_gemm.cuh, until its redesign) q|k|v one bf16 pass,
# dW1 three TF32 passes, the rest two.
MSA_BWD_PRODUCTS = ("q|k|v", "u", "dW1", "dO", "dx", "dWqkv")


def product_rates(stages, products) -> list:
    """The product launches among `stage_split`'s stages (those whose kernel
    name holds "gemm", in launch order), matched in order with `products`
    [(what, FLOP, (passes, type) on wgmma, (passes, type) on mma.sync)] ->
    [(what, ms, TFLOP/s, passes, pass type, share of that type's dense peak
    counting passes)]."""
    rates = []
    for (name, _, ms), (what, flop, on_wg, on_mma) in zip(
            [st for st in stages if "gemm" in st[0]], products):
        passes, kind = on_wg if "wg_" in name else on_mma
        peak = PEAK_BF16_FLOPS if kind == "bf16" else PEAK_TF32_FLOPS
        tflops = flop / (ms * 1e-3) / 1e12
        rates.append((what, ms, tflops, passes, kind, passes * tflops * 1e12 / peak))
    return rates


def msa_bwd_product_rates(stages, N, L, Din, D, A) -> list:
    """product_rates of A''s bf16 instance (MSA_BWD_PRODUCTS)."""
    M = N * L
    flop = [2 * M * Din * 3 * D, 2 * M * D * A, 2 * M * A * D, 2 * M * A * D,
            2 * M * 3 * D * Din, 2 * M * 3 * D * Din]
    return product_rates(stages, [
        (what, f, (1 if i == 0 else 6 if i == 2 else 3, "bf16"),
         (1, "bf16") if i == 0 else (3 if i == 2 else 2, "tf32"))
        for i, (what, f) in enumerate(zip(MSA_BWD_PRODUCTS, flop))])


def msa_fwd_product_rates(stages, N, L, Din, D, A) -> list:
    """product_rates of A's bf16 instance: q|k|v one bf16 pass (on wgmma or
    mma.sync), the pool logits tanh(h W1^T + b1) v three bf16 passes on
    wgmma (h as three bf16 planes) or two TF32 passes on mma.sync."""
    M = N * L
    return product_rates(stages, [("q|k|v", 2 * M * Din * 3 * D, (1, "bf16"), (1, "bf16")),
                                  ("logits", 2 * M * D * A, (3, "bf16"), (2, "tf32"))])


def say_product_rates(rates) -> None:
    for what, ms, tflops, passes, kind, share in rates:
        say(f"      {what:6s} {ms:8.4f} ms {tflops:7.1f} TFLOP/s; {passes} {kind} passes: "
            f"{passes * tflops:7.1f} TFLOP/s, {100 * share:5.1f} % of the dense {kind} peak")
    total = sum(r[1] for r in rates)
    pass_tflop = sum(r[2] * r[3] * r[1] for r in rates) * 1e-3  # TFLOP of passes
    say(f"      the products {total:.4f} ms; over them "
        f"{pass_tflop / (total * 1e-3):.1f} TFLOP/s counting passes")


def msa_work_bf16(N, L, Din, D, A):
    """Kernel A's bf16 instance: msa_work's FLOP; x and the weight matrices
    read as bf16, the vectors and the output fp32."""
    flops, _ = msa_work(N, L, Din, D, A)
    nbytes = 2 * N * L * Din + N * L + 2 * (Din * 3 * D + D * A) + 4 * (3 * D + 2 * A) \
        + 4 * N * D
    return flops, nbytes


def msa_bwd_work_bf16(N, L, Din, D, A):
    """Kernel A''s bf16 instance: msa_bwd_work's FLOP; x read and dx written
    as bf16, the weight matrices read as bf16, dp, the vectors and every
    gradient of a weight fp32."""
    flops, _ = msa_bwd_work(N, L, Din, D, A)
    mats, vecs = Din * 3 * D + D * A, 3 * D + 2 * A
    nbytes = 4 * N * L * Din + N * L + 4 * N * D + 2 * mats + 4 * vecs + 4 * (mats + vecs)
    return flops, nbytes


def gat_work_bf16(B, G, D):
    """Kernel B with bf16 weights: gat_work's FLOP, the four D x D weights
    read as bf16."""
    flops, nbytes = gat_work(B, G, D)
    return flops, nbytes - 2 * 4 * D * D


def bf16_phase(torch, cfg, tables, hist, cat, imp_index, cand, cap, dev, failures,
               fp32_step_ms):
    """Phase 20: MSA-DIGAT at compute_dtype bfloat16. The bf16 instances of
    A (N 1,024 serving, N `cap` with dropout 0.2), A' (N `cap`, dropout 0.2)
    and B (B 1,024 at G 68 and 26) against their plain versions on the same
    bf16 inputs; the cached scorer over the corpus with the counters reset
    (stage 1 A's bf16 instance, stage 2 B's, no fp32 launch of either) and a
    smaller corpus card against CPU; three B-8 steps card against CPU; one
    Trainer epoch at B 64 (dedup, dropout 0.2) with its launches per step
    checked, its median step beside phase 8's. -> (kernels-line entries by
    name, launches by path)."""
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.eval.scorer import CachedScorer
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.ops import gat_layer as GL
    from digat_tpu_torch.ops import msa_encoder as ME

    bcfg = replace(cfg, compute_dtype="bfloat16")
    model = Model(bcfg, device=dev, generator=torch.Generator().manual_seed(SEED + 20))
    L, Din, D, A = cfg.max_title_length, cfg.word_embedding_dim, cfg.news_embedding_dim, \
        cfg.attention_dim
    heads, p, bs = cfg.MSA_head_num, cfg.dropout_rate, cfg.effective_eval_batch_size()
    params = model.compute_params()
    enc = "news_encoder.multiheadSelfattention."
    pool = "news_encoder.attention."
    w = (params[enc + "W_Q.weight"].t(), params[enc + "W_Q.bias"], params[enc + "W_K.weight"].t(),
         params[enc + "W_V.weight"].t(), params[enc + "W_V.bias"],
         params[pool + "affine1.weight"].t(), params[pool + "affine1.bias"],
         params[pool + "affine2.weight"][0])
    w = tuple(t.detach() for t in w)
    table = model.news_encoder.word_embedding.weight.detach()
    entries = {"msa_encoder_pooled_bf16": {}, "msa_encoder_bwd_bf16": {},
               "interactive_gat_layer_fused_bf16": {}}

    def guarded(name, tag, fn):
        try:
            entries[name][tag] = fn()
        except Exception:
            traceback.print_exc()
            entries[name][tag] = dict(ok=False)

    # ---- the kernels at full width ----
    def encoder(N, rate):
        x = table[tables.news_title_text[:N]].to(torch.bfloat16).contiguous()
        mask = tables.news_title_mask[:N].contiguous()
        fwd = lambda: ME.msa_encoder_pooled(x, mask, *w, heads, rate, 987, 0)
        flops, nbytes = msa_work_bf16(N, L, Din, D, A)
        qkv, pool_p = 2 * N * L * Din * 3 * D, 2 * N * L * D * A
        # the products on wgmma at the bf16 passes they take (q|k|v one, the
        # pool logits three: h as three bf16 planes)
        e = check_kernel(torch, f"msa_encoder_pooled bf16 [{N},{L},{Din}] dropout {rate:g}", fwd,
                         lambda: ME.msa_encoder_pooled_plain(x, mask, *w, heads, rate, 987, 0),
                         (), flops, nbytes,
                         bound_ms=bound_bf16_passes(flops, nbytes, qkv + pool_p,
                                                    qkv + 3 * pool_p))
        say(f"    bound_ms: the products at their wgmma bf16 passes (q|k|v one, the pool logits "
            f"three), the rest at the fp32 rate; with the pool product at the fp32 rate it would "
            f"be {bf16_bound(flops, qkv, nbytes)[0]:.4f} ms")
        again = torch.equal(fwd(), fwd())
        say(f"    same bits twice: {again}")
        e["ok"] = e["ok"] and again
        stages = stage_split(torch, fwd)
        say_stages(f"msa_encoder_pooled bf16 N {N}", stages)
        say("    its products:")
        say_product_rates(msa_fwd_product_rates(stages, N, L, Din, D, A))
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        return e

    guarded("msa_encoder_pooled_bf16", f"serving N{bs}", lambda: encoder(bs, 0.0))
    guarded("msa_encoder_pooled_bf16", f"training N{cap} dropout {p:g}", lambda: encoder(cap, p))

    def encoder_bwd():
        x = table[tables.news_title_text[:cap]].to(torch.bfloat16).contiguous()
        mask = tables.news_title_mask[:cap].contiguous()
        dp = torch.randn((cap, D), generator=torch.Generator(device=dev).manual_seed(SEED + 21),
                         device=dev)
        args = (x, mask, *w, dp, heads, p, 987, 0)
        flops, nbytes = msa_bwd_work_bf16(cap, L, Din, D, A)
        qkv, pool_p = 2 * cap * L * Din * 3 * D, 2 * cap * L * D * A
        # the products on the tensor cores at the bf16 passes they take
        # (q|k|v one, u, dO, dx and dWqkv three, dW1 six)
        passes = qkv + 3 * pool_p + 6 * pool_p + 3 * pool_p + 3 * qkv + 3 * qkv
        e = check_kernel(torch, f"msa_encoder_bwd bf16 [{cap},{L},{Din}] dropout {p:g} (dx bf16 "
                         f"+ 8 fp32 weight grads)", ME.msa_encoder_bwd, ME.msa_encoder_bwd_plain,
                         args, flops, nbytes,
                         bound_ms=bound_bf16_passes(flops, nbytes, 3 * qkv + 3 * pool_p, passes))
        say(f"    bound_ms: the products at their wgmma bf16 passes (q|k|v one, u, dO, dx and "
            f"dWqkv three, dW1 six), the rest at the fp32 rate; with all but q|k|v at the fp32 "
            f"rate it would be {bf16_bound(flops, qkv, nbytes)[0]:.4f} ms")
        again = all(torch.equal(a, b) for a, b in zip(ME.msa_encoder_bwd(*args),
                                                      ME.msa_encoder_bwd(*args)))
        say(f"    same bits twice, every output: {again}")
        stages = stage_split(torch, lambda: ME.msa_encoder_bwd(*args))
        say_stages("msa_encoder_bwd bf16", stages)
        say("    its products:")
        say_product_rates(msa_bwd_product_rates(stages, cap, L, Din, D, A))
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        e["ok"] = e["ok"] and again
        return e

    guarded("msa_encoder_bwd_bf16", f"training N{cap} dropout {p:g}", encoder_bwd)

    def gat(G):
        prefix = "news_graph_attention" if G <= cfg.news_graph_size else "user_graph_attention"
        wt = tuple(params[f"graph_encoder.{prefix}_{n}.0.weight"].t().detach()
                   for n in ("W", "ffn1", "ffn2", "ffn3"))
        gargs = (wt[0], params[f"graph_encoder.{prefix}_W.0.bias"].detach(), wt[1], wt[2], wt[3],
                 params[f"graph_encoder.{prefix}_ffn3.0.bias"].detach(),
                 params[f"graph_encoder.{prefix}_a.0.weight"][0].detach())
        g = torch.Generator(device=dev).manual_seed(SEED + 22 + G)
        xb = torch.randn((bs, G, D), generator=g, device=dev) * 0.5
        q = torch.randn((bs, D), generator=g, device=dev) * 0.5
        adj = (torch.rand((bs, G, G), generator=g, device=dev) < 0.25) \
            | torch.eye(G, dtype=torch.bool, device=dev)
        adj[0, 1] = False
        args = (xb, adj, q, *gargs)
        flops, nbytes = gat_work_bf16(bs, G, D)
        # by issue (2 fp32 instructions a score element, 1 an alpha h term)
        # with the projections at three bf16 passes (x's planes)
        e = check_kernel(torch, f"interactive_gat_layer_fused bf16 weights B={bs} G={G} D={D}",
                         GL.interactive_gat_layer_fused, GL.interactive_gat_layer_plain, args,
                         flops, nbytes,
                         bound_ms=bound_issue(3 * bs * G * G * D, 3 * gat_products(bs, G, D),
                                              nbytes))
        say(f"    bound at the fp32 rate (every FLOP on the CUDA cores): "
            f"{bound(flops, nbytes)[0]:.4f} ms; plan {GL.fused_plan(G, D)}")
        again = torch.equal(GL.interactive_gat_layer_fused(*args),
                            GL.interactive_gat_layer_fused(*args))
        say(f"    same bits twice: {again}")
        stages = stage_split(torch, lambda: GL.interactive_gat_layer_fused(*args))
        say_stages(f"interactive_gat_layer_fused bf16 G {G}", stages)
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        # x's planes, the two wgmma products and the fused step, and no
        # launch of C's forward, the attend step or an mma.sync product (a
        # trace that lost every launch shows nothing either way)
        names = [k for k, _, _ in stages]
        split_ok = not stages or (
            any("split3" in k for k in names) and
            sum(n for k, n, _ in stages if "wg_gemm" in k) == 2 and
            any("gat_layer_fused_kernel" in k for k in names) and
            not any("gat_scores" in k or "attend" in k or "tc::gemm" in k for k in names))
        if not split_ok:
            say("    stage split FAILED: want split3, two wgmma products and the fused kernel, "
                "and no C forward, attend or mma.sync product launch")
        elif not stages:
            say("    stage split empty: the trace lost the launches")
        e["ok"] = e["ok"] and again and split_ok
        return e

    for G in (cfg.user_graph_size, cfg.news_graph_size):
        guarded("interactive_gat_layer_fused_bf16", f"G{G} D{D}", lambda G=G: gat(G))
    for name, shapes in entries.items():
        if not all(v.get("ok") for v in shapes.values()):
            failures.append(f"kernel {name}")

    # ---- serving: the main path over the corpus, then card against CPU ----
    launches = {}
    try:
        news_num = tables.news_title_text.shape[0]
        scorer = CachedScorer(model, bs)
        reset_counters()
        scores = scorer.score_items(tables, hist, cat, imp_index, cand)
        serve = read_counters()
        tm = dict(scorer.timings)
        scorer.score_items(tables, hist, cat, imp_index, cand)  # warm pass, timing only
        warm = scorer.timings
        want = {"msa_encoder_pooled_bf16": -(-news_num // bs),
                "interactive_gat_layer_fused_bf16": 2 * cfg.graph_depth * tm["stage2_batches"],
                "msa_encoder_pooled": 0, "interactive_gat_layer_fused": 0}
        say(f"  bf16 stage 1: {tm['stage1_s']:.3f}s ({news_num} news, warm "
            f"{warm['stage1_s']:.3f}s); stage 2: {tm['items'] / tm['stage2_s']:.1f} items/s "
            f"(warm {warm['items'] / warm['stage2_s']:.1f} items/s); launches "
            f"{({k: serve[k] for k in want})} (want {want})")
        launches["serving"] = serve
        if not np.isfinite(scores).all() or any(serve[k] != n for k, n in want.items()):
            failures.append("bf16 serving: scores not finite or launches not the bf16 instances'")
        small_news, small_bs = 2048, 256
        small = make_tables(torch, cfg, small_news, dev, SEED + 23)
        imps = make_impressions(cfg, small_news, 32, 8, SEED + 24)
        out = {}
        for tag, d, t in (("gpu", dev, small), ("cpu", "cpu", type(small)(*(x.cpu() for x in small)))):
            m = Model(bcfg, device=d, generator=torch.Generator().manual_seed(SEED + 20))
            out[tag] = CachedScorer(m, small_bs).score_items(t, *imps[:4])
        s_gpu, s_cpu = out["gpu"], out["cpu"]
        err = float(np.abs(s_gpu - s_cpu).max())
        limit = SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
        flips = 0
        for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                          M.group_by_impression(imps[2], s_cpu)):
            og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
            flips += sum(a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit
                         for a, b in zip(og, oc))
        say(f"  bf16 serving, {small_news} news, {len(imps[3])} items: max |gpu - cpu| {err:.3e} "
            f"(limit {limit:.3e}); rank flips beyond ties {flips}")
        if not (err <= limit and flips == 0 and np.isfinite(s_gpu).all()):
            failures.append("bf16 serving parity card vs cpu")
    except Exception:
        traceback.print_exc()
        failures.append("bf16 serving")

    # ---- training: three B-8 steps card against CPU, then an epoch at B 64 ----
    corpus = make_train_corpus(bcfg, tables, (TRAIN_STEPS + 2) * cfg.batch_size, 2000, 32,
                               SEED + 25)
    try:
        training_parity(torch, bcfg, corpus, dev, failures, label="MSA-DIGAT bf16")
    except Exception:
        traceback.print_exc()
        failures.append("bf16 training parity")
    step_ms = None
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            _, step_ms, launches["training"] = training_slice(
                torch, replace(bcfg, epoch_override=1, dedup_titles=-1), model, corpus, run_dir,
                failures, label="bf16 training")
        say(f"  bf16 median step {step_ms:.3f} ms ({cfg.batch_size * 1e3 / step_ms:.1f} samples/s)"
            f"; fp32 (phase 8) {fp32_step_ms if fp32_step_ms is None else round(fp32_step_ms, 3)}"
            f" ms")
    except Exception:
        traceback.print_exc()
        failures.append("bf16 training slice")
    for name, shapes in entries.items():
        main = next(iter(shapes.values()), {})
        entries[name] = dict(main, by_shape=shapes,
                             ok=all(v.get("ok") for v in shapes.values()))
    return entries, launches, step_ms


# ---------------------------------------------------------------------------
# Phase 21: compute_dtype bfloat16 for NRMS-SA, NRMS, CNN-DIGAT and MSA at
# titles of L 160 (the bf16 instances of the attention pair, A'', B with bf16
# activations and C's forward). Bytes as each array's dtype gives them; the
# bf16 instances do their arithmetic in fp32 (the pair, A'', C) but for B's
# bf16 x bf16 projections, counted at the dense bf16 rate.
# ---------------------------------------------------------------------------
BF16_STEPS = 5  # untraced steps at B 64 per model; the median over steps 3-5
# Serving, card against CPU, where the representations are rounded to bf16
# (every phase-21 model): a score sums bf16 elements that the card's
# products may round to the neighbouring value, so one bf16 ulp of the
# score scale, 2^-8 * max(1, max |cpu score|), and the ranks must agree
# except between scores closer than twice that.
BF16_SLICE_RTOL = 2.0 ** -8
# Training, card against CPU, where the DIGAT graph encoder runs on bf16
# activations (phase 21's CNN-DIGAT and MSA at L 160), each side taking the
# card's side at every kink (`KinkReplay`): the losses within one bf16 ulp
# of their scale (BF16_SLICE_RTOL), each step-1 gradient beyond one bf16
# ulp of its tensor's largest element within BF16_ACT_GRAD_RTOL of it. Set
# from sound runs (scripts/variant_gradient_precision.py --bf16) and a
# control that must fail it (`k3_left_out`); PERF.md section 6 has both.
BF16_ACT_GRAD_RTOL = 2.0 ** -4
# CNN-DIGAT at bf16 draws a GloVe-scale word table (N(0, 0.3^2), the scale of
# the port's pseudo-GloVe rows, `data.tokenize._hash_vector`): with the
# N(0, 1) table of the bare init its random logits reach 1,500 (one bf16 ulp
# 8), the listwise softmax is decided by rounding, and card and CPU, each
# rounding sums of another order, pick different near-tied candidates.
GLOVE_SCALE = 0.3


def glove_table(cfg, seed: int):
    """A seeded [V, word dim] table at GLOVE_SCALE."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((cfg.vocabulary_size, cfg.word_embedding_dim))
            * GLOVE_SCALE).astype(np.float32)


def bf16_pair_kernels(torch, ncfg, dev):
    """The pair's bf16 instance, forward and backward, against its plain
    version (which upcasts, computes in fp32 and rounds once) at the NRMS
    title shapes (a training step's 6,720 titles, a serving chunk), the
    user tower's serving batch, titles of L 160 at 16 x 25 heads, and its
    wide instance at WIDE_SHAPES and the titles of an NRMS-SA 4 x 100
    training step, each masked with an all-masked sequence; SDPA on the
    same bf16 inputs as `library_ms`; the same bits twice, forward and
    backward; both instances' bound with their products at the dense bf16
    rate; the register-row instance's blocks (kernel, head group, rows,
    warps, units in flight, shared bytes) and the wide instance's; the wide
    backward's stages at WIDE_SPLIT (the register-row one is a launch each
    way); their kernels' bf16 registers and spills (ptxas). -> (register-row
    entry, wide entry)."""
    import torch.nn.functional as F

    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import msa_attention as MA

    bs = ncfg.effective_eval_batch_size()
    n_titles = n_train_titles(ncfg)
    heads, dk, L_t, L_u = ncfg.nrms_head_num, ncfg.nrms_head_dim, ncfg.max_title_length, \
        ncfg.max_history_num
    wide_nrms = ("NRMS-SA 4 x 100 titles, training step", n_titles, L_t,
                 WIDE_NRMS["nrms_head_num"], WIDE_NRMS["nrms_head_dim"])
    shapes = [("titles, training step", n_titles, L_t, heads, dk),
              ("titles, serving chunk", bs, L_t, heads, dk),
              ("user, serving batch", bs, L_u, heads, dk),
              ("MSA titles L 160", 256, 160, 16, 25),
              *WIDE_SHAPES, wide_nrms]
    regs = pair_registers(build)
    by_shape, wide_shapes = {}, {}
    for what, N, L, H, d in shapes:
        name = f"{what} [{N},{L},{H}x{d}]"
        wide = MA.head_width(d) == MA.WIDE
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + 50 + N + L)
            rs = H * d
            q, k, v, do = (torch.randn((N, L, rs), generator=g, device=dev).to(torch.bfloat16)
                           for _ in range(4))
            mask = torch.rand((N, L), generator=g, device=dev) < 0.8
            mask[:, 0] = True
            mask[0] = False
            bias = torch.zeros((N, 1, 1, L), device=dev, dtype=torch.bfloat16).masked_fill(
                ~mask[:, None, None, :], -1e9)
            view = lambda t: t.view(N, L, H, d).transpose(1, 2)
            sdpa = lambda a, b, c: F.scaled_dot_product_attention(
                view(a), view(b), view(c), attn_mask=bias, scale=1.0 / math.sqrt(d))
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            entry = {}
            for backward in (False, True):
                flops, nbytes = attention_work(N, L, H, d, rs, backward)
                nbytes = (nbytes - N * L) // 2 + N * L  # the rows bf16, the mask bytes
                # both instances' products are bf16 x bf16 on the tensor cores
                least = bf16_bound(flops, flops, nbytes)
                if backward:
                    e = check_kernel(
                        torch, f"msa_attention bf16 bwd {name}",
                        lambda *a: MA.attention_bwd(*a, H, d),
                        lambda *a: MA.attention_bwd_plain(*a, H, d), (q, k, v, mask, do),
                        flops, nbytes,
                        library=lambda *a: torch.autograd.grad(sdpa(*leaves), leaves, view(do)),
                        bound_ms=least)
                else:
                    e = check_kernel(
                        torch, f"msa_attention bf16 fwd {name}",
                        lambda *a: MA.attention_fwd(*a, H, d),
                        lambda a, b, c, m: MA.attention_plain_strided(a, b, c, H, d, m),
                        (q, k, v, mask), flops, nbytes, library=lambda a, b, c, m: sdpa(a, b, c),
                        bound_ms=least)
                entry["bwd" if backward else "fwd"] = e
            again = torch.equal(MA.attention_fwd(q, k, v, mask, H, d),
                                MA.attention_fwd(q, k, v, mask, H, d))
            if not wide:  # the bf16 register-row instance's blocks and their kernels
                vec = MA.launch_plan([t.data_ptr() for t in (q, k, v, do)], rs, d, d, 2)[1]
                for key in ("fwd", "bwd"):
                    kind = MA.bf16_kind(L, key == "bwd")
                    geom = MA.bf16_geometry(kind, L, H, d, vec)
                    stages = MA.bf16_stages(kind, L, H, d, vec)
                    kernel = "bf16_" + ("bwd_" + kind if key == "bwd" else kind)
                    entry[key]["block"] = dict(
                        kernel=kernel, copies16=vec, heads_a_group=geom[0], own_rows=geom[4],
                        warps=geom[5], units_in_flight=stages,
                        shared_bytes=MA._bf16_smem_bytes(kind, L, H, d, vec, stages),
                        registers=regs.get((kernel, MA.bf16_width(d), d % 2 == 0, "bf16")))
                    say(f"    {key} block {entry[key]['block']}")
            if wide:
                vec = MA.launch_plan([t.data_ptr() for t in (q, k, v, do)], rs, d, d, 2)[1]
                for key, kinds in (("fwd", ("fwd_wide",)),
                                   ("bwd", ("bwd_wide_stats", "bwd_wide_cols", "bwd_wide_dq"))):
                    entry[key]["block"] = dict(
                        kernel="+".join(kinds), float4=vec, warps=MA.WIDE_WARPS,
                        shared_bytes=MA._smem_bytes(L, d, key == "bwd", 2),
                        registers=[regs.get((kind, MA.WIDE, vec, "bf16")) for kind in kinds])
                    say(f"    {key} block {entry[key]['block']}")
                if (N, L) == WIDE_SPLIT:
                    entry["bwd"]["stages"] = stage_split(
                        torch, lambda: MA.attention_bwd(q, k, v, mask, do, H, d))
                    say_stages(f"the wide bf16 backward {name}", entry["bwd"]["stages"])
            again = again and all(torch.equal(a, b) for a, b in zip(
                MA.attention_bwd(q, k, v, mask, do, H, d),
                MA.attention_bwd(q, k, v, mask, do, H, d)))
            say(f"    same forward and backward bits twice: {again}")
            (wide_shapes if wide else by_shape)[name] = dict(
                entry, ok=entry["fwd"]["ok"] and entry["bwd"]["ok"] and again)
        except Exception:
            traceback.print_exc()
            (wide_shapes if wide else by_shape)[name] = dict(ok=False)
    return (pair_entry(by_shape, f"titles, training step [{n_titles},{L_t},{heads}x{dk}]"),
            pair_entry(wide_shapes, f"{wide_nrms[0]} [{n_titles},{L_t},{wide_nrms[3]}x"
                                    f"{wide_nrms[4]}]"))


def bf16_dropout_kernels(torch, ncfg, cap: int, dev):
    """A''s bf16 instance, forward and forward + backward, bit for bit against
    its plain version (x / bf16(keep), rounded once) at the NRMS title
    tower's word site (a training step's 6,720 titles of L 32 x 300) and the
    CNN's two sites over `cap` unique titles (words 300 wide, the bank's
    output 400); `F.dropout` on the same bf16 tensor as `library_ms`; the
    bound the larger of its bytes' time and its integer issue (the SASS
    count of `dropout_bf16_int_ops` at PEAK_INT32_OPS)."""
    import torch.nn.functional as F

    from digat_tpu_torch.ops import build
    from digat_tpu_torch.ops import dropout as DR

    B, L, p = ncfg.batch_size, ncfg.max_title_length, ncfg.dropout_rate
    n_titles = B * (1 + ncfg.negative_sample_num) * (1 + ncfg.augmented_news_num) \
        + B * ncfg.max_history_num
    sites = [("NRMS words", n_titles * L, ncfg.word_embedding_dim),
             ("CNN words", cap * L, ncfg.word_embedding_dim), ("CNN bank", cap * L, 400)]
    int_ops = dropout_bf16_int_ops(build)
    say(f"  dropout bf16: {int_ops:.3f} integer instructions an element (the SASS of its "
        f"16-byte kernel), at {PEAK_INT32_OPS / 1e12:.2f} T a second")
    by_shape = {}
    for what, rows, cols in sites:
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + rows)
            x = torch.randn((rows, cols), generator=g, device=dev).to(torch.bfloat16)
            gout = torch.randn((rows, cols), generator=g, device=dev).to(torch.bfloat16)
            flops, nbytes = dropout_work(rows, cols)
            # bytes (each element read and written once, 2 bytes) against the
            # integer issue of its Philox draws
            t_bytes, t_int = 4 * rows * cols / PEAK_BYTES, int_ops * rows * cols / PEAK_INT32_OPS
            e = check_kernel(torch, f"dropout bf16 {what} [{rows},{cols}] rate {p:g}",
                             lambda t: DR.dropout(t, p, 77, 5),
                             lambda t: DR.dropout_plain(t, p, 77, 5), (x,), flops, nbytes // 2,
                             exact=True, library=lambda t: F.dropout(t, p),
                             bound_ms=(max(t_bytes, t_int) * 1e3,
                                       "bytes" if t_bytes >= t_int else "operations"))
            say(f"    {e['ms'] / e['library_ms']:.3f} of F.dropout's time, "
                f"{e['ms'] / e['bound_ms']:.3f} times the bound (bytes {t_bytes * 1e3:.4f} ms, "
                f"integer issue {t_int * 1e3:.4f} ms)")
            leaf, ref = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
            DR.dropout(leaf, p, 77, 5).backward(gout)
            DR.dropout_plain(ref, p, 77, 5).backward(gout)
            same = torch.equal(leaf.grad, ref.grad)
            say(f"    backward the plain version's bits: {same}")
            by_shape[f"{what} [{rows},{cols}]"] = dict(e, ok=e["ok"] and same)
        except Exception:
            traceback.print_exc()
            by_shape[f"{what} [{rows},{cols}]"] = dict(ok=False)
    main = next(iter(by_shape.values()))
    return dict(main, ok=all(v.get("ok") for v in by_shape.values()), by_shape=by_shape)


def bf16_graph_kernels(torch, cfg, dev):
    """B with bf16 activations (x, query, weights and out bf16) at B 1,024, G
    68 and 26, and C's bf16 forward at B 320, G 68 and 26 (k1 and k2 column
    blocks of a bf16 y), against their plain versions (fp32 arithmetic from
    the bf16 values, one rounding); at G 68 each launch's device ms
    (`stage_split`). Bounds by issue (`bound_issue`), the FLOP-rate ones
    printed beside them; -> (B's entry, C's entry)."""
    from digat_tpu_torch.ops import gat_layer as GL
    from digat_tpu_torch.ops import gat_scores as GS

    D, bs = cfg.news_embedding_dim, cfg.effective_eval_batch_size()
    gat, scores = {}, {}
    for G in (cfg.user_graph_size, cfg.news_graph_size):
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + 60 + G)
            r = lambda *s, sc=1.0: (torch.randn(s, generator=g, device=dev) * sc).to(
                torch.bfloat16)
            adj = (torch.rand((bs, G, G), generator=g, device=dev) < 0.25) \
                | torch.eye(G, dtype=torch.bool, device=dev)
            adj[0, 1] = False
            sc = D ** -0.5
            args = (r(bs, G, D, sc=0.5), adj, r(bs, D, sc=0.5), r(D, D, sc=sc), r(D, sc=0.05),
                    r(D, D, sc=sc), r(D, D, sc=sc), r(D, D, sc=sc), r(D, sc=0.05), r(D, sc=sc))
            flops, _ = gat_work(bs, G, D)
            # x, query, out and the four weights bf16; the vectors read as bf16
            nbytes = 2 * bs * G * D + bs * G * G + 2 * bs * D + 2 * (4 * D * D + 3 * D) \
                + 2 * bs * G * D
            e = check_kernel(torch, f"interactive_gat_layer_fused bf16 activations B={bs} G={G} "
                             f"D={D}", GL.interactive_gat_layer_fused,
                             GL.interactive_gat_layer_plain, args, flops, nbytes,
                             bound_ms=bound_issue(3 * bs * G * G * D, gat_products(bs, G, D),
                                                  nbytes))
            say(f"    bound at the FLOP rate (4 FLOP a score element, 2 an alpha h term, at "
                f"67 TFLOP/s): {bf16_bound(flops, gat_products(bs, G, D), nbytes)[0]:.4f} ms; "
                f"plan {GL.fused_plan(G, D)}")
            again = torch.equal(GL.interactive_gat_layer_fused(*args),
                                GL.interactive_gat_layer_fused(*args))
            say(f"    same bits twice: {again}")
            e = dict(e, ok=e["ok"] and again)
            if G == cfg.user_graph_size:
                stages = stage_split(torch, lambda: GL.interactive_gat_layer_fused(*args))
                say_stages(f"B bf16 activations G {G}", stages)
                e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
            gat[f"G{G} D{D}"] = e
        except Exception:
            traceback.print_exc()
            gat[f"G{G} D{D}"] = dict(ok=False)
        try:
            B = cfg.batch_size * (1 + cfg.negative_sample_num)
            g = torch.Generator(device=dev).manual_seed(SEED + 70 + G)
            y = (torch.randn((B, G, 3 * D), generator=g, device=dev) * 0.3).to(torch.bfloat16)
            k3 = (torch.randn((B, D), generator=g, device=dev) * 0.3).to(torch.bfloat16)
            a = (torch.randn(D, generator=g, device=dev) * D ** -0.5).to(torch.bfloat16)
            k1, k2 = y[..., D:2 * D], y[..., 2 * D:]
            flops, nbytes = scores_work(B, G, D, False)
            e = check_kernel(torch, f"gat_scores_fwd bf16 B={B} G={G} D={D} "
                             f"{GS.tile_plan(G, 2, min_row_blocks=2)}", GS.gat_scores_fwd,
                             GS.gat_scores_fwd_plain, (k1, k2, k3, a), flops, nbytes // 2,
                             bound_ms=bound_issue(2 * B * G * G * D, 0, nbytes // 2))
            say(f"    bound at the FLOP rate (4 FLOP a score element at 67 TFLOP/s): "
                f"{bound(flops, nbytes // 2)[0]:.4f} ms")
            again = torch.equal(GS.gat_scores_fwd(k1, k2, k3, a), GS.gat_scores_fwd(k1, k2, k3, a))
            say(f"    same bits twice: {again}")
            e = dict(e, ok=e["ok"] and again)
            if G == cfg.user_graph_size:
                stages = stage_split(torch, lambda: GS.gat_scores_fwd(k1, k2, k3, a))
                say_stages(f"C bf16 forward B {B} G {G}", stages)
                e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
            scores[f"B{B} G{G}"] = e
        except Exception:
            traceback.print_exc()
            scores[f"B{B} G{G}"] = dict(ok=False)
    pick = lambda d: dict(next(iter(d.values())), ok=all(v.get("ok") for v in d.values()),
                          by_shape=d)
    return pick(gat), pick(scores)


def bf16_model_configs(cfg):
    """The four models of phase 21 at full width: (name, config). The DIGAT
    ones at CUT_DEPTH; MSA at L 160 also with a SAG of 3 neighbours over 2
    hops (10 nodes, production 26), which takes its B-8 batches from about
    1,440 unique titles of 160 positions to 800 for the CPU side."""
    ncfg = replace(cfg, model_family="nrms", compute_dtype="bfloat16")
    dcfg = replace(cfg, compute_dtype="bfloat16", graph_depth=CUT_DEPTH)
    return [("NRMS-SA", ncfg), ("NRMS", replace(ncfg, nrms_model="NRMS")),
            ("CNN-DIGAT", replace(dcfg, news_encoder="CNN", cnn_kernel_num=400,
                                  cnn_method="naive", cnn_window_size=3)),
            ("MSA L160", replace(dcfg, max_title_length=160, SAG_neighbors=3))]


def bf16_serving_want(name, cfg, news_num, bs, batches) -> dict:
    """Launches of one scorer pass at bf16: only the bf16 instances where the
    JAX package runs bf16 (the title tower, the CNN graph's B), the fp32
    pair for the NRMS user tower, B's bf16-weight instance behind the MSA
    encoder (fp32 activations)."""
    chunks = -(-news_num // bs)
    zero = {k: 0 for k in counters()}
    if cfg.model_family == "nrms":
        return dict(zero, msa_attention_fwd_bf16=chunks, msa_attention_fwd=batches)
    layers = interactive_layers(cfg) * batches
    if cfg.news_encoder == "CNN":
        return dict(zero, interactive_gat_layer_fused_bf16_act=layers)
    return dict(zero, msa_attention_fwd_bf16=chunks, interactive_gat_layer_fused_bf16=layers)


def bf16_step_want(cfg, cap) -> dict:
    """Launches per training step at bf16 (dropout on): the NRMS family's
    title-tower calls (3 for NRMS-SA, 2 for NRMS) on the bf16 pair and the
    user tower on the fp32 one, its word dropouts bf16 and the rest fp32;
    DIGAT's C forward (bf16 behind the CNN) and backward per interactive
    layer, D once, the pair once behind MSA at L 160, A'' per site in its
    dtype (`site_launches`)."""
    zero = {k: 0 for k in counters()}
    if cfg.model_family == "nrms":
        calls = 3 if cfg.nrms_model == "NRMS-SA" else 2
        return dict(zero, msa_attention_fwd_bf16=calls, msa_attention_bwd_bf16=calls,
                    msa_attention_fwd=1, msa_attention_bwd=1, dropout_bf16=2 * calls,
                    dropout=2 * (calls + (1 if calls == 3 else 0)))
    fp32, bf16 = site_launches(cfg, cap)
    n = interactive_layers(cfg)
    cnn = cfg.news_encoder == "CNN"
    return dict(zero, embedding_grad=1, gat_scores_bwd=n, dropout=fp32, dropout_bf16=bf16,
                **({"gat_scores_fwd_bf16": n} if cnn else
                   {"gat_scores_fwd": n, "msa_attention_fwd_bf16": 1,
                    "msa_attention_bwd_bf16": 1}))


def bf16_model_phase(torch, name, cfg, tables, dev, failures) -> dict:
    """Phase 21 for one model at compute_dtype bfloat16, full width (CNN-DIGAT
    with a GloVe-scale table): the cached scorer over 1,024 news (64
    impressions of 8) on the card with the counters reset
    (`bf16_serving_want`) and against the CPU plain path (BF16_SLICE_RTOL);
    B-8 steps card against CPU, three for NRMS and two for DIGAT
    (phase 20's gates, each tensor at one bf16 ulp of its largest element);
    BF16_STEPS untraced steps at B 64 (dropout 0.2; dedup for DIGAT) with
    the counters reset, their launches per step (`bf16_step_want`) and A''s
    shapes checked; -> launches by path and timings."""
    from digat_tpu_torch import layers
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.eval.scorer import CachedScorer, NRMSCachedScorer
    from digat_tpu_torch.models.model import CorpusTables, Model
    from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import step_seed, train_step

    nrms = cfg.model_family == "nrms"
    table = glove_table(cfg, SEED + 87) if cfg.news_encoder == "CNN" and not nrms else None
    result = {}
    news_num, bs = 1024, 256
    small = head_tables(torch, tables, news_num)
    if nrms:
        small = nrms_tables_for(torch, cfg, small, SEED + 80)
    imps = make_impressions(cfg, news_num, 64, 8, SEED + 81)
    scores = {}
    for d in (dev, "cpu"):
        gen = torch.Generator().manual_seed(SEED + 82)
        model = NRMSModel(cfg, device=d, generator=gen) if nrms else \
            Model(cfg, device=d, generator=gen, word_embedding=table)
        t = small if d != "cpu" else type(small)(**{k: x.cpu() for k, x in vars(small).items()}) \
            if nrms else type(small)(*(x.cpu() for x in small))
        scorer = (NRMSCachedScorer if nrms else CachedScorer)(model, bs)
        reset_counters()
        scores[d] = scorer.score_items(t, *imps[:4])
        if d != "cpu":
            serve = read_counters()
            want = bf16_serving_want(name, cfg, news_num, bs, scorer.timings["stage2_batches"])
            result["serving"] = {k: v for k, v in serve.items() if v}
            if serve != want:
                failures.append(f"{name} bf16 serving launches {result['serving']}, want "
                                f"{ {k: v for k, v in want.items() if v} }")
    s_gpu, s_cpu = scores[dev], scores["cpu"]
    err = float(np.abs(s_gpu - s_cpu).max())
    limit = BF16_SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
    flips = 0
    for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                      M.group_by_impression(imps[2], s_cpu)):
        og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
        flips += sum(a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit
                     for a, b in zip(og, oc))
    say(f"  {name} bf16 serving ({'glove-scale table' if table is not None else 'N(0, 1) table'}): {len(imps[3])} items, max |card - cpu| {err:.3e} (limit "
        f"{limit:.3e}), rank flips beyond ties {flips}; launches {result.get('serving')}")
    if not (err <= limit and flips == 0 and np.isfinite(s_gpu).all()):
        failures.append(f"{name} bf16 serving card vs cpu")
    # B-8 steps, card against the CPU
    corpus = make_train_corpus(cfg, tables, (BF16_STEPS + 2) * cfg.batch_size, 2000, 32,
                               SEED + 83)
    if nrms:
        ntables = nrms_tables_for(torch, cfg, tables, SEED + 84)
        corpus.nrms_tables = lambda: ntables
    training_parity(torch, cfg, corpus, dev, failures, nrms=nrms, label=f"{name} bf16",
                    word_embedding=table, act_bf16=True, steps=3 if nrms else 2)
    # untraced steps at B 64, dropout on
    gen = torch.Generator().manual_seed(SEED + 85)
    model = NRMSModel(cfg, device=dev, generator=gen) if nrms else \
        Model(cfg, device=dev, generator=gen, word_embedding=table)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(SEED))
    split = corpus.splits["train"]
    cap = 0
    if not nrms:
        cap = batching.estimate_dedup_capacity(split.history_idx, corpus.train_behavior_row,
                                               corpus.train_pos, neg, corpus.news_node_id,
                                               cfg.batch_size, seed=cfg.seed)
    batches = [b for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        cfg.batch_size, epoch_seed=SEED, news_node_id=None if nrms else corpus.news_node_id,
        dedup_titles=cap) if nrms or isinstance(b, batching.DedupTrainBatch)][:BF16_STEPS]
    t = NRMSTables.from_arrays(corpus.nrms_tables(), dev) if nrms else \
        CorpusTables.from_arrays(tables, dev)
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    drawn, apply_dropout = Counter(), layers.apply_dropout

    def recording(x, rate, seed, site):
        drawn[(x.numel() // x.shape[-1], x.shape[-1], rate)] += 1
        return apply_dropout(x, rate, seed, site)

    layers.apply_dropout = recording
    reset_counters()
    step_ms, losses = [], []
    try:
        for k, b in enumerate(batches):
            b = batching.to_device(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(train_step(model, opt, t, b, step_seed(SEED, 1, k), cfg.lr)))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        layers.apply_dropout = apply_dropout
    launches = read_counters()
    steps = len(batches)
    want = {k: v * steps for k, v in bf16_step_want(cfg, cap).items()}
    median = float(np.median(step_ms[2:]))
    say(f"  {name} bf16 training: {steps} steps at B {cfg.batch_size}"
        + ("" if nrms else f" (dedup capacity {cap})")
        + f", median step {median:.3f} ms after 2 (first {step_ms[0]:.3f}); train samples/s "
        f"{cfg.batch_size * 1e3 / median:.1f}; losses {[round(v, 5) for v in losses]}; "
        f"launches per step {({k: v / steps for k, v in launches.items() if v})}")
    if steps < BF16_STEPS or not np.isfinite(losses).all():
        failures.append(f"{name} bf16 training: too few steps or a loss not finite")
    for k, n in want.items():
        if launches[k] != n:
            failures.append(f"{name} bf16 training: {k} launched {launches[k]} times, want {n}")
    if not nrms:
        checked = Counter()
        for _, rows, cols, rate, per_step in mask_sites(cfg, cap):
            checked[(rows, cols, rate)] += per_step * steps
        if drawn != checked:
            failures.append(f"{name} bf16 training: A'' drew masks at {dict(drawn)}, want "
                            f"{dict(checked)}")
    result.update(training={k: v for k, v in launches.items() if v}, steps=steps,
                  step_ms_median=median, samples_per_s=cfg.batch_size * 1e3 / median, cap=cap)
    return result


def bf16_more_phase(torch, cfg, tables, cap, dev, failures):
    """Phase 21: the bf16 instances of the pair, A'', B (bf16 activations) and
    C against their plain versions, then NRMS-SA, NRMS, CNN-DIGAT and MSA at
    L 160 at bfloat16 (`bf16_model_phase`) -> (kernels-line entries by name,
    runs by model)."""
    ncfg = replace(cfg, model_family="nrms", compute_dtype="bfloat16")
    entries = {}
    try:
        entries["msa_attention_bf16"], entries["msa_attention_wide_bf16"] = \
            bf16_pair_kernels(torch, ncfg, dev)
    except Exception:
        traceback.print_exc()
        entries.update(msa_attention_bf16=dict(ok=False), msa_attention_wide_bf16=dict(ok=False))
    try:
        entries["dropout_bf16"] = bf16_dropout_kernels(torch, ncfg, cap, dev)
    except Exception:
        traceback.print_exc()
        entries["dropout_bf16"] = dict(ok=False)
    try:
        entries["interactive_gat_layer_fused_bf16_act"], entries["gat_scores_fwd_bf16"] = \
            bf16_graph_kernels(torch, cfg, dev)
    except Exception:
        traceback.print_exc()
        entries.update(interactive_gat_layer_fused_bf16_act=dict(ok=False),
                       gat_scores_fwd_bf16=dict(ok=False))
    for name, e in entries.items():
        if not e.get("ok"):
            failures.append(f"kernel {name}")
    runs = {}
    for name, mcfg in bf16_model_configs(cfg):
        t0 = time.perf_counter()
        try:
            t = tables if mcfg.max_title_length == cfg.max_title_length else \
                make_tables(torch, mcfg, 4096, dev, SEED + 86)
            runs[name] = bf16_model_phase(torch, name, mcfg, t, dev, failures)
        except Exception:
            traceback.print_exc()
            failures.append(f"bf16 {name}")
        say(f"[21 {name} bf16] {time.perf_counter() - t0:.2f}s")
    return entries, runs


def head_tables(torch, tables, news_num: int):
    """The first `news_num` news of a corpus's tables, its graph ids folded
    into that range."""
    return type(tables)(tables.news_title_text[:news_num], tables.news_title_mask[:news_num],
                        tables.news_node_id[:news_num] % news_num, tables.news_graph[:news_num],
                        tables.news_graph_mask[:news_num])


# ---------------------------------------------------------------------------
# Phase 22: data parallelism (digat_tpu_torch.parallel.dist). The card is one,
# and NCCL refuses two ranks on one device, so two ranks run on cuda:0 over
# gloo (child processes of this script, torchrun's environment set),
# against one process stepping the same global batches from the same
# weights; NCCL runs at world 1 (its all-reduce here, and phase 14's CLI
# cell through `init_distributed`). Both ranks share the card: their step
# time is not a scaling number.
# ---------------------------------------------------------------------------
DP_WORLD = 2
DP_STEPS = 3  # checked steps at B 64 (dropout 0), then as many at the production rate
DP_LOSS_RTOL = 1e-5  # each step's loss, two ranks against one process on the card
DP_GRAD_RTOL = 1e-4  # each step-1 gradient: max |dp - one| <= this * max |one| of the tensor
DP_SCORE_RTOL = 1e-6  # the sharded scorer: of the score scale, and the same ranks
# the forward logits at rate 0 against the whole batch in one pass, of max(1,
# max |one|): 16 to 32 fp32 ulps at the max; a wrong row split moves them by O(1)
DP_LOGIT_RTOL = 2e-6


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher_env(rank: int, world: int, port: int) -> dict:
    """torchrun's environment for `rank` of `world` ranks on one node."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}


class _Env:
    """Environment variables set for a block, restored after."""

    def __init__(self, values: dict):
        self.values, self.saved = values, {}

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def allreduce_ms(torch, ctx, tensors, reps: int = 5, group=None) -> tuple:
    """(bytes, median ms) of `ctx.all_reduce_sum_` on `tensors` (a step's
    gradients, or the rows of a lookup over `group`), each call between
    device synchronises."""
    times = []
    for _ in range(reps + 1):
        sync(torch, ctx.device)
        t0 = time.perf_counter()
        ctx.all_reduce_sum_(tensors, group=group)
        sync(torch, ctx.device)
        times.append((time.perf_counter() - t0) * 1e3)
    return sum(t.numel() * t.element_size() for t in tensors), float(np.median(times[1:]))


def dp_job(torch, cfg, ncfg, dev) -> dict:
    """Phase 22's inputs, made from seeds (host copies, as the ranks load
    them): MSA-DIGAT and NRMS-SA weights at full width, a 4,096-news corpus,
    DP_STEPS global batches of 64 (one for NRMS-SA), dedup capacities for
    64 rows and for one rank's 32, and a 1,024-news serving corpus."""
    from digat_tpu_torch.data import batching, sampling
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.models.nrms import NRMSModel

    host = lambda t: {k: v.cpu() for k, v in (t._asdict() if hasattr(t, "_asdict")
                                              else vars(t)).items()}
    tables = make_tables(torch, cfg, 4096, dev, SEED + 40)
    corpus = make_train_corpus(cfg, tables, 4 * cfg.batch_size, 1000, 8, SEED + 41)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(SEED + 42))
    split = corpus.splits["train"]
    batches = [tuple(b) for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        cfg.batch_size, epoch_seed=SEED + 43)][:DP_STEPS]
    caps = {w: batching.estimate_dedup_capacity(
        split.history_idx, corpus.train_behavior_row, corpus.train_pos, neg, corpus.news_node_id,
        cfg.batch_size // w, seed=SEED) for w in (1, DP_WORLD)}
    state = lambda m: {k: v.cpu() for k, v in m.state_dict().items()}
    digat = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 44))
    nrms = NRMSModel(ncfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 45))
    serve = make_tables(torch, cfg, 1024, dev, SEED + 46)
    return {
        "device": str(dev),
        "digat": {"config": cfg, "state": state(digat), "tables": host(tables),
                  "batches": batches, "news_node_id": corpus.news_node_id, "capacity": caps,
                  "rates": (0.0, cfg.dropout_rate)},
        "nrms": {"config": ncfg, "state": state(nrms),
                 "tables": host(nrms_tables_for(torch, ncfg, tables, SEED + 47)),
                 "batches": batches[:1], "news_node_id": None, "capacity": {1: 0, DP_WORLD: 0},
                 "rates": (0.0,)},
        "serving": {"digat": state(digat), "nrms": state(nrms), "config": cfg, "nconfig": ncfg,
                    "tables": host(serve),
                    "ntables": host(nrms_tables_for(torch, ncfg, serve, SEED + 48)),
                    "items": make_impressions(cfg, 1024, 64, 8, SEED + 49)[:4], "batch_size": 256},
    }


def accumulated_step(model, opt, tables, parts, seed: int, lr: float) -> float:
    """One process's step over a global batch given as row groups: each
    group's forward and backward in turn (num_g / max(den, 1), den the
    whole batch's weight), the gradients summed into .grad, then the one
    clip and Adam step -> the global loss."""
    opt.zero_grad()
    den = max(sum(float(p.weight.sum()) for p in parts), 1.0)
    total = 0.0
    for p in parts:
        num, _ = model.loss_parts(tables, p, seed)
        loss = num / den
        loss.backward()
        total += float(loss.detach())
    opt.step(lr)
    return total


def dp_steps(torch, ctx, part, dev, groups: int = 1, kinks=None) -> dict:
    """Phase 22: one model's steps, from the job's weights, with the launch
    counters reset: a rank's rows of each global batch (`train_step` across
    the ranks of `ctx`; on a grid with a model axis, the rows of its data
    index and its rows of the word table), or one process's whole batch in
    one pass, or (`groups` > 1) one process's batch as the row groups of
    that many ranks in turn (`accumulated_step`: each group at a rank's
    shapes, so that the same rows round the same way and no ReLU kink falls
    otherwise). By dropout rate (only 0 for `groups` > 1): losses, the
    step-1 gradients (a table shard's as it is) and forward logits at rate
    0, each step's ms (between device synchronises), the batch kinds and
    the launches; on a model axis also the shard's rows, its and its
    moments' bytes and the lookup's all-reduce. `kinks` (a `KinkDigest`)
    records step 1 at rate 0."""
    from types import SimpleNamespace

    from digat_tpu_torch.data import batching
    from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
    from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables
    from digat_tpu_torch.parallel import sharded_table
    from digat_tpu_torch.parallel.sharded_table import ShardedLookup
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import seed_index, step_seed, train_step

    nrms = part["config"].model_family == "nrms"
    tables = (NRMSTables if nrms else CorpusTables).from_arrays(
        SimpleNamespace(**part["tables"]), dev)
    rank = seed_index(ctx)
    n, own = ((ctx.local_data_world, [ctx.local_data_rank]) if groups == 1
              else (groups, range(groups)))
    rows = [[batching.rank_rows(TrainBatch(*b), i, n, part["news_node_id"],
                                part["capacity"][n]) for i in own] for b in part["batches"]]
    batches = [[batching.to_device(r, dev) for r in rs] for rs in rows]
    out = {}
    for rate in part["rates"] if groups == 1 else (0.0,):
        cfg = replace(part["config"], dropout_rate=rate)
        model = (NRMSModel if nrms else Model)(cfg, device=dev, dist=ctx,
                                               generator=torch.Generator().manual_seed(SEED))
        model.load_state_dict(part["state"])
        shards = sharded_table.tables(model)
        opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm,
                   shards=shards)
        rec = {"kinds": [[type(r).__name__ for r in rs] for rs in rows], "losses": [],
               "ms": []}
        if rate == 0.0:
            with torch.no_grad():
                rec["logits"] = torch.cat([model.computing(
                    model.forward_indexed, tables, g, step_seed(SEED, 1, 0, rank)).cpu()
                    for g in batches[0]])
        reset_counters()
        ShardedLookup.bytes = 0
        for k, parts in enumerate(batches):
            seed = step_seed(SEED, 1, k, rank)
            sync(torch, dev)
            t0 = time.perf_counter()
            if groups == 1:
                with kinks.record() if kinks and k == 0 and rate == 0.0 else _Stack([]):
                    loss = float(train_step(model, opt, tables, parts[0], seed, cfg.lr, ctx))
            else:
                loss = accumulated_step(model, opt, tables, parts, seed, cfg.lr)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(loss)
            if k == 0:
                rec["lookup_bytes"] = ShardedLookup.bytes
            if k == 0 and rate == 0.0:
                rec["grads"] = {n: p.grad.detach().to("cpu", copy=True)
                                for n, p in model.named_parameters()}
        rec["launches"] = read_counters()
        if shards:
            (name, table), = shards.items()
            i = opt.names.index(name)
            rec["table_rows"] = (table.lo, table.hi)
            rec["state_bytes"] = {"table": table.weight.numel() * 4,
                                  "moments": (opt.mu[i].numel() + opt.nu[i].numel()) * 4}
        if rate == 0.0 and shards:
            # the lookups' all-reduce over the model group at step 1's sizes
            buf = torch.zeros(rec["lookup_bytes"] // 4, device=dev)
            rec["lookup"] = allreduce_ms(torch, ctx, [buf], group=ctx.model_group)
        elif rate == 0.0 and ctx.active:
            rec["allreduce"] = allreduce_ms(torch, ctx, [p.grad for p in opt.params])
        out[rate] = rec
    return out


def dp_serving(torch, ctx, part, dev) -> dict:
    """Phase 22: both scorers over the 1,024-news corpus, sharded over the
    ranks of `ctx` (whole on one process; on a model axis the models hold
    their rows of the word table, gathered for stage 1), the counters reset
    around the first pass; scores, launches and both passes' timings."""
    from types import SimpleNamespace

    from digat_tpu_torch.eval.scorer import CachedScorer, NRMSCachedScorer
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.models.nrms import NRMSModel

    out = {}
    for name, build_model, scorer, cfg, state, tables in (
            ("digat", Model, CachedScorer, part["config"], part["digat"], part["tables"]),
            ("nrms", NRMSModel, NRMSCachedScorer, part["nconfig"], part["nrms"],
             part["ntables"])):
        model = build_model(cfg, device=dev, dist=ctx,
                            generator=torch.Generator().manual_seed(SEED))
        model.load_state_dict(state)
        s = scorer(model, part["batch_size"], ctx)
        t = SimpleNamespace(**{k: v.to(dev) for k, v in tables.items()})
        reset_counters()
        scores = s.score_items(t, *part["items"])
        launches, first = read_counters(), dict(s.timings)
        s.score_items(t, *part["items"])
        out[name] = {"scores": scores, "launches": launches, "first": first,
                     "warm": dict(s.timings)}
    return out


def dp_rank(job_path: str, out_dir: str) -> int:
    """Phase 22, one of DP_WORLD ranks on the parent's device (cuda:0) over
    gloo (a child process of this script, started by `dp_phase` with
    torchrun's environment): the steps and the sharded scorers on this
    rank's share, then the same on a 1 x DP_WORLD grid over the same world
    (`parallel.dist.make_grid`: the word table row-sharded, each rank the
    whole batch; the MSA-DIGAT step 1 at rate 0 with its kinks digested)
    -> out_dir/rank<r>.pt."""
    import torch

    from digat_tpu_torch.config import Config
    from digat_tpu_torch.ops import build
    from digat_tpu_torch.parallel import dist as dist_lib
    from digat_tpu_torch.runtime import exact_fp32

    exact_fp32()
    job = torch.load(job_path, weights_only=False)  # written by the parent smoke
    dev = torch.device(job["device"])
    ctx = dist_lib.init_distributed(Config(), device=dev, backend="gloo")
    try:
        if dev.type == "cuda":
            build.load_library(dev)  # built by the parent: local rank 0 of this node
        out = {"rank": ctx.rank, "world": ctx.world, "backend": ctx.backend,
               "digat": dp_steps(torch, ctx, job["digat"], dev),
               "nrms": dp_steps(torch, ctx, job["nrms"], dev),
               "serving": dp_serving(torch, ctx, job["serving"], dev)}
        t0 = time.perf_counter()
        grid = dist_lib.make_grid(ctx, DP_WORLD)
        kinks = KinkDigest(torch)
        out["tp"] = {"grid": (grid.data_world, grid.model_world, grid.model_rank),
                     "digat": dp_steps(torch, grid, job["digat"], dev, kinks=kinks),
                     "nrms": dp_steps(torch, grid, job["nrms"], dev),
                     "serving": dp_serving(torch, grid, job["serving"], dev),
                     "kinks": kinks.masks}
        sync(torch, dev)
        out["tp"]["s"] = time.perf_counter() - t0
    finally:
        dist_lib.destroy(ctx)
    torch.save(out, os.path.join(out_dir, f"rank{ctx.rank}.pt"))
    return 0


def dp_differences(torch, ref, got) -> tuple:
    """Two ranks' rate-0 record against one process's: (max loss relative
    error, worst step-1 gradient max |dp - one| / max |one| with its tensor,
    that max and how many of its entries differ by more than DP_GRAD_RTOL of
    it, whether the forward logits are bit-identical, their max difference,
    max(1, max |one logit|))."""
    loss_err = max(abs(a - b) / max(abs(b), 1e-30) for g in got
                   for a, b in zip(g["losses"], ref["losses"]))
    worst = (0.0, "", 0.0, 0)
    for n, g in ref["grads"].items():
        top = float(g.abs().max())
        diff = (got[0]["grads"][n] - g).abs()
        err = float(diff.max()) / max(top, 1e-30)
        worst = max(worst, (err, n, top, int((diff > DP_GRAD_RTOL * top).sum())))
    logits = torch.cat([g["logits"] for g in got])
    return (loss_err, worst, torch.equal(logits, ref["logits"]),
            float((logits - ref["logits"]).abs().max()),
            max(1.0, float(ref["logits"].abs().max())))


def dp_compare_steps(torch, what, one, groups, ranks, failures) -> None:
    """Two ranks' losses, step-1 gradients and forward logits (rate 0)
    against one process stepping the same global batches. Against the row
    groups in turn (`groups`, the ranks' shapes and the ranks' own row
    split) the losses and gradients are gated. Against the whole batch in
    one pass (`one`), which splits no rows and so sees a split that drops
    or repeats rows, the losses and the logits are gated; its gradients,
    whose rows round otherwise (cuBLAS picks by the row count), are
    printed here and gated, with the ranks', against the CPU
    (`dp_cpu_reference`)."""
    got = [r[0.0] for r in ranks]
    same_loss = all(g["losses"] == got[0]["losses"] for g in got)
    loss_err, (worst, name, top, _), bits, logit_err, _ = dp_differences(torch, groups[0.0],
                                                                         got)
    p_loss, (p_worst, p_name, p_top, p_over), p_bits, p_logit, p_scale = dp_differences(
        torch, one[0.0], got)
    p_size = one[0.0]["grads"][p_name].numel() if p_name else 0
    say(f"  {what}: losses one process {[round(v, 7) for v in groups[0.0]['losses']]}, two "
        f"ranks {[round(v, 7) for v in got[0]['losses']]} (the same on both: {same_loss}); "
        f"against one process by the ranks' row groups: max loss rel err {loss_err:.3e} "
        f"(limit {DP_LOSS_RTOL:g}), step-1 gradients of {len(got[0]['grads'])} tensors, worst "
        f"max |dp - one| / max |one| {worst:.3e} ({name}, max |one| {top:.3e}; limit "
        f"{DP_GRAD_RTOL:g}), forward logits bit-identical: {bits} (max |dp - one| "
        f"{logit_err:.3e}); against the whole batch in one pass: losses {p_loss:.3e} (limit "
        f"{DP_LOSS_RTOL:g}), logits bit-identical {p_bits} (max |dp - one| {p_logit:.3e}, "
        f"limit {DP_LOGIT_RTOL * p_scale:.3e} of max |one| {p_scale:.3e}), worst gradient "
        f"{p_worst:.3e} ({p_name}, max |one| {p_top:.3e}, {p_over} of its {p_size} entries "
        f"beyond {DP_GRAD_RTOL:g} of that; gated against the CPU below); batches "
        f"{[g['kinds'] for g in got]}")
    if not (loss_err <= DP_LOSS_RTOL and worst <= DP_GRAD_RTOL and same_loss
            and np.isfinite(got[0]["losses"]).all()):
        failures.append(f"data-parallel {what}: two ranks against one process's row groups")
    if not (p_loss <= DP_LOSS_RTOL and p_logit <= DP_LOGIT_RTOL * p_scale):
        failures.append(f"data-parallel {what}: two ranks against the whole batch in one pass")


# Phase 22's step-1 reference on the CPU: the first global batch in one pass
# from the job's weights at dropout 0, the CPU taking the side that the
# card's one pass took at every kink (`KinkReplay`). The card's one pass and
# the two ranks' summed gradient are each gated against it at phase 9's
# limit (TRAIN_RTOL of each tensor's max). The ranks' rows round at other
# shapes, so at a few kinks they take the other side than the one pass: the
# card's row groups (the ranks' gradients bit for bit) are recorded too and
# those kinks counted; `scripts/dp_kink_witness.py` replays the groups'
# sides on the CPU as well, which shows that they make the whole gap.
# Entries beyond DP_SPREAD of their tensor's max are counted, to tell a
# spread of rounding from a few whole terms.
DP_SPREAD = 1e-4
DP_WATCHED = "graph_encoder.news_graph_attention_ffn2.2.weight"  # PR 15's worst tensor


def reference_step(torch, part, device, sorted_emb_grad: bool = True,
                   groups: int = 1) -> tuple:
    """Step 1 of phase 22's MSA-DIGAT job by one process on `device`, as
    `dp_steps` takes it (the job's weights, dropout 0): the first global
    batch in one pass, or (`groups` > 1) as that many ranks' row groups in
    turn (`accumulated_step`) -> (loss, step-1 gradients on the host,
    launches)."""
    from types import SimpleNamespace

    from digat_tpu_torch.data import batching
    from digat_tpu_torch.models.model import CorpusTables, Model, TrainBatch
    from digat_tpu_torch.train.optimizer import Adam
    from digat_tpu_torch.train.train_step import step_seed, train_step

    cfg = replace(part["config"], dropout_rate=0.0, sorted_emb_grad=sorted_emb_grad)
    tables = CorpusTables.from_arrays(SimpleNamespace(**part["tables"]), device)
    parts = [batching.to_device(batching.rank_rows(
        TrainBatch(*part["batches"][0]), i, groups, part["news_node_id"],
        part["capacity"][groups]), device) for i in range(groups)]
    model = Model(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(part["state"])
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    seed = step_seed(SEED, 1, 0)
    reset_counters()
    if groups == 1:
        loss = float(train_step(model, opt, tables, parts[0], seed, cfg.lr))
    else:
        loss = accumulated_step(model, opt, tables, parts, seed, cfg.lr)
    launches = read_counters()
    return loss, {n: p.grad.detach().to("cpu", copy=True)
                  for n, p in model.named_parameters()}, launches


def grad_spread(got: dict, want: dict) -> dict:
    """Step-1 gradients against a reference: the worst tensor by max |got -
    want| / max |want| (a zeroed or lost gradient reads 1), its entries
    beyond DP_SPREAD of its max and its size, those entries over all
    tensors, and the same for DP_WATCHED."""
    def one(n):
        w = want[n]
        top = float(w.abs().max())
        d = (got[n] - w).abs()
        return float(d.max()) / max(top, 1e-30), int((d > DP_SPREAD * top).sum()), w.numel()

    per = {n: one(n) for n in want}
    worst = max(per, key=lambda n: per[n][0])
    return {"worst": per[worst][0], "name": worst, "over": per[worst][1],
            "size": per[worst][2], "over_all": sum(v[1] for v in per.values()),
            "entries": sum(v[2] for v in per.values()), "watched": per.get(DP_WATCHED)}


def say_spread(what: str, sp: dict, loss_err=None) -> None:
    watched = sp["watched"]
    say(f"    {what}: "
        + ("" if loss_err is None else
           f"loss err {loss_err:.3e} (limit {TRAIN_RTOL:g} * max(1, |cpu|)); ")
        + f"worst gradient {sp['worst']:.3e} of its tensor's max ({sp['name']}, {sp['over']} of "
        f"its {sp['size']} entries beyond {DP_SPREAD:g} of it); entries beyond {DP_SPREAD:g} "
        f"over all tensors {sp['over_all']} of {sp['entries']}"
        + (f"; {DP_WATCHED.split('.', 1)[1]} {watched[0]:.3e}, {watched[1]} of {watched[2]} "
           f"beyond" if watched else ""))


def kink_sides_apart(torch, one, groups, n_groups: int) -> dict:
    """By kind, the kinks where the card's row groups (`groups`, their calls
    group by group) took the other side than the card's one pass (`one`):
    call i of the one pass against call i of every group, the groups' rows
    joined in order -> (differing, terms), or None where the calls do not
    line up."""
    out = {}
    for kind in KinkReplay.KINDS:
        a, b = one.masks[kind], groups.masks[kind]
        n = len(a)
        if len(b) != n_groups * n:
            out[kind] = None
            continue
        joined = [torch.cat([b[g * n + i] for g in range(n_groups)]) for i in range(n)]
        if any(x.shape != y.shape for x, y in zip(a, joined)):
            out[kind] = None
            continue
        out[kind] = (sum(int((x != y).sum()) for x, y in zip(a, joined)),
                     sum(x.numel() for x in a))
    return out


def dp_reference_steps(torch, part, dev) -> dict:
    """Phase 22's step-1 steps for `dp_cpu_reference`: the card's one pass
    and its row groups with their kinks recorded, then the CPU's step with
    the one pass's sides replayed (taken while the ranks run)."""
    t0 = time.perf_counter()
    kinks, kinks_g = KinkRecord(torch), KinkReplay(torch)
    with kinks.record():
        card_loss, card, _ = reference_step(torch, part, dev)
    kinks.split()
    with kinks_g.record():
        _, card_g, _ = reference_step(torch, part, dev, groups=DP_WORLD)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with kinks.replay():
        cpu_loss, cpu, _ = reference_step(torch, part, torch.device("cpu"))
    return {"kinks": kinks, "kinks_g": kinks_g, "card": (card_loss, card), "card_g": card_g,
            "cpu": (cpu_loss, cpu), "card_s": card_s, "cpu_s": time.perf_counter() - t0}


def dp_cpu_reference(torch, part, steps, one, ranks, failures) -> dict:
    """Phase 22: the CPU's step-1 reference (see DP_SPREAD; `steps` from
    `dp_reference_steps`) and the gates of the card's one pass (`one`) and
    the two ranks (`ranks`, rank 0's record: the summed gradient) against
    it; the card's one pass and its row groups, taken again with their
    kinks recorded, must give `one`'s and the ranks' gradients bit for bit.
    -> the reference (its kinks, losses and gradients) for phase 23."""
    kinks, kinks_g, card_g = steps["kinks"], steps["kinks_g"], steps["card_g"]
    (card_loss, card), (cpu_loss, cpu) = steps["card"], steps["cpu"]
    card_s, cpu_s = steps["card_s"], steps["cpu_s"]
    again = all(torch.equal(card[n], one["grads"][n]) for n in card)
    ranks_again = all(torch.equal(card_g[n], ranks["grads"][n]) for n in card_g)
    apart = kink_sides_apart(torch, kinks, kinks_g, DP_WORLD)
    say(f"  step-1 reference on the CPU, one pass at B {part['config'].batch_size}, dropout 0 "
        f"(card {card_s:.2f}s, cpu {cpu_s:.2f}s): loss {cpu_loss:.7f}; kinks where the CPU took "
        f"the card's side against its own: {kinks.summary()}. The card's one pass again bit for "
        f"bit: {again}; its row groups the ranks' bit for bit: {ranks_again}; kinks where the "
        f"card's row groups took the other side than its one pass: "
        + "; ".join(f"{k} {v[0]} of {v[1]}" if v else f"{k} not comparable"
                    for k, v in apart.items()))
    for what, loss, grads in (("card one pass", one["losses"][0], one["grads"]),
                              ("two ranks", ranks["losses"][0], ranks["grads"])):
        sp = grad_spread(grads, cpu)
        loss_err = abs(loss - cpu_loss) / max(1.0, abs(cpu_loss))
        say_spread(f"{what} against the CPU", sp, loss_err)
        if not (sp["worst"] <= TRAIN_RTOL and loss_err <= TRAIN_RTOL):
            failures.append(f"data-parallel: the {what}'s step-1 gradients against the CPU")
    if not (again and ranks_again):
        failures.append("data-parallel: a card step taken again gave other bits")
    return {"part": part, "kinks": kinks, "cpu": (cpu_loss, cpu), "card": (card_loss, card)}


def dp_phase(torch, cfg, ncfg, dev, failures) -> tuple:
    """Phase 22: MSA-DIGAT (B 64, dedup per shard, DP_STEPS steps at dropout
    0 and as many at the production rate) and NRMS-SA (one step) on two
    gloo ranks on the card against one process, the MSA-DIGAT step-1
    gradients of both against the CPU (`dp_cpu_reference`), the sharded
    scorers against one process, and the all-reduce's bytes and time (gloo
    world 2, NCCL world 1). -> (launches by path for the kernels line, the
    CPU reference)."""
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.parallel import dist as dist_lib
    from digat_tpu_torch.parallel.dist import DistContext

    t0 = time.perf_counter()
    job = dp_job(torch, cfg, ncfg, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "job.pt")
        torch.save(job, path)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        port, here = free_port(), os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", path,
                                   tmp], cwd=here, env={**os.environ, **launcher_env(
                                       r, DP_WORLD, port)}) for r in range(DP_WORLD)]
        CHILDREN.extend(procs)
        try:
            # one process on the same inputs, while the ranks start
            one = DistContext(device=dev)
            ref = {"digat": dp_steps(torch, one, job["digat"], dev),
                   "digat groups": dp_steps(torch, one, job["digat"], dev, DP_WORLD),
                   "nrms": dp_steps(torch, one, job["nrms"], dev),
                   "nrms groups": dp_steps(torch, one, job["nrms"], dev, DP_WORLD),
                   "serving": dp_serving(torch, one, job["serving"], dev)}
            one_s = time.perf_counter() - t0
            steps = dp_reference_steps(torch, job["digat"], dev)
            rcs = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        if any(rcs):
            failures.append(f"data-parallel ranks exited {rcs}")
            return {}, None
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    say(f"  inputs {setup_s:.2f}s; {DP_WORLD} ranks ({[r['backend'] for r in ranks]}, world "
        f"{ranks[0]['world']}), one process ({one_s:.2f}s) and the step-1 reference "
        f"{ranks_s:.2f}s")
    dp_compare_steps(torch, "MSA-DIGAT B 64, depth 3, dedup per shard", ref["digat"],
                     ref["digat groups"], [r["digat"] for r in ranks], failures)
    reference = dp_cpu_reference(torch, job["digat"], steps, ref["digat"][0.0],
                                 ranks[0]["digat"][0.0], failures)
    dp_compare_steps(torch, "NRMS-SA B 64", ref["nrms"], ref["nrms groups"],
                     [r["nrms"] for r in ranks], failures)
    # the steps at the production dropout rate: their launches on each rank, their time
    depth, rate = cfg.graph_depth, cfg.dropout_rate
    fp32_drops, _ = site_launches(cfg)
    by_path = {}
    for r, out in enumerate(ranks):
        rec = out["digat"][rate]
        over = sum(k != ["DedupTrainBatch"] for k in rec["kinds"])
        want = {"msa_encoder_pooled": DP_STEPS + over, "msa_encoder_bwd": DP_STEPS + over,
                "embedding_grad": DP_STEPS + over, "gat_scores_fwd": 2 * depth * DP_STEPS,
                "gat_scores_bwd": 2 * depth * DP_STEPS, "dropout": fp32_drops * DP_STEPS}
        got = {k: rec["launches"][k] for k in want}
        say(f"  rank {r}: {DP_STEPS} steps at dropout {rate} (per-rank seeds): launches {got} "
            f"(want {want}); losses {[round(v, 6) for v in rec['losses']]}; step ms "
            f"{[round(v, 3) for v in rec['ms']]} (one process: "
            f"{[round(v, 3) for v in ref['digat'][rate]['ms']]}; the two ranks share the card)")
        if got != want or not np.isfinite(rec["losses"]).all():
            failures.append(f"data-parallel rank {r}: launches {got}, want {want}")
        nrms = out["nrms"][0.0]["launches"]
        by_path[f"dp rank {r}"] = {**got, "msa_attention_fwd": nrms["msa_attention_fwd"],
                                  "msa_attention_bwd": nrms["msa_attention_bwd"]}
        if nrms["msa_attention_fwd"] != 4 or nrms["msa_attention_bwd"] != 4:
            failures.append(f"data-parallel rank {r}: NRMS-SA step launched the attention "
                            f"pair {nrms['msa_attention_fwd']} / {nrms['msa_attention_bwd']} "
                            "times, want 4 / 4")
    # the all-reduce of a step's gradients: gloo at world 2 (both ranks on the
    # card, staged through the host by gloo), NCCL at world 1
    nbytes, gloo_ms = ranks[0]["digat"][0.0]["allreduce"]
    with _Env(launcher_env(0, 1, free_port())):
        ctx = dist_lib.init_distributed(Config(), device=dev)
    try:
        grads = [g.to(dev) for g in ref["digat"][0.0]["grads"].values()]
        _, nccl_ms = allreduce_ms(torch, ctx, grads)
        backend = ctx.backend
    finally:
        dist_lib.destroy(ctx)
    say(f"  all-reduce a step: {nbytes / 1e6:.3f} MB of gradients (the word table's "
        f"{cfg.vocabulary_size} x {cfg.word_embedding_dim} dense); gloo world {DP_WORLD} "
        f"{gloo_ms:.3f} ms (rank 0, median of 5), {backend} world 1 {nccl_ms:.3f} ms")
    if backend != "nccl":
        failures.append(f"data-parallel: world 1 on the card took {backend}, not nccl")
    # the sharded scorers against one process
    for name, bkernel in (("digat", "interactive_gat_layer_fused"), ("nrms", "msa_attention_fwd")):
        want = ref["serving"][name]
        got = [r["serving"][name] for r in ranks]
        imp = job["serving"]["items"][2]
        err = max(float(np.abs(g["scores"] - want["scores"]).max()) for g in got)
        scale = max(1.0, float(np.abs(want["scores"]).max()))
        flips = sum(int((np.argsort(-a, kind="stable") != np.argsort(-b, kind="stable")).any())
                    for a, b in zip(M.group_by_impression(imp, got[0]["scores"]),
                                    M.group_by_impression(imp, want["scores"])))
        launches = [g["launches"][bkernel] for g in got]
        say(f"  {name} scorer, 1,024 news on {DP_WORLD} ranks: max |dp - one| {err:.3e} (limit "
            f"{DP_SCORE_RTOL * scale:.3e}); impressions ranked otherwise {flips}; {bkernel} "
            f"launches by rank {launches} (one process {want['launches'][bkernel]}); stage 1 "
            f"{[round(g['warm']['stage1_s'], 4) for g in got]} s by rank warm (one process "
            f"{want['warm']['stage1_s']:.4f}), stage 2 "
            f"{[round(g['warm']['stage2_s'], 4) for g in got]} s "
            f"({[g['warm']['items'] for g in got]} items; one process "
            f"{want['warm']['stage2_s']:.4f} s, {want['warm']['items']} items)")
        if not (err <= DP_SCORE_RTOL * scale and flips == 0 and all(launches)):
            failures.append(f"data-parallel {name} scorer against one process")
        for r, g in enumerate(got):
            counts = by_path[f"dp rank {r}"]
            counts[f"serving {bkernel}"] = g["launches"][bkernel]
            if name == "digat":
                counts["serving msa_encoder_pooled"] = g["launches"]["msa_encoder_pooled"]
    t0 = time.perf_counter()
    tp_compare(torch, cfg, job, ref, reference, [r["tp"] for r in ranks], dev, failures,
               by_path)
    say(f"  tensor-parallel comparisons {time.perf_counter() - t0:.2f}s")
    return by_path, reference


def grads_apart(torch, got: dict, want: dict) -> tuple:
    """(worst max |got - want| / max |want| over the tensors, its tensor)."""
    worst = (0.0, "")
    for n, w in want.items():
        worst = max(worst, (float((got[n] - w).abs().max()) / max(float(w.abs().max()), 1e-30),
                            n))
    return worst


def tp_compare(torch, cfg, job, ref, reference, tp, dev, failures, by_path) -> None:
    """Phase 22's tensor-parallel leg: the two ranks as a 1 x DP_WORLD grid
    (each the whole batch, the word table row-sharded) against one process
    on the same global batches (`ref`) and the CPU's step-1 reference. Adds
    each rank's launches to `by_path`."""
    from digat_tpu_torch.eval import metrics as M
    from digat_tpu_torch.parallel.sharded_table import shard_rows

    V, Dw = cfg.vocabulary_size, cfg.word_embedding_dim
    depth, rate = cfg.graph_depth, cfg.dropout_rate
    fp32_drops, _ = site_launches(cfg)

    def assembled(family, k):
        """Rank k's step-1 gradients, the table put together from the shards."""
        grads = dict(tp[k][family][0.0]["grads"])
        grads[WORD_TABLE] = torch.cat([t[family][0.0]["grads"][WORD_TABLE] for t in tp])
        return grads

    rows = [t["digat"][0.0]["table_rows"] for t in tp]
    shapes = [tuple(t["digat"][0.0]["grads"][WORD_TABLE].shape) for t in tp]
    want_rows = [shard_rows(V, DP_WORLD, m) for m in range(DP_WORLD)]
    sb = tp[0]["digat"][0.0]["state_bytes"]
    nbytes, ms = tp[0]["digat"][0.0]["lookup"]
    say(f"  tensor parallel, a 1 x {DP_WORLD} grid over the same gloo world (grids "
        f"{[t['grid'] for t in tp]}; leg {[round(t['s'], 2) for t in tp]} s by rank): rows "
        f"{rows} (want {want_rows}), table gradients {shapes}; a rank holds "
        f"{sb['table'] / 1e6:.3f} MB of table and {sb['moments'] / 1e6:.3f} MB of moments "
        f"(one process {V * Dw * 4 / 1e6:.3f} + {2 * V * Dw * 4 / 1e6:.3f}); the lookups' "
        f"all-reduce at step 1 {nbytes / 1e6:.3f} MB, gloo world {DP_WORLD} {ms:.3f} ms "
        f"(rank 0, median of 5; the data-parallel step's gradient all-reduce above)")
    if rows != want_rows or shapes != [(hi - lo, Dw) for lo, hi in want_rows]:
        failures.append(f"tensor parallel: rows {rows}, table gradients {shapes}")
    # MSA-DIGAT at dropout 0 against the one pass, then at the production rate
    one = ref["digat"][0.0]
    for k, t in enumerate(tp):
        rec = t["digat"][0.0]
        loss_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(rec["losses"],
                                                                        one["losses"]))
        worst, name = grads_apart(torch, assembled("digat", k), one["grads"])
        bits = torch.equal(rec["logits"], one["logits"])
        logit_err = float((rec["logits"] - one["logits"]).abs().max())
        scale = max(1.0, float(one["logits"].abs().max()))
        hot = t["digat"][rate]
        hot_err = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(
            hot["losses"], ref["digat"][rate]["losses"]))
        say(f"  rank {k}, MSA-DIGAT B 64 at dropout 0: losses "
            f"{[round(v, 7) for v in rec['losses']]} (one process {[round(v, 7) for v in one['losses']]}), max rel err {loss_err:.3e} "
            f"(limit {DP_LOSS_RTOL:g}); step-1 gradients, the table's from both shards, worst "
            f"{worst:.3e} ({name}; limit {DP_GRAD_RTOL:g} of its max); forward logits "
            f"bit-identical: {bits} (max |tp - one| {logit_err:.3e}); at dropout {rate} (the "
            f"one-process seeds: one mask a model group) losses rel err {hot_err:.3e}; step ms "
            f"{[round(v, 3) for v in hot['ms']]}")
        if not (loss_err <= DP_LOSS_RTOL and worst <= DP_GRAD_RTOL and hot_err <= DP_LOSS_RTOL
                and logit_err <= DP_LOGIT_RTOL * scale and np.isfinite(hot["losses"]).all()):
            failures.append(f"tensor parallel rank {k}: MSA-DIGAT against one process")
        # each rank's launches at the production rate, as the data-parallel leg's
        over = sum(kind != ["DedupTrainBatch"] for kind in hot["kinds"])
        want = {"msa_encoder_pooled": DP_STEPS + over, "msa_encoder_bwd": DP_STEPS + over,
                "embedding_grad": DP_STEPS + over, "gat_scores_fwd": 2 * depth * DP_STEPS,
                "gat_scores_bwd": 2 * depth * DP_STEPS, "dropout": fp32_drops * DP_STEPS}
        got = {n: hot["launches"][n] for n in want}
        nrms = t["nrms"][0.0]
        n_loss = abs(nrms["losses"][0] - ref["nrms"][0.0]["losses"][0]) / abs(
            ref["nrms"][0.0]["losses"][0])
        n_worst, n_name = grads_apart(torch, assembled("nrms", k), ref["nrms"][0.0]["grads"])
        say(f"    launches at dropout {rate}: {got} (want {want}: D on rows "
            f"{rows[k][0]}-{rows[k][1] - 1} alone); NRMS-SA step: loss rel err {n_loss:.3e}, "
            f"gradients worst {n_worst:.3e} ({n_name}), attention pair "
            f"{nrms['launches']['msa_attention_fwd']} / {nrms['launches']['msa_attention_bwd']}")
        if got != want:
            failures.append(f"tensor parallel rank {k}: launches {got}, want {want}")
        if not (n_loss <= DP_LOSS_RTOL and n_worst <= DP_GRAD_RTOL
                and nrms["launches"]["msa_attention_fwd"] == 4
                and nrms["launches"]["msa_attention_bwd"] == 4):
            failures.append(f"tensor parallel rank {k}: NRMS-SA against one process")
        by_path[f"tp rank {k}"] = {**got, **{n: nrms["launches"][n] for n in (
            "msa_attention_fwd", "msa_attention_bwd")}}
    # step 1 against the CPU's reference (no new CPU step), and the kinks
    # where the grid took another side than the card's one pass
    if reference is not None:
        cpu_loss, cpu = reference["cpu"]
        sp = grad_spread(assembled("digat", 0), cpu)
        loss_err = abs(tp[0]["digat"][0.0]["losses"][0] - cpu_loss) / max(1.0, abs(cpu_loss))
        say_spread("tensor parallel against the CPU", sp, loss_err)
        apart = kink_digests_apart(tp[0]["kinks"], reference["kinks"].digests)
        same = all(t["kinks"] == tp[0]["kinks"] for t in tp)
        say("    kinks where the grid took another side than the card's one pass (digests of "
            "each call: calls apart, True counts apart, calls): "
            + "; ".join(f"{k} {v}" if v else f"{k} not comparable" for k, v in apart.items())
            + f"; the ranks' digests the same: {same}")
        if not (sp["worst"] <= TRAIN_RTOL and loss_err <= TRAIN_RTOL):
            failures.append("tensor parallel: step-1 gradients against the CPU")
    # the scorers after the gather
    for name, bkernel in (("digat", "interactive_gat_layer_fused"), ("nrms", "msa_attention_fwd")):
        want = ref["serving"][name]
        got = [t["serving"][name] for t in tp]
        imp = job["serving"]["items"][2]
        err = max(float(np.abs(g["scores"] - want["scores"]).max()) for g in got)
        scale = max(1.0, float(np.abs(want["scores"]).max()))
        flips = sum(int((np.argsort(-a, kind="stable") != np.argsort(-b, kind="stable")).any())
                    for a, b in zip(M.group_by_impression(imp, got[0]["scores"]),
                                    M.group_by_impression(imp, want["scores"])))
        launches = [g["launches"][bkernel] for g in got]
        say(f"  tensor parallel {name} scorer, 1,024 news after the gather: max |tp - one| "
            f"{err:.3e} (limit {DP_SCORE_RTOL * scale:.3e}); impressions ranked otherwise "
            f"{flips}; {bkernel} launches by rank {launches}; stage 1 "
            f"{[round(g['warm']['stage1_s'], 4) for g in got]} s warm")
        if not (err <= DP_SCORE_RTOL * scale and flips == 0 and all(launches)):
            failures.append(f"tensor parallel {name} scorer against one process")
        for k, g in enumerate(got):
            counts = by_path[f"tp rank {k}"]
            counts[f"serving {bkernel}"] = g["launches"][bkernel]
            if name == "digat":
                counts["serving msa_encoder_pooled"] = g["launches"]["msa_encoder_pooled"]


# ---------------------------------------------------------------------------
# Phase 23: the modules of slice 13 on the card, each held against the CPU:
# the MPNet sentence encoder at all-mpnet-base-v2's widths (random weights
# from SEED at HuggingFace's initial law, this script's tokenizer double),
# the `jax_mpnet` embedder through the SAG miner, `layers_ext` at graph
# widths in training, and one MSA-DIGAT step through the library's
# scatter-add word gradient (`sorted_emb_grad=False`).
# ---------------------------------------------------------------------------
MPNET_TEXTS, MPNET_SWEEP, MPNET_BATCH, MPNET_LEN = 16, 4096, 256, 128
# card against CPU, fp32 (TF32 off), max |card - cpu| of the unit-norm
# sentence embeddings: 12 layers of sums in other orders
MPNET_RTOL = 1e-4
# the word table's step-1 gradient through the scatter-add against kernel
# D's on the card: the same sums in another order, of the tensor's max
EMB_GRAD_ROUTE_RTOL = 1e-4
WORD_TABLE = "news_encoder.word_embedding.weight"
# a layers_ext gradient that is 0 in exact arithmetic (the multi-SDP
# attention's K bias adds one constant to every key's score, which the
# softmax cancels) is rounding noise on both sides, so each gradient's
# limit is TRAIN_RTOL of the larger of its own max and this share of the
# module's largest gradient
LAYERS_EXT_FLOOR = 1e-3


class TokenizerDouble:
    """A stand-in for all-mpnet-base-v2's tokenizer (the machine with the
    card has no `transformers`): <s> (id 0), one id a word (its CRC-32 in
    the vocabulary past the special ids), </s> (2), truncated to max_length
    and padded with the pad id (1), as the HuggingFace tokenizer returns a
    batch with padding="max_length" and truncation."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding=None, truncation=None, max_length=None,
                 return_tensors=None):
        import zlib

        ids = np.full((len(texts), max_length), 1, np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [4 + zlib.crc32(w.encode()) % (self.vocab_size - 4) for w in text.split()]
            toks = [0] + toks[:max_length - 2] + [2]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def smoke_texts(n: int, seed: int, lo: int = 3, hi: int = 180) -> list:
    """n seeded texts of lo..hi words (past 126 words the tokenizer
    truncates)."""
    rng = np.random.default_rng(seed)
    words = np.array([f"w{k}" for k in range(5000)])
    return [" ".join(rng.choice(words, size=int(k))) for k in rng.integers(lo, hi, n)]


class MemoEmbedder:
    """An embedder that embeds each distinct text once (the SAG miner asks
    for a category's titles and contents on its full and its corpus
    sides)."""

    def __init__(self, embed, dim: int):
        self.embed, self.dim, self.rows = embed, dim, {}

    def __call__(self, texts, dim: int = 0) -> np.ndarray:
        new = [t for t in dict.fromkeys(texts) if t not in self.rows]
        if new:
            self.rows.update(zip(new, self.embed(new)))
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self.rows[t] for t in texts])


def mpnet_work(cfg, B: int, L: int) -> tuple:
    """(FLOP, bytes) of one MPNet forward over B texts of L tokens: the
    products (q, k, v, o and the FFN; the scores and the weighted sum), the
    weights read once, the ids and mask read and the embeddings written."""
    D, Fd, T = cfg.hidden_size, cfg.intermediate_size, B * L
    flops = cfg.num_layers * (2 * T * (4 * D * D + 2 * D * Fd) + 4 * B * L * L * D)
    params = (cfg.vocab_size + cfg.max_position_embeddings) * D + cfg.num_layers * (
        4 * D * D + 2 * D * Fd)
    return flops, 4 * params + 16 * T + 4 * B * D


def mpnet_phase(torch, dev, failures) -> dict:
    """Phase 23 (a): MPNet at all-mpnet-base-v2's widths, 16 texts of mixed
    length at max_length 128 card against CPU (MPNET_RTOL), then a sweep of
    4,096 texts on the card at batch 256 (texts/s; ms a batch of `encode`
    alone beside its fp32 bound). -> the card's and the CPU's models, for
    (b)."""
    from digat_tpu_torch.plm import mpnet as MP

    t0 = time.perf_counter()
    mcfg = MP.MPNetConfig()
    sd = MP.random_state_dict(mcfg, SEED + 60)
    card, cpu = MP.MPNet.from_state_dict(sd, dev), MP.MPNet.from_state_dict(sd, "cpu")
    del sd
    n_params = sum(p.numel() for p in card.parameters())
    setup_s = time.perf_counter() - t0
    tok = TokenizerDouble(mcfg.vocab_size)
    toks = tok(smoke_texts(MPNET_TEXTS, SEED + 61), "max_length", True, MPNET_LEN, "np")
    t0 = time.perf_counter()
    e_card = MP.encode(card, toks["input_ids"], toks["attention_mask"]).cpu()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    e_cpu = MP.encode(cpu, toks["input_ids"], toks["attention_mask"])
    cpu_s = time.perf_counter() - t0
    err = float((e_card - e_cpu).abs().max())
    norm_err = float((e_card.norm(dim=1) - 1).abs().max())
    lengths = toks["attention_mask"].sum(1)
    say(f"  MPNet {mcfg.num_layers} x {mcfg.hidden_size} ({mcfg.num_heads} heads, FFN "
        f"{mcfg.intermediate_size}, vocabulary {mcfg.vocab_size}): {n_params / 1e6:.1f}M "
        f"parameters, {4 * n_params / 1e6:.1f} MB fp32 (random, seed {SEED + 60}; set-up "
        f"{setup_s:.2f}s); {MPNET_TEXTS} texts of {lengths.min()}-{lengths.max()} tokens at "
        f"max_length {MPNET_LEN}: max |card - cpu| {err:.3e} (limit {MPNET_RTOL:g}), max "
        f"| |e| - 1 | {norm_err:.3e}; card {card_s:.2f}s, cpu {cpu_s:.2f}s")
    if not (e_card.shape == (MPNET_TEXTS, mcfg.hidden_size) and bool(torch.isfinite(e_card).all())
            and err <= MPNET_RTOL and norm_err <= 1e-5):
        failures.append("MPNet card against CPU")
    # the sweep: the embedder (the tokenizer double included) over 4,096 texts
    embed = MP.mpnet_embedder(card, tok, MPNET_LEN, MPNET_BATCH)
    texts = smoke_texts(MPNET_SWEEP, SEED + 62)
    embed(texts[:MPNET_BATCH])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = embed(texts)
    sweep_s = time.perf_counter() - t0
    batch = tok(texts[:MPNET_BATCH], "max_length", True, MPNET_LEN, "np")
    ids = torch.from_numpy(batch["input_ids"]).to(dev)
    mask = torch.from_numpy(batch["attention_mask"]).to(dev)
    batch_ms = time_ms(torch, lambda: MP.encode(card, ids, mask), warmup=1, iters=5)
    flops, nbytes = mpnet_work(mcfg, MPNET_BATCH, MPNET_LEN)
    bound_ms, bound_by = bound(flops, nbytes)
    say(f"  sweep: {MPNET_SWEEP} texts at batch {MPNET_BATCH}, max_length {MPNET_LEN}: "
        f"{sweep_s:.3f}s, {MPNET_SWEEP / sweep_s:.1f} texts/s (the tokenizer double and the "
        f"host copies included); encode alone {batch_ms:.3f} ms a batch "
        f"({MPNET_BATCH * 1e3 / batch_ms:.1f} texts/s, {flops / batch_ms / 1e9:.1f} TFLOP/s); "
        f"fp32 bound {bound_ms:.3f} ms a batch ({bound_by})")
    if not (out.shape == (MPNET_SWEEP, mcfg.hidden_size) and np.isfinite(out).all()):
        failures.append("MPNet sweep: embeddings not finite or of the wrong shape")
    return {"card": card, "cpu": cpu, "tok": tok}


def sag_news(seed: int, per_category: int = 32, categories: int = 4) -> tuple:
    """A seeded news corpus for the SAG miner: `categories` categories of
    `per_category` news, titles and contents drawn from each category's
    topic words and common ones; about one news in eight is test-only,
    some titles repeat (dedup) and some contents are empty (the title
    stands in). -> (rows by category, news id -> index)."""
    rng = np.random.default_rng(seed)
    common = [f"c{k}" for k in range(400)]
    rows, news_id_dict = {}, {"<PAD>": 0}
    for c in range(categories):
        topic = [f"t{c}_{k}" for k in range(24)]
        cat = rows.setdefault(f"cat{c}", [])

        def draw(n):
            return " ".join(str(rng.choice(topic if rng.random() < 0.5 else common))
                            for _ in range(n))

        for _ in range(per_category):
            nid = f"N{len(news_id_dict)}"
            news_id_dict[nid] = len(news_id_dict)
            title = cat[-1][2] if cat and rng.random() < 0.1 else draw(int(rng.integers(4, 13)))
            content = "" if rng.random() < 0.1 else draw(int(rng.integers(12, 30)))
            cat.append(("test" if rng.random() < 0.125 else "train_dev", nid, title, content))
    return rows, news_id_dict


def mpnet_sag_phase(torch, mp, dev, failures) -> None:
    """Phase 23 (b): the `jax_mpnet` embedder (the port's MPNet, full width,
    max_length 32) through `sag.mine_similarity` on a seeded corpus of 128
    news in 4 categories, on the card and on the CPU. The embeddings differ
    by rounding, which moves a cosine by up to 2 max ||e_card - e_cpu||
    (plus 1e-6 for the products): neighbour lists may differ only where
    every place lies within that of the card's (`neighbour_lists_differ`,
    the rule of phase 14's SAG check)."""
    from digat_tpu_torch.data import sag
    from digat_tpu_torch.plm import mpnet as MP

    rows, news_id_dict = sag_news(SEED + 63)
    D = mp["card"].config.hidden_size
    embedders = {side: MemoEmbedder(MP.mpnet_embedder(mp[side], mp["tok"], 32, 256), D)
                 for side in ("card", "cpu")}
    t0 = time.perf_counter()
    card = sag.mine_similarity(rows, news_id_dict, 5, embedders["card"], seed=SEED,
                               device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = sag.mine_similarity(rows, news_id_dict, 5, embedders["cpu"], seed=SEED, device="cpu")
    cpu_s = time.perf_counter() - t0
    texts = list(embedders["cpu"].rows)
    emb_err = max(float(np.linalg.norm(embedders["card"].rows[t] - embedders["cpu"].rows[t]))
                  for t in texts)
    tie = 2 * emb_err + 1e-6
    differ, near_tie = neighbour_lists_differ(card, cpu, tie)
    full = sum(len(v) == 5 for v in cpu.values())
    say(f"  SAG through jax_mpnet: {len(cpu)} neighbour lists ({full} of 5 neighbours), "
        f"{len(texts)} texts embedded at max_length 32, max ||e_card - e_cpu|| {emb_err:.3e}; "
        f"lists differing {differ}, {near_tie} of them at near-ties (cosines within "
        f"{tie:.3e}); card {card_s:.2f}s, cpu {cpu_s:.2f}s")
    if differ != near_tie or emb_err > MPNET_RTOL or full == 0:
        failures.append(f"SAG through jax_mpnet: {differ - near_tie} lists differ card vs cpu "
                        f"beyond near-ties, embeddings {emb_err:.3e} apart")


def layers_ext_phase(torch, dev, failures) -> dict:
    """Phase 23 (c): every `layers_ext` module at graph widths (B 64, N 26
    and 68, D 400; the multi-head GAT with 4 heads), forward and backward
    of a seeded cotangent, the graph modules in training at dropout 0.2
    (A'' on the card, its plain version on the CPU: the same Philox bits),
    card against CPU: the outputs within KERNEL_RTOL of their scale, each
    parameter's and input's gradient within TRAIN_RTOL of its max (at least
    LAYERS_EXT_FLOOR of the module's largest gradient), the CPU
    taking the card's side at every ReLU kink (`KinkReplay`). A'' launches
    twice a dropout call (forward and backward), counted by module. -> the
    A'' launches."""
    import copy

    from digat_tpu_torch import layers_ext as X
    from digat_tpu_torch.ops import dropout as DR

    B, D, A = 64, 400, 256
    rng = np.random.default_rng(SEED + 64)
    gen = lambda: torch.Generator().manual_seed(SEED + 65)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def mask(*shape):
        m = rng.random(shape) < 0.8
        m[(0,) * (len(shape) - 1)] = False  # a fully masked row
        return torch.from_numpy(m)

    def graph(n):
        g = (rng.random((B, n, n)) < 0.25) | np.eye(n, dtype=bool)[None]
        g[0, 1] = False  # a node with no edge: its softmax row is uniform
        return torch.from_numpy(g)

    train = dict(seed=SEED + 66, site=0, dropout=0.2)
    res = dict(train, residual=True)
    cases = [("candidate attention N 26", X.CandidateAttention(D, D, A, gen()),
              [t(B, 26, D), t(B, D)], [mask(B, 26)], {}, 0),
             ("multi-candidate attention N 26, 5 queries", X.MultiCandidateAttention(
                 D, D, A, gen()), [t(B, 26, D), t(B, 5, D)], [mask(B, 26)], {}, 0),
             ("multi SDP attention N 68, 5 queries", X.MultiSDPAttention(D, D, A, gen()),
              [t(B, 68, D), t(B, 5, D)], [mask(B, 5, 68)], {}, 0),
             ("dual SDP attention 26 x 68", X.DualSDPAttention(D, D, A, gen()),
              [t(B, 26, D), t(B, 68, D)], [mask(B, 26, 68)], {}, 0),
             ("parameter-free dual attention 26 x 68", None, [t(B, 26, D), t(B, 68, D)],
              [mask(B, 26, 68)], {}, 0)]
    for n in (26, 68):
        g = [graph(n)]
        cases += [(f"GCN N {n}, 2 layers, LayerNorm, residual", X.GCN(
                       D, D, gen(), hidden_dim=D, num_layers=2, layer_norm=True), [t(B, n, D)],
                   g, res, 1),
                  (f"gated RGCN N {n}, 2 layers", X.GatedRGCN(D, gen(), num_layers=2),
                   [t(B, n, D)], g, train, 1),
                  (f"GAT N {n}, 2 layers, residual", X.GAT(D, gen(), num_layers=2),
                   [t(B, n, D)], g, res, 3),
                  (f"multi-head GAT N {n}, 4 heads, 2 layers, residual", X.MultiheadGAT(
                      D, 4, gen(), num_layers=2), [t(B, n, D)], g, res, 3)]

    def run(module, device, inputs, masks, kw):
        xs = [x.to(device).requires_grad_() for x in inputs]
        ms = [m.to(device) for m in masks]
        out = X.dual_sdp_attention_free(*xs, *ms) if module is None else module(*xs, *ms, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(SEED + 67 + i))
                for i, o in enumerate(outs)]
        torch.autograd.backward(outs, [c.to(device) for c in cots])
        grads = {f"input {i}": x.grad.cpu() for i, x in enumerate(xs)}
        if module is not None:
            grads.update({n: p.grad.cpu() for n, p in module.named_parameters()})
        return [o.detach().cpu() for o in outs], grads

    flips = KinkReplay(torch)  # the flips and terms of every module's replay
    launches, want, worst_out, worst_grad, lines = 0, 0, (0.0, ""), (0.0, ""), []
    t0 = time.perf_counter()
    for name, module, inputs, masks, kw, drops in cases:
        card_module = None if module is None else copy.deepcopy(module).to(dev)
        DR.dropout.launches = 0
        kinks = KinkReplay(torch)
        with kinks.record():
            out_card, g_card = run(card_module, dev, inputs, masks, kw)
        n_launch = DR.dropout.launches
        launches, want = launches + n_launch, want + 2 * drops
        with kinks.replay():
            out_cpu, g_cpu = run(module, torch.device("cpu"), inputs, masks, kw)
        flips.flips.update(kinks.flips)
        flips.terms.update(kinks.terms)
        o_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                    for a, b in zip(out_card, out_cpu))
        floor = LAYERS_EXT_FLOOR * max(float(g.abs().max()) for g in g_cpu.values())
        g_err, g_name = max((float((g_card[k] - g).abs().max())
                             / max(float(g.abs().max()), floor), k) for k, g in g_cpu.items())
        worst_out, worst_grad = max(worst_out, (o_err, name)), max(worst_grad, (g_err, name))
        finite = all(bool(torch.isfinite(o).all()) for o in out_card)
        lines.append(f"    {name}: output {o_err:.3e}, worst gradient {g_err:.3e} ({g_name}), "
                     f"A'' launches {n_launch} (want {2 * drops})")
        if not (o_err <= KERNEL_RTOL and g_err <= TRAIN_RTOL and finite
                and n_launch == 2 * drops):
            failures.append(f"layers_ext {name} card against CPU")
    say(f"  layers_ext, {len(cases)} modules at B {B}, D {D} (card against CPU, the graph "
        f"modules in training at dropout 0.2; {time.perf_counter() - t0:.2f}s): worst output "
        f"{worst_out[0]:.3e} ({worst_out[1]}; limit {KERNEL_RTOL:g} of max(1, max |cpu|)), "
        f"worst gradient {worst_grad[0]:.3e} ({worst_grad[1]}; limit {TRAIN_RTOL:g} of its "
        f"max); A'' launches {launches} (want {want}); kinks where the CPU took the card's "
        f"side against its own: {flips.summary()}")
    for line in lines:
        say(line)
    return {"dropout": launches}


def scatter_add_step_phase(torch, reference, dev, failures) -> dict:
    """Phase 23 (d): phase 22's one-pass MSA-DIGAT step (B 64, dedup, depth
    3, dropout 0) with `sorted_emb_grad=False` on the card, the word table's
    gradient by the library's scatter-add, with the counters reset; held
    against phase 22's CPU reference at phase 9's gates (its forward must
    take the D step's side at every kink, which the reference replayed), D
    launched no time, the word table's gradient within EMB_GRAD_ROUTE_RTOL
    of its max of the D step's, every other gradient the D step's bit for
    bit. -> the step's launches."""
    kinks = KinkReplay(torch)
    t0 = time.perf_counter()
    with kinks.record():
        loss, grads, launches = reference_step(torch, reference["part"], dev,
                                               sorted_emb_grad=False)
    secs = time.perf_counter() - t0
    cpu_loss, cpu = reference["cpu"]
    _, card = reference["card"]
    same_sides = kinks.same_sides(reference["kinks"])
    sp = grad_spread(grads, cpu)
    loss_err = abs(loss - cpu_loss) / max(1.0, abs(cpu_loss))
    top = float(card[WORD_TABLE].abs().max())
    word_err = float((grads[WORD_TABLE] - card[WORD_TABLE]).abs().max()) / max(top, 1e-30)
    others = all(torch.equal(grads[n], card[n]) for n in card if n != WORD_TABLE)
    ran = {k: launches[k] for k in ("msa_encoder_pooled", "msa_encoder_bwd", "gat_scores_fwd",
                                    "gat_scores_bwd", "embedding_grad")}
    say(f"  sorted_emb_grad=False, one MSA-DIGAT step at B "
        f"{reference['part']['config'].batch_size} ({secs:.2f}s): launches {ran}; the D step's "
        f"kink sides: {same_sides}; against the CPU: loss err {loss_err:.3e}, worst gradient "
        f"{sp['worst']:.3e} ({sp['name']}; limit {TRAIN_RTOL:g}); the word table's gradient "
        f"against the D step's {word_err:.3e} of its max (limit {EMB_GRAD_ROUTE_RTOL:g}), every "
        f"other gradient bit for bit: {others}")
    if not (same_sides and loss_err <= TRAIN_RTOL and sp["worst"] <= TRAIN_RTOL
            and word_err <= EMB_GRAD_ROUTE_RTOL and others and ran["embedding_grad"] == 0
            and all(v > 0 for k, v in ran.items() if k != "embedding_grad")):
        failures.append("sorted_emb_grad=False step")
    return launches


def slice13_phase(torch, dev, reference, failures) -> dict:
    """Phase 23, (a) to (d), each in its own guard. -> launches by path for
    the kernels line."""
    out = {}
    for what, run in (("MPNet", lambda: out.update(mpnet=mpnet_phase(torch, dev, failures))),
                      ("SAG through jax_mpnet", lambda: mpnet_sag_phase(
                          torch, out["mpnet"], dev, failures)),
                      ("layers_ext", lambda: out.update(
                          layers_ext=layers_ext_phase(torch, dev, failures))),
                      ("sorted_emb_grad=False", lambda: out.update(
                          scatter=scatter_add_step_phase(torch, reference, dev, failures)))):
        t0 = time.perf_counter()
        try:
            run()
        except Exception:
            traceback.print_exc()
            failures.append(f"phase 23: {what}")
        say(f"  [23 {what}] {time.perf_counter() - t0:.2f}s")
    out.pop("mpnet", None)
    return out


def main() -> int:
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check",
              file=sys.stderr)
        return 2
    try:
        from digat_tpu_torch.config import Config
        from digat_tpu_torch.eval import metrics as M
        from digat_tpu_torch.eval.scorer import CachedScorer
        from digat_tpu_torch.models.model import Model
        from digat_tpu_torch.models.nrms import NRMSModel
        from digat_tpu_torch.native import bindings as loader
        from digat_tpu_torch.ops import build
        from digat_tpu_torch.ops.gat_layer import interactive_gat_layer_fused
        from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled, msa_encoder_pooled_plain
        from digat_tpu_torch.runtime import exact_fp32
    except ImportError as e:
        print(f"chip_smoke: cannot import the port package digat_tpu_torch: {e}", file=sys.stderr)
        return 2
    exact_fp32()
    failures = []
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
            else f"nvidia-smi failed: {smi.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        card = f"nvidia-smi failed: {e}"
    device_kind, device_count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    cores = len(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    if threads > cores:  # the CPU sides' threads no more than the cores they may run on
        torch.set_num_threads(cores)
    say(f"[1 device] {time.perf_counter() - t0:.2f}s torch {torch.__version__} "
        f"cuda {torch.version.cuda} device_count {device_count}; CPU threads "
        f"{torch.get_num_threads()} (of {threads}) on {cores} cores")
    say(card)

    # ---- 2. build: the kernels (nvcc) and, beside them, the host loader (g++) ----
    t0 = time.perf_counter()
    loader_build = {}

    def build_loader():
        try:
            loader_build["path"], loader_build["s"] = loader.build_library()
            loader.library()
        except Exception as e:  # reported after the kernels' build
            loader_build["error"] = e

    loader_thread = threading.Thread(target=build_loader)
    loader_thread.start()
    try:
        path, nvcc_s = build.build_library()
        build.load_library()
    finally:
        loader_thread.join()
    if "error" in loader_build:
        print(f"chip_smoke: the host loader did not build: {loader_build['error']}",
              file=sys.stderr)
        failures.append("host loader build")
    say(f"[2 build] {time.perf_counter() - t0:.2f}s nvcc {nvcc_s:.2f}s "
        f"({'compiled' if nvcc_s else 'reused'} {path.name}); loader g++ "
        f"{loader_build.get('s', math.nan):.2f}s "
        f"({getattr(loader_build.get('path'), 'name', 'not built')})")

    # ---- model and corpus at full width ----
    t0 = time.perf_counter()
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    news_num = 20_000
    tables = make_tables(torch, cfg, news_num, dev, SEED)
    hist, cat, imp_index, cand, labels = make_impressions(cfg, news_num, 512, 8, SEED + 1)
    torch.cuda.synchronize()
    L, Din, D, A = cfg.max_title_length, cfg.word_embedding_dim, cfg.news_embedding_dim, \
        cfg.attention_dim
    bs = cfg.effective_eval_batch_size()
    say(f"[setup] {time.perf_counter() - t0:.2f}s model {cfg.model_name} D {D} depth "
        f"{cfg.graph_depth} Gn {cfg.news_graph_size} Gu {cfg.user_graph_size} news {news_num} "
        f"items {len(cand)} eval batch {bs}")

    entries = {}
    # ---- 3. kernel A ----
    t0 = time.perf_counter()
    try:
        ne = model.news_encoder
        mha, pool = ne.multiheadSelfattention, ne.attention
        x = ne.word_embedding.weight.detach()[tables.news_title_text[:bs]].contiguous()
        mask = tables.news_title_mask[:bs].contiguous()
        args_a = (x, mask, *(t.detach() for t in (
            mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(), mha.W_V.weight.t(),
            mha.W_V.bias, pool.affine1.weight.t(), pool.affine1.bias, pool.affine2.weight[0])),
            cfg.MSA_head_num)
        e = check_kernel(
            torch, f"msa_encoder_pooled [{bs},{L},{Din}]->[{bs},{D}]", msa_encoder_pooled,
            msa_encoder_pooled_plain, args_a, *msa_work(bs, L, Din, D, A))
        say_bound_3xtf32(msa_work(bs, L, Din, D, A), msa_products(bs, L, Din, D, A),
                         e["bound_ms"])
        again = torch.equal(msa_encoder_pooled(*args_a), msa_encoder_pooled(*args_a))
        say(f"    same bits twice: {again}")
        stages = stage_split(torch, lambda: msa_encoder_pooled(*args_a))
        say_stages("msa_encoder_pooled", stages)
        e["stages"] = [dict(kernel=k, launches=n, device_ms=ms) for k, n, ms in stages]
        e["ok"] = e["ok"] and again
        entries["msa_encoder_pooled"] = e
    except Exception:
        traceback.print_exc()
        entries["msa_encoder_pooled"] = dict(ok=False)
    short = {"msa_encoder_pooled": {}, "msa_encoder_bwd": {}}
    for k, shapes in short_title_kernels(torch, dev, train=False).items():
        short[k].update(shapes)
    say(f"[3 kernel A] {time.perf_counter() - t0:.2f}s")

    # ---- 4. kernel B at G = 6, 26, 68 and 96, and at a D not a multiple of 4 ----
    t0 = time.perf_counter()
    try:
        entries["interactive_gat_layer_fused"] = gat_layer_kernels(torch, cfg, model, bs, dev)
    except Exception:
        traceback.print_exc()
        entries["interactive_gat_layer_fused"] = dict(ok=False)
    say(f"[4 kernel B] {time.perf_counter() - t0:.2f}s")
    for name, e in entries.items():
        if not e.get("ok"):
            failures.append(f"kernel {name}")

    # ---- 5. the slice: main path ----
    t0 = time.perf_counter()
    launches = {}
    try:
        scorer = CachedScorer(model, bs)
        msa_encoder_pooled.launches = 0
        interactive_gat_layer_fused.launches = 0
        scores = scorer.score_items(tables, hist, cat, imp_index, cand)
        launches = {"msa_encoder_pooled": msa_encoder_pooled.launches,
                    "interactive_gat_layer_fused": interactive_gat_layer_fused.launches}
        tm = dict(scorer.timings)
        want_a = -(-news_num // bs)
        want_b = 2 * cfg.graph_depth * tm["stage2_batches"]
        auc, mrr, n5, n10 = M.score_impressions_flat(imp_index, labels, scores)
        scorer.score_items(tables, hist, cat, imp_index, cand)  # warm pass, timing only
        warm = scorer.timings
        say(f"  stage 1: {tm['stage1_s']:.3f}s ({news_num} news, warm {warm['stage1_s']:.3f}s); "
            f"stage 2: {tm['items'] / tm['stage2_s']:.1f} items/s ({tm['items']} items, "
            f"{tm['stage2_batches']} batches, warm {warm['items'] / warm['stage2_s']:.1f} items/s)")
        say(f"  launches: A {launches['msa_encoder_pooled']} (want {want_a}), "
            f"B {launches['interactive_gat_layer_fused']} (want {want_b})")
        say(f"  metrics on random weights: auc {auc:.4f} mrr {mrr:.4f} ndcg5 {n5:.4f} "
            f"ndcg10 {n10:.4f}")
        if not (scores.shape == (len(cand),) and np.isfinite(scores).all()):
            failures.append("slice scores not finite or of the wrong shape")
        if launches["msa_encoder_pooled"] != want_a:
            failures.append("stage 1 did not run kernel A once per chunk")
        if launches["interactive_gat_layer_fused"] != want_b:
            failures.append("stage 2 did not run kernel B 2*depth times per batch")
    except Exception:
        traceback.print_exc()
        failures.append("slice")
    say(f"[5 slice] {time.perf_counter() - t0:.2f}s")

    # ---- 6. slice parity: card vs the plain path on the CPU ----
    t0 = time.perf_counter()
    try:
        small_news, small_bs = 2048, 256
        cpu_model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        small = make_tables(torch, cfg, small_news, dev, SEED + 2)
        small_cpu = type(small)(*(t.cpu() for t in small))
        imps = make_impressions(cfg, small_news, 32, 8, SEED + 3)
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for tag, m, t in (("gpu", model, small), ("cpu", cpu_model, small_cpu)):
                s = CachedScorer(m, small_bs).score_items(t, *imps[:4])
                rank_file = os.path.join(tmp, f"{tag}.txt")
                M.write_rank_file(rank_file, M.group_by_impression(imps[2], s))
                metrics = M.score_impressions_flat(imps[2], imps[4], s)
                with open(rank_file, encoding="utf-8") as f:
                    out[tag] = (s, metrics, f.read())
        (s_gpu, m_gpu, r_gpu), (s_cpu, m_cpu, r_cpu) = out["gpu"], out["cpu"]
        err = float(np.abs(s_gpu - s_cpu).max())
        limit = SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
        flips = 0
        for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                          M.group_by_impression(imps[2], s_cpu)):
            og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
            for a, b in zip(og, oc):
                if a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit:
                    flips += 1
        say(f"  {small_news} news, {len(imps[3])} items: max |gpu - cpu| {err:.3e} "
            f"(limit {limit:.3e}); rank flips beyond ties {flips}; rank files identical "
            f"{r_gpu == r_cpu}; metrics gpu {np.round(m_gpu, 6).tolist()} "
            f"cpu {np.round(m_cpu, 6).tolist()}")
        if not (err <= limit and flips == 0 and np.isfinite(s_gpu).all()):
            failures.append("slice parity card vs cpu")
    except Exception:
        traceback.print_exc()
        failures.append("slice parity")
    say(f"[6 parity] {time.perf_counter() - t0:.2f}s")

    # ---- 7. training kernels at the training shapes ----
    t0 = time.perf_counter()
    corpus = make_train_corpus(cfg, tables, (TRAIN_STEPS + 2) * cfg.batch_size, 2000, 32,
                               SEED + 4)
    train_entries, cap = {}, 0
    try:
        from digat_tpu_torch.data import batching, sampling

        probe = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                          cfg.negative_sample_num,
                                          np.random.default_rng(cfg.seed))
        cap = batching.estimate_dedup_capacity(
            corpus.splits["train"].history_idx, corpus.train_behavior_row, corpus.train_pos,
            probe, corpus.news_node_id, cfg.batch_size, seed=cfg.seed)
        say(f"  dedup capacity at B {cfg.batch_size}: {cap} titles")
        train_entries = training_kernels(torch, cfg, model, tables, cap, dev)
        for k, shapes in short_title_kernels(torch, dev, train=True).items():
            short[k].update(shapes)
        if not redesign_report(build):
            failures.append("a product kernel of A, A' or B issues no TF32 HMMA (SASS)")
    except Exception:
        traceback.print_exc()
        failures.append("training kernels")
    for name, e in train_entries.items():
        if not e.get("ok"):
            failures.append(f"kernel {name} (training shapes)")
    say(f"[7 training kernels] {time.perf_counter() - t0:.2f}s")

    # ---- 8. the training slice: main path ----
    t0 = time.perf_counter()
    train_launches, step_ms = {}, None
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            rec, step_ms, train_launches = training_slice(
                torch, replace(cfg, epoch_override=1, dedup_titles=-1), model, corpus,
                run_dir, failures)
        parts = {"A fwd": train_entries["msa_encoder_pooled"]["ms"],
                 "A'": train_entries["msa_encoder_bwd"]["ms"],
                 "D": train_entries["embedding_grad"]["ms"]}
        for G, shape in train_entries["interactive_gat_scores"]["by_shape"].items():
            parts[f"3 x C-fwd {G}"] = 3 * shape["fwd"]["ms"]
            parts[f"3 x C-bwd {G}"] = 3 * shape["bwd"]["ms"]
        rest = step_ms - sum(parts.values())
        say("  where a step goes (kernel times at these shapes, timed alone): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f", the rest (eager ops, GEMMs, A'' masks, optimizer) {rest:.3f} ms")
    except Exception:
        traceback.print_exc()
        failures.append("training slice")
    say(f"[8 training slice] {time.perf_counter() - t0:.2f}s")

    # ---- 9. training parity: card vs the plain path on the CPU ----
    t0 = time.perf_counter()
    try:
        training_parity(torch, cfg, corpus, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("training parity")
    say(f"[9 training parity] {time.perf_counter() - t0:.2f}s")

    # ---- NRMS-SA at full width: 300-d words, L 32, 20 x 20 heads, history 50, M 10 ----
    t0 = time.perf_counter()
    ncfg = replace(cfg, model_family="nrms")
    nmodel = NRMSModel(ncfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    ntables = nrms_tables_for(torch, ncfg, tables, SEED + 6)
    torch.cuda.synchronize()
    say(f"[nrms setup] {time.perf_counter() - t0:.2f}s model {nmodel.model_name} "
        f"{ncfg.nrms_head_num} x {ncfg.nrms_head_dim} heads, attention "
        f"{ncfg.nrms_attention_dim}, M {ncfg.augmented_news_num}, news {news_num}")

    # ---- 10. the attention pair (E and F) at the NRMS-SA shapes ----
    t0 = time.perf_counter()
    try:
        entries["msa_attention"], entries["msa_attention_wide"] = \
            attention_kernels(torch, ncfg, dev)
    except Exception:
        traceback.print_exc()
        entries["msa_attention"], entries["msa_attention_wide"] = dict(ok=False), dict(ok=False)
    for name in ("msa_attention", "msa_attention_wide"):
        if not entries[name].get("ok"):
            failures.append(f"kernel {name}")
    say(f"[10 attention kernels] {time.perf_counter() - t0:.2f}s")

    # ---- 11. NRMS-SA serving: main path and card vs cpu ----
    t0 = time.perf_counter()
    nrms_serve = {}
    try:
        nrms_serve, _, _ = nrms_serving(torch, ncfg, nmodel, ntables,
                                        (hist, cat, imp_index, cand, labels), dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("NRMS-SA serving")
    say(f"[11 NRMS-SA serving] {time.perf_counter() - t0:.2f}s")

    # ---- 12. NRMS-SA training: main path ----
    t0 = time.perf_counter()
    nrms_train, nrms_steps = {}, 0
    ncorpus = make_train_corpus(ncfg, tables, (NRMS_TRAIN_STEPS + 2) * ncfg.batch_size, 2000,
                                32, SEED + 5)
    ncorpus.nrms_tables = lambda: ntables
    try:
        with tempfile.TemporaryDirectory() as run_dir:
            nrms_train, _, nrms_steps = nrms_training(
                torch, replace(ncfg, epoch_override=1), nmodel, ncorpus, run_dir, failures)
    except Exception:
        traceback.print_exc()
        failures.append("NRMS-SA training")
    say(f"[12 NRMS-SA training] {time.perf_counter() - t0:.2f}s")

    # ---- 13. NRMS-SA training parity: card vs the plain path on the CPU ----
    t0 = time.perf_counter()
    try:
        training_parity(torch, ncfg, ncorpus, dev, failures, nrms=True)
    except Exception:
        traceback.print_exc()
        failures.append("NRMS-SA training parity")
    say(f"[13 NRMS-SA training parity] {time.perf_counter() - t0:.2f}s")

    # ---- 24. the wide instance on a model path: NRMS-SA at 4 x 100 heads ----
    t0 = time.perf_counter()
    wide_runs = {}
    try:
        wide_runs = wide_path_phase(torch, ncfg, tables, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("NRMS-SA 4 x 100 (wide instance) path")
    say(f"[24 NRMS-SA 4 x 100, wide pair] {time.perf_counter() - t0:.2f}s")

    # ---- 16. kernels A and A' at titles of 48-128 and at heads of dk 128 ----
    t0 = time.perf_counter()
    try:
        for k, shapes in long_title_kernels(torch, dev).items():
            short[k].update(shapes)
    except Exception:
        traceback.print_exc()
        failures.append("kernels A and A' at long titles")
    say(f"[16 long titles] {time.perf_counter() - t0:.2f}s")

    # ---- 17. titles of L 160: the attention pair in the news encoder ----
    t0 = time.perf_counter()
    route_launches = {}
    try:
        route_launches = long_route(torch, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("L 160 route")
    say(f"[17 L 160 route] {time.perf_counter() - t0:.2f}s")

    # ---- 18. the five ablations and CNN-DIGAT at full width ----
    variant_runs = {}
    for name, over in VARIANTS:
        t0 = time.perf_counter()
        try:
            variant_runs[name] = variant_phase(torch, name, replace(cfg, **over), tables, dev,
                                               failures)
        except Exception:
            traceback.print_exc()
            failures.append(f"variant {name}")
        say(f"[18 {name}] {time.perf_counter() - t0:.2f}s")

    # ---- 20. compute_dtype bfloat16: the bf16 instances of A, A' and B ----
    t0 = time.perf_counter()
    bf16_launches, bf16_entries = {}, {}
    try:
        bf16_entries, bf16_launches, _ = bf16_phase(torch, cfg, tables, hist, cat, imp_index,
                                                    cand, cap, dev, failures, step_ms)
        entries.update(bf16_entries)
    except Exception:
        traceback.print_exc()
        failures.append("bf16 phase")
    say(f"[20 bf16] {time.perf_counter() - t0:.2f}s")

    # ---- 21. bfloat16 for NRMS-SA, NRMS, CNN-DIGAT and MSA at L 160 ----
    t0 = time.perf_counter()
    bf16_runs = {}
    try:
        more_entries, bf16_runs = bf16_more_phase(torch, cfg, tables, cap, dev, failures)
        entries.update(more_entries)
    except Exception:
        traceback.print_exc()
        failures.append("bf16 phase 21")
    say(f"[21 bf16 models] {time.perf_counter() - t0:.2f}s")

    # ---- 22. data parallelism: two gloo ranks on the card, NCCL at world 1 ----
    t0 = time.perf_counter()
    dp_launches, reference = {}, None
    try:
        dp_launches, reference = dp_phase(torch, cfg, ncfg, dev, failures)
    except Exception:
        traceback.print_exc()
        failures.append("data-parallel phase")
    say(f"[22 data-parallel] {time.perf_counter() - t0:.2f}s")

    # ---- 23. slice 13: MPNet, the jax_mpnet SAG, layers_ext, the scatter-add step ----
    t0 = time.perf_counter()
    slice13 = slice13_phase(torch, dev, reference, failures)
    say(f"[23 slice 13] {time.perf_counter() - t0:.2f}s")

    # ---- 14. the CLI at the production cell, from TSV files ----
    cells = parity_cells()
    cli_launches = {}
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        try:
            # 5 of the cell's 6 epochs, 4 of the matrix cell's 8 (the run's
            # 300 s): the prod cell's seed 0 passes 0.55 at epoch 4,
            # the matrix cell's 0.66 at epoch 3
            cli_launches["cli prod"] = cli_cell(torch, cells, "prod", workdir, 0.55, failures,
                                                sag_check=True, epochs=5, launched=True)
        except Exception:
            traceback.print_exc()
            failures.append("CLI, production cell")
        say(f"[14 CLI, production cell] {time.perf_counter() - t0:.2f}s")

        # ---- 15. the CLI at the matrix cell: titles of L 16 ----
        t0 = time.perf_counter()
        try:
            cli_launches["cli matrix L16"] = cli_cell(torch, cells, "matrix-msa", workdir, 0.66,
                                                      failures, epochs=4)
        except Exception:
            traceback.print_exc()
            failures.append("CLI, matrix cell at L 16")
        say(f"[15 CLI, matrix cell at L 16] {time.perf_counter() - t0:.2f}s")

        # ---- 19. the CLI at the matrix cell of wo_interaction ----
        t0 = time.perf_counter()
        try:
            mean, sigma, _ = cells.TARGETS["matrix-wo_interaction"]
            cli_launches["cli matrix wo_interaction"] = cli_cell(
                torch, cells, "matrix-wo_interaction", workdir, round(mean - 3 * sigma, 4),
                failures, epochs=5)
        except Exception:
            traceback.print_exc()
            failures.append("CLI, matrix cell of wo_interaction")
        say(f"[19 CLI, matrix-wo_interaction] {time.perf_counter() - t0:.2f}s")

    # ---- kernels line ----
    if "msa_encoder_pooled" in train_entries and "msa_encoder_pooled" in entries:
        serve = entries["msa_encoder_pooled"]
        entries["msa_encoder_pooled"] = dict(
            serve, by_shape={f"serving N{bs}": serve,
                             f"training N{cap} dropout {cfg.dropout_rate}":
                                 train_entries["msa_encoder_pooled"]})
    if "msa_encoder_bwd" in train_entries:
        main_bwd = train_entries["msa_encoder_bwd"]
        train_entries["msa_encoder_bwd"] = dict(
            main_bwd, by_shape={f"training N{cap} dropout {cfg.dropout_rate}": main_bwd})
    for name, e in train_entries.items():
        entries.setdefault(name, e)
    for name, shapes in short.items():  # A and A' at titles shorter than 32, and longer
        e = entries.setdefault(name, dict(ok=False))
        e.setdefault("by_shape", {}).update(shapes)
        e["ok"] = all(v.get("ok") for v in e["by_shape"].values())
        if not all(v.get("ok") for v in shapes.values()):
            failures.append(f"kernel {name} at titles other than 32")
    by_path = {name: {"serving": launches.get(name, 0), "training": train_launches.get(name, 0)}
               for name in counters()}
    by_path["interactive_gat_scores"] = {
        "training": {k: train_launches.get(k, 0) for k in ("gat_scores_fwd", "gat_scores_bwd")}}
    by_path["msa_attention"] = {
        "nrms serving": {"fwd": nrms_serve.get("msa_attention_fwd", 0),
                         "bwd": nrms_serve.get("msa_attention_bwd", 0)},
        "nrms training": {"fwd": nrms_train.get("msa_attention_fwd", 0),
                          "bwd": nrms_train.get("msa_attention_bwd", 0),
                          "steps": nrms_steps}}
    by_path["dropout"]["nrms training"] = nrms_train.get("dropout", 0)
    by_path["msa_attention"]["L160 route"] = {
        "fwd": route_launches.get("msa_attention_fwd", 0),
        "bwd": route_launches.get("msa_attention_bwd", 0)}
    for kernel in ("dropout", "embedding_grad"):
        by_path[kernel]["L160 route"] = route_launches.get(kernel, 0)
    for vname, run in variant_runs.items():
        for stage in ("serving", "training"):
            counts = run.get(stage, {})
            for name in counters():
                if name in by_path and counts.get(name):
                    by_path[name][f"{vname} {stage}"] = counts[name]
            if counts.get("gat_scores_fwd"):
                by_path["interactive_gat_scores"][f"{vname} {stage}"] = {
                    k: counts.get(k, 0) for k in ("gat_scores_fwd", "gat_scores_bwd")}
    for stage, counts in bf16_launches.items():
        for name in ("msa_encoder_pooled_bf16", "msa_encoder_bwd_bf16",
                     "interactive_gat_layer_fused_bf16", "gat_scores_fwd", "gat_scores_bwd",
                     "embedding_grad", "dropout", "dropout_bf16"):
            if counts.get(name):
                target = "interactive_gat_scores" if name.startswith("gat_scores") else name
                if target == name:
                    by_path[name][f"bf16 {stage}"] = counts[name]
                else:
                    by_path[target].setdefault(f"bf16 {stage}", {})[name] = counts[name]
    # phase 21: the bf16 instances of the pair, A'', B and C by model and path
    by_path["msa_attention_bf16"] = {}
    for model, run in bf16_runs.items():
        for stage in ("serving", "training"):
            counts = run.get(stage, {})
            path = f"{model} bf16 {stage}"
            if counts.get("msa_attention_fwd_bf16") or counts.get("msa_attention_bwd_bf16"):
                by_path["msa_attention_bf16"][path] = {
                    "fwd": counts.get("msa_attention_fwd_bf16", 0),
                    "bwd": counts.get("msa_attention_bwd_bf16", 0)}
            for name in ("dropout_bf16", "interactive_gat_layer_fused_bf16_act",
                         "gat_scores_fwd_bf16"):
                if counts.get(name):
                    by_path[name][path] = counts[name]
            for name in ("interactive_gat_layer_fused_bf16", "embedding_grad", "dropout"):
                if counts.get(name):
                    by_path[name][path] = counts[name]
            if counts.get("msa_attention_fwd"):
                by_path["msa_attention"][path] = {"fwd": counts["msa_attention_fwd"],
                                                  "bwd": counts.get("msa_attention_bwd", 0)}
            if counts.get("gat_scores_fwd") or counts.get("gat_scores_bwd"):
                by_path["interactive_gat_scores"][path] = {
                    k: counts.get(k, 0) for k in ("gat_scores_fwd", "gat_scores_bwd")}
    # phase 24: the wide instance, fp32 and bf16, by model path
    by_path["msa_attention_wide"], by_path["msa_attention_wide_bf16"] = {}, {}
    for tag, run in wide_runs.items():
        for stage, counts in run.items():
            for name, suffix in (("msa_attention_wide", ""),
                                 ("msa_attention_wide_bf16", "_bf16")):
                fwd, bwd = (counts.get(f"msa_attention_wide_{d}{suffix}", 0)
                            for d in ("fwd", "bwd"))
                if fwd or bwd:
                    by_path[name][f"{tag} {stage}"] = {"fwd": fwd, "bwd": bwd}
    for path, counts in dp_launches.items():  # phase 22, by rank
        for name in ("msa_encoder_pooled", "msa_encoder_bwd", "dropout", "embedding_grad"):
            by_path[name][f"{path} training"] = counts[name]
        by_path["interactive_gat_scores"][f"{path} training"] = {
            k: counts[k] for k in ("gat_scores_fwd", "gat_scores_bwd")}
        by_path["msa_encoder_pooled"][f"{path} serving"] = counts["serving msa_encoder_pooled"]
        by_path["interactive_gat_layer_fused"][f"{path} serving"] = \
            counts["serving interactive_gat_layer_fused"]
        by_path["msa_attention"][f"{path} nrms training"] = {
            "fwd": counts["msa_attention_fwd"], "bwd": counts["msa_attention_bwd"]}
        by_path["msa_attention"][f"{path} nrms serving"] = {
            "fwd": counts["serving msa_attention_fwd"], "bwd": 0}
    # phase 23: A'' in layers_ext's training legs; the scatter-add step's
    # kernels, D among them at 0
    if "layers_ext" in slice13:
        by_path["dropout"]["layers_ext training"] = slice13["layers_ext"]["dropout"]
    if "scatter" in slice13:
        counts = slice13["scatter"]
        for name in ("msa_encoder_pooled", "msa_encoder_bwd", "embedding_grad"):
            by_path[name]["sorted_emb_grad false step"] = counts[name]
        by_path["interactive_gat_scores"]["sorted_emb_grad false step"] = {
            k: counts[k] for k in ("gat_scores_fwd", "gat_scores_bwd")}
    for path, counts in cli_launches.items():
        for name in counters():
            by_path[name][path] = counts.get(name, 0)
        by_path["interactive_gat_scores"][path] = {
            k: counts.get(k, 0) for k in ("gat_scores_fwd", "gat_scores_bwd")}
    source = {
        "msa_encoder_pooled": ("digat_tpu_torch/csrc/msa_encoder.cu",
                               "digat_tpu/ops/pallas/msa_encoder.py:533"),
        "interactive_gat_layer_fused": ("digat_tpu_torch/csrc/gat_layer.cu",
                                        "digat_tpu/ops/pallas/gat_layer.py:135"),
        "msa_encoder_bwd": ("digat_tpu_torch/csrc/msa_encoder_bwd.cu",
                            "digat_tpu/ops/pallas/msa_encoder.py:533"),
        "dropout": ("digat_tpu_torch/csrc/dropout.cu", "digat_tpu/ops/pallas/msa_encoder.py:96"),
        "interactive_gat_scores": ("digat_tpu_torch/csrc/gat_scores.cu",
                                   "digat_tpu/ops/pallas/gat_scores.py:77; "
                                   "digat_tpu/ops/pallas/gat_scores.py:182; "
                                   "digat_tpu/ops/pallas/gat_scores.py:295"),
        "embedding_grad": ("digat_tpu_torch/csrc/emb_grad.cu",
                           "digat_tpu/ops/pallas/emb_grad.py:205"),
        "msa_attention": ("digat_tpu_torch/csrc/msa_attention.cu",
                          "digat_tpu/ops/pallas/msa_attention_grouped.py:292; "
                          "digat_tpu/ops/pallas/msa_attention.py:141; "
                          "digat_tpu/ops/pallas/msa_attention.py:177"),
        # the bf16 instances (compute_dtype bfloat16, phase 20)
        "msa_encoder_pooled_bf16": ("digat_tpu_torch/csrc/msa_encoder.cu",
                                    "digat_tpu/ops/pallas/msa_encoder.py:533"),
        "msa_encoder_bwd_bf16": ("digat_tpu_torch/csrc/msa_encoder_bwd.cu",
                                 "digat_tpu/ops/pallas/msa_encoder.py:533"),
        "interactive_gat_layer_fused_bf16": ("digat_tpu_torch/csrc/gat_layer.cu",
                                             "digat_tpu/ops/pallas/gat_layer.py:135"),
        # the bf16 instances of phase 21
        "msa_attention_bf16": ("digat_tpu_torch/csrc/msa_attention_bf16.cu",
                               "digat_tpu/ops/pallas/msa_attention_grouped.py:292; "
                               "digat_tpu/ops/pallas/msa_attention.py:141; "
                               "digat_tpu/ops/pallas/msa_attention.py:177"),
        "dropout_bf16": ("digat_tpu_torch/csrc/dropout.cu",
                         "digat_tpu/ops/pallas/msa_encoder.py:96"),
        "interactive_gat_layer_fused_bf16_act": ("digat_tpu_torch/csrc/gat_layer.cu",
                                                 "digat_tpu/ops/pallas/gat_layer.py:135"),
        "gat_scores_fwd_bf16": ("digat_tpu_torch/csrc/gat_scores.cu",
                                "digat_tpu/ops/pallas/gat_scores.py:77"),
        # the pair's wide instance (dk 65-128), fp32 (phase 10) and bf16
        # (phase 21), on NRMS-SA at 4 x 100 heads (phase 24)
        "msa_attention_wide": ("digat_tpu_torch/csrc/msa_attention_wide.cu",
                               "digat_tpu/ops/pallas/msa_attention.py:141; "
                               "digat_tpu/ops/pallas/msa_attention.py:177"),
        "msa_attention_wide_bf16": ("digat_tpu_torch/csrc/msa_attention_wide.cu",
                                    "digat_tpu/ops/pallas/msa_attention.py:141; "
                                    "digat_tpu/ops/pallas/msa_attention.py:177"),
    }
    kernels = []
    for name, (src, replaces) in source.items():
        e = entries.get(name, {})
        paths = by_path[name]
        total = sum(v if isinstance(v, int) else
                    sum(n for key, n in v.items() if key != "steps") for v in paths.values())
        if total == 0:
            failures.append(f"kernel {name} was launched no time on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total, "launches_by_path": paths, "max_abs_err": e.get("max_abs_err"),
            "ms": e.get("ms"), "plain_ms": e.get("plain_ms"), "bound_ms": e.get("bound_ms"),
            "bound_by": e.get("bound_by"), "library_ms": e.get("library_ms"),
            **({"stages": e["stages"]} if "stages" in e else {}),
            **({"main_shape": e["main_shape"]} if "main_shape" in e else {}),
            "ok": bool(e.get("ok")), **({"by_shape": e["by_shape"]} if "by_shape" in e else {}),
        })
    say(json.dumps({"kernels": kernels}))
    say("[tools] " + ", ".join(f"{k} {n} calls {s:.2f}s" for k, (s, n) in TOOL_S.items()))
    say(f"[total] {time.perf_counter() - t_start:.2f}s")
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_kind,
                                           "count": device_count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # phase 22's ranks, started by dp_phase
        sys.exit(dp_rank(*sys.argv[2:4]))
    sys.exit(main())
