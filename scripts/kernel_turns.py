#!/usr/bin/env python3
"""Kernels A, A', B, C and the attention pair timed in turns: one tree of
the package against another on the same card.

    python3 scripts/kernel_turns.py --other OTHER_TREE [--rounds 2] [--step] [--stages]
                                    [--pair | --graph]

OTHER_TREE is another checkout's root (for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists). Each
turn is one process that imports `digat_tpu_torch` from one tree, builds its
kernels (cached in that tree's `_build/`), and times, with CUDA events
(median of 10 calls after 3 warm-ups, three windows), at the main path's
shapes:

  A  L 32, N 8,960, word dropout 0.2 (the training step's unique titles)
  A  L 32, N 1,024 (the serving chunk)
  A  L 16, N 4,096 at the parity matrix's widths (Din 100, 10 x 20, A 64)
  A  bf16 (x and the weight matrices bf16, as compute_dtype bfloat16 passes
     them) at L 32, N 8,960 with word dropout 0.2 and at N 1,024
  A' L 32, N 8,960, word dropout 0.2, fp32 and bf16 (x and the weight
     matrices bf16, as compute_dtype bfloat16 passes them)
  A'' bf16 forward at the NRMS word site [215,040, 300] and the CNN's word
     and bank sites [286,720, 300] and [286,720, 400], beside F.dropout on
     the same bf16 tensor
  the attention pair forward and backward, fp32 and bf16 (the same values
     rounded to bf16), at the NRMS-SA training titles [6,720, 32, 20 x 20],
     a serving chunk of titles [1,024, 32, 20 x 20], the user tower's
     serving batch [1,024, 50, 20 x 20] and MSA titles of L 160 [256, 160,
     16 x 25]
  C  forward and backward at B 320, G 68 and 26, D 400 (k1 and k2 column
     blocks of a fused projection, as the training GAT layer passes them)

on inputs drawn from one seed in every process. With --step each turn also
runs one Trainer epoch of MSA-DIGAT at compute_dtype bfloat16, B 64 (the
setting of chip_smoke.py's phase 20, built with that tree's chip_smoke.py
helpers) and reports its median step after two warm-up steps. With --pair
each turn times the attention pair alone. With --graph each turn times
kernels B and C alone:

  B  at B 1,024, G 68 and 26, D 400 (the serving batch), each instance: fp32;
     fp32 x and query with bf16 weights; bf16 x, query and weights (bf16
     activations, CNN-DIGAT at bfloat16)
  C  forward at B 320, G 68 and 26, D 400 (k1 and k2 column blocks of a
     fused projection y, as the training GAT layer passes them), fp32 and
     bf16

and hashes each output, so that the script can say whether B's fp32
instance and C's fp32 forward give the other tree's bits (`torch.equal` of
the same inputs, by SHA-256 of the bytes; the others print whether they
do); with --stages it first splits B's two bf16 instances and C's bf16
forward at both graphs (and B's fp32 instance at G 68) by launch on each
tree. The turns run this tree, the other, the other, this tree
(`--rounds` times), and the script prints each turn's times and, per
setting, the range of each tree. Both trees are built first, in
parallel.

With --stages, before the turns, one process a tree profiles A bf16 (both
settings above) and A' bf16 launch by launch with torch.profiler (this
checkout's chip_smoke.py `stage_split`, 5 calls) and prints each launch's
device ms and each product's TFLOP/s and share of its pass type's dense
peak (`msa_fwd_product_rates`: A's q|k|v one bf16 pass, its pool logits
three bf16 passes on wgmma or two TF32 passes on mma.sync;
`msa_bwd_product_rates`: on wgmma q|k|v one bf16 pass, dW1 six, the rest
three; on mma.sync q|k|v one bf16 pass, dW1 three TF32 passes, the rest
two), and A'' bf16's device ms at its three sites. `--rounds 0` stops
after the stages. Needs a CUDA device; imports nothing of JAX.

    python3 scripts/kernel_turns.py --worker TREE [--step | --stages]   (one JSON line)
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_here():
    """This checkout's chip_smoke.py, loaded apart from the tree's own."""
    spec = importlib.util.spec_from_file_location("smoke_here", os.path.join(HERE,
                                                                             "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bf16_step_ms(torch, dev) -> float:
    """Median step (after two warm-up steps) of one Trainer epoch of
    MSA-DIGAT at compute_dtype bfloat16, B 64, as chip_smoke.py's phase 20
    runs it (the tree's own chip_smoke.py helpers)."""
    import tempfile
    from dataclasses import replace

    import numpy as np

    import chip_smoke as S
    from digat_tpu_torch.config import Config
    from digat_tpu_torch.models.model import Model
    from digat_tpu_torch.train.trainer import Trainer

    cfg = replace(Config(dataset="synthetic", vocabulary_size=40_000, category_num=18),
                  compute_dtype="bfloat16")
    tables = S.make_tables(torch, cfg, 20_000, dev, S.SEED)
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(S.SEED + 20))
    corpus = S.make_train_corpus(cfg, tables, (S.TRAIN_STEPS + 2) * cfg.batch_size, 2000, 32,
                                 S.SEED + 25)
    with tempfile.TemporaryDirectory() as run_dir:
        (rec,) = Trainer(model, replace(cfg, epoch_override=1, dedup_titles=-1), corpus,
                         run_dir, verbose=False).train()
    return float(np.median(rec["step_ms"][2:]))


# the attention pair's shapes: (what, N, L, heads, dk)
PAIR_SHAPES = [("titles", 6720, 32, 20, 20), ("serving chunk", 1024, 32, 20, 20),
               ("user", 1024, 50, 20, 20), ("L 160", 256, 160, 16, 25)]


def pair_times(torch, MA, time_ms, dev) -> dict:
    """The pair forward and backward at PAIR_SHAPES, fp32 and bf16 (masked,
    key 0 kept), by CUDA events."""
    out = {}
    for what, N, L, H, dk in PAIR_SHAPES:
        g = torch.Generator(device=dev).manual_seed(N + L)
        q, k, v, do = (torch.randn((N, L, H * dk), generator=g, device=dev) for _ in range(4))
        mask = torch.rand((N, L), generator=g, device=dev) < 0.8
        mask[:, 0] = True
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            a, b, c, d = (t.to(dtype) for t in (q, k, v, do))
            name = f"[{N},{L},{H}x{dk}]"
            out[f"pair{tag} fwd {what} {name}"] = time_ms(
                lambda: MA.attention_fwd(a, b, c, mask, H, dk))
            out[f"pair{tag} bwd {what} {name}"] = time_ms(
                lambda: MA.attention_bwd(a, b, c, mask, d, H, dk))
    return out


def graph_args(torch, dev):
    """B's and C's inputs at the main path's shapes, from one seed: (what,
    kernel, args) of every case `--graph` times."""
    cases = []
    D = 400
    for G in (68, 26):
        g = torch.Generator(device=dev).manual_seed(60 + G)
        r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
        adj = (torch.rand((1024, G, G), generator=g, device=dev) < 0.25) \
            | torch.eye(G, dtype=torch.bool, device=dev)
        adj[0, 1] = False  # a row with no neighbour
        sc = D ** -0.5
        x, q = r(1024, G, D, sc=0.5), r(1024, D, sc=0.5)
        w = (r(D, D, sc=sc), r(D, sc=0.05), r(D, D, sc=sc), r(D, D, sc=sc), r(D, D, sc=sc),
             r(D, sc=0.05), r(D, sc=sc))
        bf = lambda t: t.to(torch.bfloat16)
        cases.append((f"B fp32 G{G}", "B", (x, adj, q, *w)))
        cases.append((f"B bf16 weights G{G}", "B", (x, adj, q, *(bf(t) if t.dim() == 2 else t
                                                                 for t in w))))
        cases.append((f"B bf16 act G{G}", "B", (bf(x), adj, bf(q), *map(bf, w))))
    for G in (68, 26):
        g = torch.Generator(device=dev).manual_seed(70 + G)
        y = torch.randn((320, G, 3 * D), generator=g, device=dev) * 0.3
        k3 = torch.randn((320, D), generator=g, device=dev) * 0.3
        a = torch.randn(D, generator=g, device=dev) * D ** -0.5
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            yt, k3t, at = y.to(dtype), k3.to(dtype), a.to(dtype)
            cases.append((f"C fwd {tag} B320 G{G}", "C",
                          (yt[..., D:2 * D], yt[..., 2 * D:], k3t, at)))
    return cases


# the cases whose bits --graph holds against the other tree's
GRAPH_SAME_BITS = ("B fp32", "C fwd fp32")


def graph_times(torch, time_ms, dev, split=None) -> dict:
    """Kernels B and C at `graph_args`' cases: each case's times and, under
    "bits:<case>", the SHA-256 of its output's bytes; with `split` (a
    stage_split) the launches of B's two bf16 instances, C's bf16 forward
    and B's fp32 instance at G 68 instead."""
    import hashlib

    from digat_tpu_torch.ops import gat_layer as GL
    from digat_tpu_torch.ops import gat_scores as GS

    kernels = {"B": GL.interactive_gat_layer_fused, "C": GS.gat_scores_fwd}
    out = {}
    for what, k, args in graph_args(torch, dev):
        fn = lambda: kernels[k](*args)
        if split is not None:
            if "B bf16" in what or "fwd bf16" in what or what == "B fp32 G68":
                out[what] = split(torch, fn)
            continue
        res = fn()
        torch.cuda.synchronize()
        out[f"bits:{what}"] = hashlib.sha256(res.view(torch.uint8).cpu().numpy()
                                             .tobytes()).hexdigest()
        out[what] = time_ms(fn)
    return out


def worker(tree: str, step: bool, stages: bool = False, pair: bool = False,
           graph: bool = False) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from digat_tpu_torch.ops import dropout as DR
    from digat_tpu_torch.ops import gat_scores as GS
    from digat_tpu_torch.ops import msa_attention as MA
    from digat_tpu_torch.ops import msa_encoder as ME
    from digat_tpu_torch.runtime import exact_fp32

    exact_fp32()
    dev = torch.device("cuda", 0)

    def time_ms(fn, windows=3, warmup=3, iters=10):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        meds = []
        for _ in range(windows):
            ts = []
            for _ in range(iters):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                ts.append(a.elapsed_time(b))
            meds.append(float(np.median(ts)))
        return meds

    def msa_args(N, L, Din, heads, dk, A, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        D = heads * dk
        r = lambda *s, sc=1.0: torch.randn(s, generator=g, device=dev) * sc
        x = r(N, L, Din)
        mask = torch.rand((N, L), generator=g, device=dev) < 0.75
        mask[0] = False
        return (x, mask, r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(Din, D, sc=Din ** -0.5),
                r(Din, D, sc=Din ** -0.5), r(D, sc=0.1), r(D, A, sc=D ** -0.5), r(A, sc=0.1),
                r(A, sc=A ** -0.5))

    if pair:
        return pair_times(torch, MA, time_ms, dev)
    if graph:
        return graph_times(torch, time_ms, dev, smoke_here().stage_split if stages else None)
    out = {}
    a32 = msa_args(8960, 32, 300, 16, 25, 256, 1)
    dp = torch.randn((8960, 400), generator=torch.Generator(device=dev).manual_seed(4),
                     device=dev)
    b32 = tuple(t.to(torch.bfloat16) if i in (0, 2, 4, 5, 7) else t for i, t in enumerate(a32))
    sites = [(f"{what} [{rows},{cols}]", torch.randn(
        (rows, cols), generator=torch.Generator(device=dev).manual_seed(rows + cols),
        device=dev).to(torch.bfloat16)) for what, rows, cols in (
            ("NRMS words", 215040, 300), ("CNN words", 286720, 300), ("CNN bank", 286720, 400))]
    s32 = msa_args(1024, 32, 300, 16, 25, 256, 2)
    sb32 = tuple(t.to(torch.bfloat16) if i in (0, 2, 4, 5, 7) else t for i, t in enumerate(s32))
    if stages:  # launches with their device ms, from this checkout's chip_smoke.py
        split = smoke_here().stage_split
        out["A bf16 N8960 dropout"] = split(
            torch, lambda: ME.msa_encoder_pooled(*b32, 16, 0.2, 7, 1))
        out["A bf16 N1024"] = split(torch, lambda: ME.msa_encoder_pooled(*sb32, 16))
        out["A' bf16"] = split(torch, lambda: ME.msa_encoder_bwd(*b32, dp, 16, 0.2, 7, 1))
        for what, t in sites:
            out[f"A'' bf16 {what}"] = split(torch, lambda: DR.dropout(t, 0.2, 77, 5))
        return out
    out["A L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_pooled(*a32, 16, 0.2, 7, 1))
    out["A L32 N1024"] = time_ms(lambda: ME.msa_encoder_pooled(*s32, 16))
    out["A bf16 L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_pooled(*b32, 16, 0.2, 7, 1))
    out["A bf16 L32 N1024"] = time_ms(lambda: ME.msa_encoder_pooled(*sb32, 16))
    a16 = msa_args(4096, 16, 100, 10, 20, 64, 3)
    out["A L16 N4096"] = time_ms(lambda: ME.msa_encoder_pooled(*a16, 10))
    out["A' L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_bwd(*a32, dp, 16, 0.2, 7, 1))
    out["A' bf16 L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_bwd(*b32, dp, 16, 0.2, 7,
                                                                          1))
    for what, t in sites:
        out[f"A'' bf16 {what}"] = time_ms(lambda: DR.dropout(t, 0.2, 77, 5))
        out[f"F.dropout bf16 {what}"] = time_ms(lambda: F.dropout(t, 0.2))
    out.update(pair_times(torch, MA, time_ms, dev))
    for G in (68, 26):
        g = torch.Generator(device=dev).manual_seed(G)
        y = torch.randn((320, G, 1200), generator=g, device=dev) * 0.3
        k3 = torch.randn((320, 400), generator=g, device=dev) * 0.3
        a = torch.randn(400, generator=g, device=dev) * 0.05
        gs = torch.randn((320, G, G), generator=g, device=dev)
        k1, k2 = y[..., 400:800], y[..., 800:]
        out[f"C fwd B320 G{G}"] = time_ms(lambda: GS.gat_scores_fwd(k1, k2, k3, a))
        out[f"C bwd B320 G{G}"] = time_ms(lambda: GS.gat_scores_bwd(k1, k2, k3, a, gs))
    if step:
        out["bf16 MSA-DIGAT step B64"] = [bf16_step_ms(torch, dev)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of turns (0: stages only)")
    ap.add_argument("--step", action="store_true",
                    help="also time a bf16 MSA-DIGAT training step at B 64 in each turn")
    ap.add_argument("--stages", action="store_true",
                    help="first profile A bf16, A' bf16 and A'' bf16 launch by launch on each "
                         "tree")
    ap.add_argument("--pair", action="store_true", help="time the attention pair alone")
    ap.add_argument("--graph", action="store_true", help="time kernels B and C alone")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.step, args.stages, args.pair, args.graph)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    trees = {"this": HERE, "other": os.path.abspath(args.other)}
    build = ("import sys; sys.path.insert(0, sys.argv[1]); from digat_tpu_torch.ops import build;"
             " build.build_library()")
    procs = [subprocess.Popen([sys.executable, "-c", build, t]) for t in trees.values()]
    if any(p.wait() for p in procs):
        print("kernel_turns: a build failed", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    if args.stages:
        S = smoke_here()
        for name, tree in trees.items():
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                                  "--stages", *(["--graph"] if args.graph else [])],
                                 capture_output=True, text=True, cwd=tree)
            if res.returncode:
                print(res.stderr, file=sys.stderr)
                return 1
            split = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"stages, {name} tree ({tree}):", flush=True)
            for what, stages in split.items():
                S.say_stages(what, stages)
                if what.startswith("A bf16"):
                    N = 8960 if "N8960" in what else 1024
                    S.say_product_rates(S.msa_fwd_product_rates(stages, N, 32, 300, 400, 256))
                if what == "A' bf16":
                    S.say_product_rates(S.msa_bwd_product_rates(stages, 8960, 32, 300, 400, 256))
    runs = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  trees[name], *(["--step"] if args.step else []),
                                  *(["--pair"] if args.pair else []),
                                  *(["--graph"] if args.graph else [])],
                                 capture_output=True, text=True, cwd=trees[name])
            if res.returncode:
                print(res.stderr, file=sys.stderr)
                return 1
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[name].append(times)
            print(f"turn {name}: " + json.dumps({k: [round(t, 4) for t in v]
                                                 for k, v in times.items()
                                                 if not k.startswith("bits:")}), flush=True)
    same = True
    for key in (k for k in runs["this"][0] if k.startswith("bits:")) if args.rounds else ():
        bits = {n: {r[key] for r in rs} for n, rs in runs.items()}
        equal = len(bits["this"] | bits["other"]) == 1
        print(f"{key[5:]}: the same bits in every turn of both trees: {equal}", flush=True)
        if key[5:].startswith(GRAPH_SAME_BITS):
            same = same and equal
    for key in (k for k in runs["this"][0] if not k.startswith("bits:")) if args.rounds else ():
        span = {n: (min(min(r[key]) for r in rs), max(max(r[key]) for r in rs))
                for n, rs in runs.items()}
        print(f"{key}: this {span['this'][0]:.4f}-{span['this'][1]:.4f} ms, other "
              f"{span['other'][0]:.4f}-{span['other'][1]:.4f} ms", flush=True)
    if not same:
        print("kernel_turns: B fp32 or C's fp32 forward differ from the other tree's bits",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
