#!/usr/bin/env python3
"""Kernels A, A', C and the attention pair timed in turns: one tree of the
package against another on the same card.

    python3 scripts/kernel_turns.py --other OTHER_TREE [--rounds 2]

OTHER_TREE is another checkout's root (for example the parent commit
unpacked with `git archive` into a directory that `.gitignore` lists). Each
turn is one process that imports `digat_tpu_torch` from one tree, builds its
kernels (cached in that tree's `_build/`), and times, with CUDA events
(median of 10 calls after 3 warm-ups, three windows), at the main path's
shapes:

  A  L 32, N 8,960, word dropout 0.2 (the training step's unique titles)
  A  L 32, N 1,024 (the serving chunk)
  A  L 16, N 4,096 at the parity matrix's widths (Din 100, 10 x 20, A 64)
  A' L 32, N 8,960, word dropout 0.2
  the attention pair forward and backward at the NRMS-SA training titles
     [6,720, 32, 20 x 20] and user histories [64, 50, 20 x 20]
  C  forward and backward at B 320, G 68 and 26, D 400 (k1 and k2 column
     blocks of a fused projection, as the training GAT layer passes them)

on inputs drawn from one seed in every process. The turns run this tree,
the other, the other, this tree (`--rounds` times), and the script prints
each turn's times and, per setting, the range of each tree. Both trees are
built first, in parallel. Needs a CUDA device; imports nothing of JAX.

    python3 scripts/kernel_turns.py --worker TREE   (one turn, one JSON line)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

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

    out = {}
    a32 = msa_args(8960, 32, 300, 16, 25, 256, 1)
    out["A L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_pooled(*a32, 16, 0.2, 7, 1))
    s32 = msa_args(1024, 32, 300, 16, 25, 256, 2)
    out["A L32 N1024"] = time_ms(lambda: ME.msa_encoder_pooled(*s32, 16))
    a16 = msa_args(4096, 16, 100, 10, 20, 64, 3)
    out["A L16 N4096"] = time_ms(lambda: ME.msa_encoder_pooled(*a16, 10))
    dp = torch.randn((8960, 400), generator=torch.Generator(device=dev).manual_seed(4),
                     device=dev)
    out["A' L32 N8960 dropout"] = time_ms(lambda: ME.msa_encoder_bwd(*a32, dp, 16, 0.2, 7, 1))
    for what, N, L in (("titles", 6720, 32), ("user", 64, 50)):
        g = torch.Generator(device=dev).manual_seed(N + L)
        q, k, v, do = (torch.randn((N, L, 400), generator=g, device=dev) for _ in range(4))
        mask = torch.rand((N, L), generator=g, device=dev) < 0.8
        mask[:, 0] = True
        out[f"pair fwd {what} [{N},{L}]"] = time_ms(lambda: MA.attention_fwd(q, k, v, mask,
                                                                             20, 20))
        out[f"pair bwd {what} [{N},{L}]"] = time_ms(lambda: MA.attention_bwd(q, k, v, mask, do,
                                                                             20, 20))
    for G in (68, 26):
        g = torch.Generator(device=dev).manual_seed(G)
        y = torch.randn((320, G, 1200), generator=g, device=dev) * 0.3
        k3 = torch.randn((320, 400), generator=g, device=dev) * 0.3
        a = torch.randn(400, generator=g, device=dev) * 0.05
        gs = torch.randn((320, G, G), generator=g, device=dev)
        k1, k2 = y[..., 400:800], y[..., 800:]
        out[f"C fwd B320 G{G}"] = time_ms(lambda: GS.gat_scores_fwd(k1, k2, k3, a))
        out[f"C bwd B320 G{G}"] = time_ms(lambda: GS.gat_scores_bwd(k1, k2, k3, a, gs))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other tree's root")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
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
    runs = {"this": [], "other": []}
    for _ in range(args.rounds):
        for name in ("this", "other", "other", "this"):
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                  trees[name]], capture_output=True, text=True, cwd=trees[name])
            if res.returncode:
                print(res.stderr, file=sys.stderr)
                return 1
            times = json.loads(res.stdout.strip().splitlines()[-1])
            runs[name].append(times)
            print(f"turn {name}: " + json.dumps({k: [round(t, 4) for t in v]
                                                 for k, v in times.items()}), flush=True)
    for key in runs["this"][0]:
        span = {n: (min(min(r[key]) for r in rs), max(max(r[key]) for r in rs))
                for n, rs in runs.items()}
        print(f"{key}: this {span['this'][0]:.4f}-{span['this'][1]:.4f} ms, other "
              f"{span['other'][0]:.4f}-{span['other'][1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
