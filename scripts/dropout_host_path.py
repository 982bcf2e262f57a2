#!/usr/bin/env python3
"""Where the training path's dropout spends its time on the card: the host
path of one site's call, part by part, and its device time by launch, at
the seven graph dropout sites of a full-width MSA-DIGAT training step
(`chip_smoke.mask_sites`: B 64 x 5 graphs, D 400, Gn 26, Gu 68).

    python3 scripts/dropout_host_path.py [--calls 200] [--out FILE]

For each site shape [rows, cols] it prints the host microseconds of one
call (the mean over `--calls` back-to-back calls, the median of five such
windows; the device is drained after each window and the drained wall is
printed beside it) of:

  - the whole site as `layers.dropout` runs it, forward alone (no graph)
    and forward with its backward (`torch.autograd.grad`);
  - the parts of the mask path, each alone: `build.use_kernel`,
    `torch.empty` of the mask, entering and leaving `build.launch_on`,
    the ctypes call of `dropout_keep_mask_u8`, `build.check`, the whole
    `ops.dropout.keep_mask`, and the eager passes around it (`x * scale`,
    the zero scalar, `torch.where`);
  - where the tree has it, the fused entry `ops.dropout.dropout`, forward
    and forward + backward, and the ctypes call of `dropout_apply_f32`;
  - the pieces of a device guard (`torch.cuda.current_device`,
    `current_stream(...).cuda_stream`, the raw stream, entering and
    leaving `torch.cuda.device`);
  - `torch.nn.functional.dropout` at the same shape, forward and forward +
    backward: the same work on torch's own stream, not the same function.

Then the device ms of each launch that one forward + backward of the site
makes (`chip_smoke.stage_split`, torch.profiler). It uses only what the
port's trees since the training slice have (so a copy beside an older tree,
with that tree's `chip_smoke.py`, measures that tree), and writes its
numbers as JSON to `--out`. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch import layers  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.ops import build  # noqa: E402
from digat_tpu_torch.ops import dropout as DR  # noqa: E402


def host_us(fn, calls: int, windows: int = 5) -> tuple:
    """(host us a call, drained wall us a call): medians over `windows` of
    `calls` back-to-back calls of fn()."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(windows):
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter_ns()
        torch.cuda.synchronize()
        t2 = time.perf_counter_ns()
        host.append((t1 - t0) / calls / 1e3)
        wall.append((t2 - t0) / calls / 1e3)
    return float(np.median(host)), float(np.median(wall))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dropout_host_path: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    build.load_library(dev)
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    fused = hasattr(DR, "dropout")
    seed = 4321
    report = {"card": card, "torch": torch.__version__, "fused_entry": fused, "sites": {}}

    with build.launch_on(dev) as (lib, stream):
        pass
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)

    def guard():
        with torch.cuda.device(dev):
            pass

    pieces = {"torch.cuda.current_device": torch.cuda.current_device,
              "current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev)
              .cuda_stream,
              "torch.cuda.device enter + exit": guard}
    if raw_stream is not None:
        pieces["_cuda_getCurrentRawStream"] = lambda: raw_stream(0)
    report["guard_pieces_us"] = {k: host_us(fn, args.calls)[0] for k, fn in pieces.items()}
    for k, v in report["guard_pieces_us"].items():
        print(f"  {k}: {v:.2f} us", flush=True)

    step = {"layers.dropout fwd + bwd": 0.0, "device fwd + bwd": 0.0}
    for k, (what, rows, cols, rate, per_step) in enumerate(smoke.mask_sites(cfg)):
        g = torch.Generator(device=dev).manual_seed(smoke.SEED + 11 + k)
        x = torch.randn((rows, cols), generator=g, device=dev)
        up = torch.randn((rows, cols), generator=g, device=dev)
        xg = x.clone().requires_grad_(True)
        thresh, scale = DR.threshold(rate), 1.0 / (1.0 - rate)
        keep = DR.keep_mask(rows, cols, rate, seed, k, device=dev)
        mask_out = torch.empty((rows, cols), dtype=torch.bool, device=dev)
        xs = x * scale
        zero = torch.zeros((), dtype=x.dtype, device=dev)

        def launch_on():
            with build.launch_on(dev):
                pass

        parts = {
            "layers.dropout fwd": lambda: layers.dropout(x, rate, seed, k),
            "layers.dropout fwd + bwd": lambda: torch.autograd.grad(
                layers.dropout(xg, rate, seed, k), xg, up),
            "build.use_kernel": lambda: build.use_kernel(x),
            "torch.empty (mask)": lambda: torch.empty((rows, cols), dtype=torch.bool, device=dev),
            "build.launch_on enter + exit": launch_on,
            "ctypes dropout_keep_mask_u8": lambda: lib.dropout_keep_mask_u8(
                mask_out.data_ptr(), rows, cols, 0, seed, k, thresh, stream),
            "build.check": lambda: build.check(lib, 0, "keep_mask"),
            "ops.dropout.keep_mask": lambda: DR.keep_mask(rows, cols, rate, seed, k, device=dev),
            "eager x * scale": lambda: x * scale,
            "eager zero scalar": lambda: torch.zeros((), dtype=x.dtype, device=dev),
            "eager torch.where": lambda: torch.where(keep, xs, zero),
            "F.dropout fwd (torch's stream)": lambda: F.dropout(x, rate, training=True),
            "F.dropout fwd + bwd (torch's stream)": lambda: torch.autograd.grad(
                F.dropout(xg, rate, training=True), xg, up),
        }
        if fused:
            out = torch.empty_like(x)
            parts["ops.dropout.dropout fwd"] = lambda: DR.dropout(x, rate, seed, k)
            parts["ops.dropout.dropout fwd + bwd"] = lambda: torch.autograd.grad(
                DR.dropout(xg, rate, seed, k), xg, up)
            parts["ctypes dropout_apply_f32"] = lambda: lib.dropout_apply_f32(
                x.data_ptr(), out.data_ptr(), rows, cols, 0, seed, k, thresh, scale, stream)
        name = f"{what} [{rows},{cols}] rate {rate:g} x{per_step}"
        print(f"{name}:", flush=True)
        site = {"rows": rows, "cols": cols, "rate": rate, "per_step": per_step, "host_us": {},
                "wall_us": {}}
        for part, fn in parts.items():
            h, w = host_us(fn, args.calls)
            site["host_us"][part], site["wall_us"][part] = h, w
            print(f"  {part:40s} host {h:8.2f} us  drained wall {w:8.2f} us", flush=True)
        stages = smoke.stage_split(torch, parts["layers.dropout fwd + bwd"])
        smoke.say_stages(f"layers.dropout fwd + bwd at {name}", stages)
        site["stages"] = [dict(kernel=n, launches=c, device_ms=ms) for n, c, ms in stages]
        step["layers.dropout fwd + bwd"] += per_step * site["wall_us"]["layers.dropout fwd + bwd"]
        step["device fwd + bwd"] += per_step * 1e3 * sum(ms for _, _, ms in stages)
        report["sites"][name] = site
    report["step_us"] = step
    print(f"one step's {sum(s[4] for s in smoke.mask_sites(cfg))} sites, forward and backward: "
          f"drained wall {step['layers.dropout fwd + bwd']:.1f} us, device "
          f"{step['device fwd + bwd']:.1f} us", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
