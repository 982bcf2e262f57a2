#!/usr/bin/env python3
"""Time variants of the attention pair's kernels on one GPU.

    python3 scripts/attention_variants.py [--out DIR] [variant ...]

Each variant is `digat_tpu_torch/csrc/msa_attention.cu` (its header
`msa_attention.cuh` inlined and its wide instance `msa_attention_wide.cu`
appended: one file) with a few text substitutions (`VARIANTS`): the file as it is, and the design choices its
header names, undone one at a time. Every variant is compiled alone (the
build's nvcc flags, all started together) into a shared library under
`--out`, and loaded with ctypes; ptxas's spills and the registers of the
head-width-20 float4 instantiations are printed. Then each variant's C
entry points run at the NRMS-SA shapes of `chip_smoke.py`'s phase 10 (random
inputs from a seed, an all-masked sequence), checked against the plain
version (max |kernel - plain|) and timed: the median over 5 windows of CUDA
events around 20 back-to-back launches (`chip_smoke.device_ms`). Needs a
CUDA device and nvcc;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.ops import build  # noqa: E402
from digat_tpu_torch.ops import msa_attention as MA  # noqa: E402

SOURCE = build.CSRC_DIR / "msa_attention.cu"
HEADER, WIDE = build.CSRC_DIR / "msa_attention.cuh", build.CSRC_DIR / "msa_attention_wide.cu"
INCLUDE = '#include "msa_attention.cuh"\n'


def pair_source() -> str:
    """The pair as one translation unit: the header inlined where the main
    file includes it, the wide instance appended."""
    header = HEADER.read_text().replace("#pragma once\n", "", 1)
    return (SOURCE.read_text().replace(INCLUDE, header, 1)
            + WIDE.read_text().replace(INCLUDE, "", 1))
_BOUNDS = [("__launch_bounds__(kMaxGroup * 32, 1)", "__launch_bounds__(kMaxGroup * 32)"),
           ("__launch_bounds__(kMaxWarps * 32, 1)", "__launch_bounds__(kMaxWarps * 32)")]
VARIANTS = {
    "as built": [],
    # ptxas free to trade spills for occupancy
    "no minimum blocks": _BOUNDS,
    # a warp per head in the forward at every L
    "forward warp per head at every L": [
        ("const bool shared = L > kShortL;", "const bool shared = false;"),
        ("  if (L <= kShortL) {\n    warps = warps_per_block(unit_bytes",
         "  if (true) {\n    warps = warps_per_block(unit_bytes"),
        ("(L <= kShortL ? warps : 1) * unit_bytes", "warps * unit_bytes")],
    # the recomputing backward (two parts, transposed dk/dv) at every L
    "long backward at every L": [
        ("} else if (L <= kShortL) {\n    const size_t warp_bytes = sizeof(float) * bwd_warp_floats",
         "} else if (false) {\n    const size_t warp_bytes = sizeof(float) * bwd_warp_floats")],
    # deeper unrolling of the short backward's pass 1
    "short backward unroll 8": [("#pragma unroll 4", "#pragma unroll 8")],
    # the online softmaxes over tiles of 32 keys
    "tiles of 32 keys": [("constexpr int kTile = 16;", "constexpr int kTile = 32;")],
}
HEADS, DK = 20, 20
SHAPES = [  # (what, N, L, head stride), as chip_smoke.py's phase 10 at B 64, M 10
    ("titles, serving chunk", 1024, 32, 20), ("titles, training step", 6720, 32, 20),
    ("user, serving batch", 1024, 50, 20), ("user, training step", 64, 50, 20),
    ("titles, E layout dkp 32", 1024, 32, 32), ("user, E layout dkp 64", 1024, 50, 64),
    ("F only (L > 128)", 256, 150, 20),
]


def build_variants(names, out):
    """Compile each variant; returns {name: ctypes library}."""
    source = pair_source()
    procs = {}
    for i, name in enumerate(names):
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) < 1:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {SOURCE.name}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"variant{i}.cu")
        with open(cu, "w", encoding="utf-8") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(out, f"variant{i}.so"), cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter(), i)
    libs = {}
    for name, (proc, t0, i) in procs.items():
        log = proc.communicate()[0]
        print(f"{name}: nvcc rc {proc.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
        if proc.returncode:
            print(log[-4000:])
            continue
        kernel, spills, regs = None, [], []
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*(msa_attention_\w+?_kernel)ILi(\d+)ELb(\d)",
                          line)
            if m:
                kernel = f"{m.group(1)} W {m.group(2)} {'float4' if m.group(3) == '1' else 'scalar'}"
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and kernel and (m.group(1), m.group(2)) != ("0", "0"):
                spills.append(f"{kernel}: {m.group(1)} / {m.group(2)} B")
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel and kernel.endswith("W 20 float4"):
                regs.append(f"{kernel.split()[0]} {m.group(1)}")
        print(f"  registers at W 20, float4: {', '.join(regs)}")
        print(f"  spills (stores / loads): {'; '.join(spills) or 'none'}")
        lib = ctypes.CDLL(os.path.join(out, f"variant{i}.so"))
        for fn in ("msa_attention_fwd_f32", "msa_attention_bwd_f32"):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = build.SIGNATURES[fn]
        lib.msa_attention_init.restype = ctypes.c_int
        if lib.msa_attention_init() != 0:
            raise SystemExit(f"variant {name!r}: msa_attention_init failed")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(build.BUILD_DIR / "variants"))
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True)
    print(smi.stdout.strip())
    os.makedirs(args.out, exist_ok=True)
    libs = build_variants(args.variants, args.out)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for what, N, L, hs in SHAPES:
        g = torch.Generator(device=dev).manual_seed(N + L + hs)
        rs = HEADS * hs
        q, k, v, do = (F.pad(torch.randn((N, L, HEADS, DK), generator=g, device=dev),
                             (0, hs - DK)).reshape(N, L, rs) for _ in range(4))
        mask = torch.rand((N, L), generator=g, device=dev) < 0.8
        mask[:, 0] = True
        mask[0] = False
        want = (MA.attention_plain_strided(q, k, v, HEADS, DK, mask),
                *MA.attention_bwd_plain(q, k, v, mask, do, HEADS, DK))
        out, dq, dkk, dv = (torch.empty_like(q) for _ in range(4))
        scale = 1.0 / math.sqrt(DK)
        print(f"{what} [{N},{L},{HEADS}x{hs}]")
        for name, lib in libs.items():
            fwd = lambda: lib.msa_attention_fwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(), N,
                HEADS, L, DK, rs, hs, scale, stream)
            bwd = lambda: lib.msa_attention_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dkk.data_ptr(), dv.data_ptr(), N, HEADS, L, DK, rs, hs, scale,
                stream)
            t_fwd, t_bwd = smoke.device_ms(torch, fwd), smoke.device_ms(torch, bwd)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip((out, dq, dkk, dv), want))
            print(f"  {name}: fwd {t_fwd:.4f} ms, bwd {t_bwd:.4f} ms, max |kernel - plain| "
                  f"{err:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
