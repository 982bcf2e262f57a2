#!/usr/bin/env python3
"""How the tensor cores round the fp32 accumulation of `mma.sync`, for the
TF32 instruction the port's 3xTF32 products use
(m16n8k8.row.col.f32.tf32.tf32.f32) and the bf16 one of its bf16 products
(m16n8k16.row.col.f32.bf16.bf16.f32).

    python3 scripts/mma_rounding.py

One warp runs one instruction with every operand 0 but a single product
a * b, exact in fp32, added to an accumulator c = +-1: a * b = 0.75 ulp(1)
(3 * 2^-26), so round to nearest gives c +- ulp(1) and rounding toward zero
gives c. Also two products in one instruction, each 0.375 ulp(1), whose
exact sum (0.75 ulp) is lost if each is rounded into c on its own. Prints
one JSON line a case and the card's name and power limit. The probe's
source is written and compiled (nvcc, sm_90a) under the kernels' build
directory; nothing of it is part of the port."""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "digat_tpu_torch", "_build", "mma_rounding")

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// lane 0 holds A[0][0..1] (a0), B[0..1][0] (b0) and C[0][0] (c0) of both
// shapes; every other fragment element is 0
__global__ void probe(const uint32_t* a0, const uint32_t* b0, const float* c0, float* d0,
                      int bf16) {
  const int lane = threadIdx.x;
  uint32_t a[4] = {lane == 0 ? a0[0] : 0u, 0u, 0u, 0u};
  uint32_t b[2] = {lane == 0 ? b0[0] : 0u, 0u};
  float d[4] = {lane == 0 ? c0[0] : 0.f, 0.f, 0.f, 0.f};
  if (bf16) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  if (lane == 0) d0[0] = d[0];
}

extern "C" int run(const void* a0, const void* b0, const void* c0, void* d0, int bf16) {
  probe<<<1, 32>>>(static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(b0),
                   static_cast<const float*>(c0), static_cast<float*>(d0), bf16);
  cudaError_t e = cudaDeviceSynchronize();
  return static_cast<int>(e);
}
"""


def build() -> ctypes.CDLL:
    os.makedirs(BUILD, exist_ok=True)
    src, lib = os.path.join(BUILD, "probe.cu"), os.path.join(BUILD, "libprobe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    so.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    so.run.restype = ctypes.c_int
    return so


def bits(x: float) -> int:
    return int(np.array(x, np.float32).view(np.uint32))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mma_rounding: needs a CUDA device", file=sys.stderr)
        return 2
    so = build()
    ulp = 2.0 ** -23
    cases = []
    for c in (1.0, -1.0):
        s = 1.0 if c > 0 else -1.0
        # one product of 0.75 ulp(1): a = 1.5 * 2^-24 (exact in bf16 and TF32), b = 1
        cases.append(("one product 0.75 ulp", c, [(1.5 * 2.0 ** -24 * s, 1.0)]))
        # two products of 0.375 ulp each in one instruction (k 0 and 1)
        cases.append(("two products 0.375 ulp", c, [(1.5 * 2.0 ** -25 * s, 1.0)] * 2))
    rows = []
    for kind in ("tf32", "bf16"):
        for what, c, prods in cases:
            if kind == "bf16":
                # a0 packs A[0][0] (low half) and A[0][1]; b0 packs B[0][0] and B[1][0]
                half = lambda x: bits(x) >> 16
                a0 = half(prods[0][0]) | ((half(prods[1][0]) << 16) if len(prods) > 1 else 0)
                b0 = half(prods[0][1]) | ((half(prods[1][1]) << 16) if len(prods) > 1 else 0)
            else:
                if len(prods) > 1:
                    continue  # the TF32 shape holds one k a lane in a0 and b0
                a0, b0 = bits(prods[0][0]), bits(prods[0][1])
            dev = lambda v, dt: torch.tensor([v], dtype=dt, device="cuda")
            a = dev(np.int64(a0).astype(np.int32).item(), torch.int32)
            b = dev(np.int64(b0).astype(np.int32).item(), torch.int32)
            cc, d = dev(c, torch.float32), dev(0.0, torch.float32)
            err = so.run(a.data_ptr(), b.data_ptr(), cc.data_ptr(), d.data_ptr(),
                         int(kind == "bf16"))
            if err:
                print(f"mma_rounding: CUDA error {err}", file=sys.stderr)
                return 1
            got = float(d.item())
            exact = c + sum(x * y for x, y in prods)
            rows.append({"instruction": kind, "case": what, "c": c, "exact": exact,
                         "result": got, "ulps_from_c": (got - c) / ulp,
                         "rounds": "to nearest" if got != c else "toward zero"})
    for r in rows:
        print(json.dumps(r))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
