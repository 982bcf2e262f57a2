"""Build and load the port's CUDA kernels.

One `nvcc` call compiles every `csrc/*.cu` for `sm_90a` into one shared
library with a plain C interface, which `ctypes` loads. No PyTorch headers
are included, so the build takes seconds, not minutes. The library goes to
`digat_tpu_torch/_build/` (ignored by git) under a name that carries the
hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused.

Each C entry point takes device pointers, sizes and a `cudaStream_t`,
launches on that stream, and returns `cudaGetLastError()` as an int. A
wrapper makes the call inside `launch_on(tensor.device)`, which makes the
tensor's device current around it and hands over the library, initialised
on that device, and that device's current stream."""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U, _LL = ctypes.c_uint, ctypes.c_longlong

# C signatures: name -> (argtypes, restype); an int restype is a cudaError_t
SIGNATURES = {
    # x, mask, wq, bq, wk, wv, bv, w1, b1, v, out, N, L, Din, heads, dk, A, scale,
    # thresh, drop_scale, seed, site, stream
    "msa_encoder_pooled_f32": ([_P] * 11 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # N, L, Din, heads, dk, A -> floats of scratch
    "msa_encoder_bwd_scratch_floats": ([_I] * 6, _LL),
    # x, mask, wq, bq, wk, wv, bv, w1, b1, v, dp, dx, dwqkv, dbqkv, dw1, db1, dv, scratch,
    # N, L, Din, heads, dk, A, scale, thresh, drop_scale, seed, site, stream
    "msa_encoder_bwd_f32": ([_P] * 18 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # out, rows, cols, row_offset, seed, site, thresh, stream
    "dropout_keep_mask_u8": ([_P, _LL, _I, _LL, _U, _U, _U, _P], _I),
    # x, q, w, bW, w1, w2, w3, b3, y, k3, B, G, D, stream
    "gat_layer_project_f32": ([_P] * 10 + [_I] * 3 + [_P], _I),
    # x, adj, y, k3, a, out, B, G, D, slope, stream
    "gat_layer_attend_f32": ([_P] * 6 + [_I] * 3 + [_F, _P], _I),
    # k1, ld1, k2, ld2, k3, a, out, B, G, D, stream
    "gat_scores_fwd_f32": ([_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P], _I),
    # k1, ld1, k2, ld2, k3, a, g, gk1, gk2, gk3, ga, ga_part, B, G, D, stream
    "gat_scores_bwd_f32": ([_P, _I, _P, _I] + [_P] * 8 + [_I] * 3 + [_P], _I),
    # g, perm, seg, first, last, partial, out, ntok, V, D, chunk, stream
    "emb_grad_f32": ([_P] * 7 + [_LL, _LL, _I, _I, _P], _I),
    # q, k, v, mask, out, N, H, L, dk, rs, hs, scale, stream
    "msa_attention_fwd_f32": ([_P] * 5 + [_I] * 6 + [_F, _P], _I),
    # q, k, v, mask, do, dq, dk, dv, N, H, L, dk, rs, hs, scale, stream
    "msa_attention_bwd_f32": ([_P] * 8 + [_I] * 6 + [_F, _P], _I),
}

# Run once per device, with that device current: each reads the card's
# opt-in shared-memory limit and grants it to its kernels there.
INITS = ("msa_encoder_init", "msa_encoder_bwd_init", "gat_layer_init", "gat_scores_init",
         "msa_attention_init")


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def library_path() -> Path:
    return BUILD_DIR / f"libdigat_kernels_{source_hash()}.so"


def build_library() -> tuple:
    """Compile the kernels if the library for the current sources is
    missing. Returns (path, seconds spent compiling, 0.0 when reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out, seconds


@functools.cache
def _library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes set. Loaded
    once per process; its kernels are initialised per device by
    `load_library`."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    lib.digat_error_string.argtypes = [ctypes.c_int]
    lib.digat_error_string.restype = ctypes.c_char_p
    for name in INITS:
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


_READY: set = set()  # CUDA device indices whose kernels are initialised


def load_library(device=None) -> ctypes.CDLL:
    """The kernels' library with its kernels initialised on `device` (a
    CUDA device; by default the current one). Each `*_init` grants its
    kernels' opt-in shared memory on the current device, so it runs once
    per device index, with that device current."""
    lib = _library()
    device = None if device is None else torch.device(device)
    index = torch.cuda.current_device() if device is None or device.index is None \
        else device.index
    if index not in _READY:
        with torch.cuda.device(index):
            for name in INITS:
                check(lib, getattr(lib, name)(), name)
        _READY.add(index)
    return lib


@contextlib.contextmanager
def launch_on(device):
    """Around one kernel's C call: makes `device` current and yields (the
    library initialised there, the device's current stream as an int), so
    a tensor on any CUDA device launches on that device."""
    device = torch.device(device)
    with torch.cuda.device(device):
        yield load_library(device), torch.cuda.current_stream(device).cuda_stream


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.digat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def use_kernel(where) -> bool:
    """The dispatch of every kernel wrapper, for a tensor or a device: True
    on CUDA (launch the kernel), False on the CPU (run the plain version).
    Any other device raises; there is no fallback from CUDA to the plain
    version."""
    device = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")
