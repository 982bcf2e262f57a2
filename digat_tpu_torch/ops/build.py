"""Build and load the port's CUDA kernels.

One `nvcc` call compiles every `csrc/*.cu` for `sm_90a` into one shared
library with a plain C interface, which `ctypes` loads. No PyTorch headers
are included, so the build takes seconds, not minutes. The library goes to
`digat_tpu_torch/_build/` (ignored by git) under a name that carries the
hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused.

Each C entry point takes device pointers, sizes and a `cudaStream_t`,
launches on that stream, and returns `cudaGetLastError()` as an int."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signatures: name -> argtypes (restype is int, a cudaError_t)
SIGNATURES = {
    # x, mask, wq, bq, wk, wv, bv, w1, b1, v, out, N, L, Din, heads, dk, A, scale, stream
    "msa_encoder_pooled_f32": [_P] * 11 + [_I] * 6 + [_F, _P],
    # x, q, w, bW, w1, w2, w3, b3, y, k3, B, G, D, stream
    "gat_layer_project_f32": [_P] * 10 + [_I] * 3 + [_P],
    # x, adj, y, k3, a, out, B, G, D, slope, stream
    "gat_layer_attend_f32": [_P] * 6 + [_I] * 3 + [_F, _P],
}

# Run once when the library is loaded: each reads the card's opt-in
# shared-memory limit and grants it to its kernels.
INITS = ("msa_encoder_init", "gat_layer_init")


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
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes set and its
    kernels initialised on the current CUDA device."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.digat_error_string.argtypes = [ctypes.c_int]
    lib.digat_error_string.restype = ctypes.c_char_p
    for name in INITS:
        fn = getattr(lib, name)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        check(lib, fn(), name)
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.digat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
