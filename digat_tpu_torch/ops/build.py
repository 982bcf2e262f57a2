"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` for `sm_90a`, one process a source, all
started together, and links the objects into one shared library with a
plain C interface, which `ctypes` loads. No PyTorch headers
are included, so the build takes seconds, not minutes. The library goes to
`digat_tpu_torch/_build/` (ignored by git) under a name that carries the
hash of the sources and flags, so a changed source rebuilds and an
unchanged one is reused.

Each C entry point takes device pointers, sizes and a `cudaStream_t`,
launches on that stream, and returns `cudaGetLastError()` as an int. A
wrapper makes the call inside `launch_on(tensor.device)`, which makes the
tensor's device current around it (a guard only where another device is
current) and hands over the library, initialised on that device, and that
device's current stream."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import sys
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
    # N, L, Din, heads, dk, A, dropout on -> floats of scratch
    "msa_encoder_fwd_scratch_floats": ([_I] * 7, _LL),
    # x, mask, wqkv, bqkv, w1, b1, v, out, scratch, N, L, Din, heads, dk, A, scale,
    # thresh, drop_scale, seed, site, stream
    "msa_encoder_pooled_f32": ([_P] * 9 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # the same, x, wqkv and w1 bf16
    "msa_encoder_pooled_bf16": ([_P] * 9 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # N, L, Din, heads, dk, A -> floats of scratch
    "msa_encoder_bwd_scratch_floats": ([_I] * 6, _LL),
    # x, mask, wqkv, bqkv, w1, b1, v, dp, dx, dwqkv, dbqkv, dw1, db1, dv, scratch,
    # N, L, Din, heads, dk, A, scale, thresh, drop_scale, seed, site, stream
    "msa_encoder_bwd_f32": ([_P] * 15 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # the same, x, wqkv, w1 and dx bf16
    "msa_encoder_bwd_bf16": ([_P] * 15 + [_I] * 6 + [_F, _U, _F, _U, _U, _P], _I),
    # out, rows, cols, row_offset, seed, site, thresh, stream
    "dropout_keep_mask_u8": ([_P, _LL, _I, _LL, _U, _U, _U, _P], _I),
    # x, out, rows, cols, row_offset, seed, site, thresh, scale, stream
    "dropout_apply_f32": ([_P, _P, _LL, _I, _LL, _U, _U, _U, _F, _P], _I),
    # x, q, wy, by, w3, b3, y, k3, M, B, Dp, stream
    "gat_layer_project_f32": ([_P] * 8 + [_I] * 3 + [_P], _I),
    # the same, wy and w3 bf16
    "gat_layer_project_bf16": ([_P] * 8 + [_I] * 3 + [_P], _I),
    # x, adj, s, h, ldh, out, B, G, D, TI, CG, slope, stream
    "gat_layer_attend_f32": ([_P] * 4 + [_I, _P] + [_I] * 5 + [_F, _P], _I),
    # k1, ld1, k2, ld2, k3, a, out, B, G, D, R, TIb, TJb, stream
    "gat_scores_fwd_f32": ([_P, _I, _P, _I, _P, _P, _P] + [_I] * 6 + [_P], _I),
    # k1, ld1, k2, ld2, k3, a, g, gk1, gk2, gk3, ga, ga_part, B, G, D, ntiles, JT, DT,
    # stream
    "gat_scores_bwd_f32": ([_P, _I, _P, _I] + [_P] * 8 + [_I] * 6 + [_P], _I),
    # g, ids, perm, partial, out, ntok, V, D, chunk, stream
    "emb_grad_f32": ([_P] * 5 + [_LL, _I, _I, _I, _P], _I),
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
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    jobs = []  # (command, process), one a source, all running at once
    t0 = time.perf_counter()
    try:
        for src in (p for p in _sources() if p.suffix == ".cu"):
            obj = BUILD_DIR / f"{src.stem}.{os.getpid()}.o"
            cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
        logs = [(cmd, proc.communicate(timeout=600)[0], proc.returncode)
                for cmd, _, proc in jobs]
        objs = [str(obj) for _, obj, _ in jobs]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
        if all(rc == 0 for _, _, rc in logs):
            proc = subprocess.run(link, capture_output=True, text=True, timeout=600)
            logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "nvcc.log").write_text("".join(text for _, text, _ in logs))
    failed = [(cmd, text, rc) for cmd, text, rc in logs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text}")
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


def _ready(index: int) -> ctypes.CDLL:
    """The library with its kernels initialised on device `index`."""
    lib = _library()
    if index not in _READY:
        with torch.cuda.device(index):
            for name in INITS:
                check(lib, getattr(lib, name)(), name)
        _READY.add(index)
    return lib


def load_library(device=None) -> ctypes.CDLL:
    """The kernels' library with its kernels initialised on `device` (a
    CUDA device; by default the current one). Each `*_init` grants its
    kernels' opt-in shared memory on the current device, so it runs once
    per device index, with that device current."""
    device = None if device is None else torch.device(device)
    return _ready(torch.cuda.current_device() if device is None or device.index is None
                  else device.index)


def _current_stream(index: int) -> int:
    """The raw `cudaStream_t` of device `index`'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


class launch_on:
    """Around one kernel's C call: `with launch_on(device) as (lib, stream)`
    makes `device` current and yields the library initialised there and the
    device's current stream as an int, so a tensor on any CUDA device
    launches on that device. Where `device` is already current (the common
    case) no guard is entered; otherwise `torch.cuda.device` switches and
    restores."""

    __slots__ = ("_device", "_guard")

    def __init__(self, device):
        self._device = device if isinstance(device, torch.device) else torch.device(device)
        self._guard = None

    def __enter__(self):
        device, current = self._device, torch.cuda.current_device()
        index = current if device.index is None else device.index
        if device.type != "cuda" or index != current:
            self._guard = torch.cuda.device(device)
            self._guard.__enter__()
        try:
            return _ready(index), _current_stream(index)
        except BaseException:
            # `with` calls no __exit__ when __enter__ raises: leave the guard here
            self.__exit__(*sys.exc_info())
            raise

    def __exit__(self, *exc):
        if self._guard is not None:
            self._guard.__exit__(*exc)
        return False


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
