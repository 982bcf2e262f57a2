"""ctypes bindings of the port's native host loader (`loader.cpp`), built
at first use.

`g++` compiles `loader.cpp` into `digat_tpu_torch/_build/` (ignored by
git) under a name that carries the hash of the source, the compiler and
its flags, so a changed source rebuilds and an unchanged one is reused.
The library is written under a temporary name and moved into place, so
processes that build at once end with one library. There is no fallback:
a compiler that is missing or fails raises `NativeBuildError` with its
command and output, a parse that the library reports as failed raises
`NativeParseError`, and a file that cannot be read raises the `OSError`
that the plain Python version raises.

The three entry points keep the JAX package's contracts
(`digat_tpu/native/bindings.py`): `parse_behaviors_native` gives ragged
(flat, offsets) arrays, int32 flats, int64 offsets and int8 labels;
`parse_glove_native` maps a duplicate word to its last row;
`expand_graph_native` returns bool graphs."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
COMPILER = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread", "-shared", "-fPIC")


class NativeBuildError(RuntimeError):
    """The loader's library could not be built: no compiler, or it failed."""


class NativeParseError(RuntimeError):
    """The library reported a failed parse (a dedicated exception, not an
    `assert`, so that it survives `python -O`)."""


def source_hash() -> str:
    h = hashlib.sha256(" ".join((COMPILER, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdigat_loader_{source_hash()}.so"


def build_library() -> Tuple[Path, float]:
    """Compile the loader if the library for the current source is missing.
    Returns (path, seconds spent compiling, 0.0 when reused)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [COMPILER, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{COMPILER} failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, time.perf_counter() - t0


_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The loader's library, built on first use, with argtypes set; loaded
    once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build_library()
        lib = ctypes.CDLL(str(path))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.expand_graph.restype = None
        lib.expand_graph.argtypes = [
            i32p, f32p, i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, i32p, u8p, u8p,
        ]
        lib.parse_behaviors.restype = ctypes.c_void_p
        lib.parse_behaviors.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64]
        lib.behaviors_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.behaviors_fill.argtypes = [ctypes.c_void_p, i32p, i64p, i32p, i64p, i32p, i64p,
                                       i32p, i8p, i64p]
        lib.behaviors_free.argtypes = [ctypes.c_void_p]
        lib.parse_glove.restype = ctypes.c_void_p
        lib.parse_glove.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.glove_sizes.argtypes = [ctypes.c_void_p, i64p]
        lib.glove_fill.argtypes = [ctypes.c_void_p, u8p, f32p]
        lib.glove_free.argtypes = [ctypes.c_void_p]
        for name in ("behaviors_sizes", "behaviors_fill", "behaviors_free", "glove_sizes",
                     "glove_fill", "glove_free"):
            getattr(lib, name).restype = None
        _lib = lib
        return _lib


def _check_readable(path: str) -> None:
    """Raise the plain version's OSError (FileNotFoundError, IsADirectoryError,
    PermissionError) for a file that cannot be opened."""
    with open(path, "rb"):
        pass


def expand_graph_native(
    similarity_flat_idx: np.ndarray,  # [total] int32 neighbour news indices
    similarity_flat_cos: np.ndarray,  # [total] float32
    offsets: np.ndarray,  # [news_num + 1] int64
    top_m: int,
    hops: int,
    node_num: int,
    threshold: float,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The BFS expansion of `data.sag.expand_graph` over index-form
    neighbour lists: row r's neighbours are idx[offsets[r]:offsets[r + 1]],
    in rank order. Raises ValueError where the lists could grow a graph
    past `node_num` nodes (the library writes into [node_num] rows)."""
    lib = library()
    idx = np.ascontiguousarray(similarity_flat_idx, np.int32)
    cos = np.ascontiguousarray(similarity_flat_cos, np.float32)
    off = np.ascontiguousarray(offsets, np.int64)
    news_num = len(off) - 1
    if news_num < 0 or off[0] != 0 or off[-1] != len(idx) or len(cos) != len(idx) \
            or (np.diff(off) < 0).any() or (len(idx) and not 0 <= idx.min() <= idx.max()
                                            < news_num):
        raise ValueError("malformed neighbour lists")
    if hops < 0:
        raise ValueError(f"hops {hops} < 0")
    widest = int(np.diff(off).max(initial=0))
    deeper = widest if top_m <= 0 else min(widest, top_m - 1)  # a node past hop 0
    nodes, frontier = 1, widest
    for _ in range(hops):
        nodes, frontier = nodes + frontier, frontier * max(deeper, 0)
    if nodes > node_num:
        raise ValueError(f"lists of up to {widest} neighbours over {hops} hops can reach "
                         f"{nodes} nodes, past node_num {node_num}")
    node_id = np.zeros((news_num, node_num), np.int32)
    graph = np.zeros((news_num, node_num, node_num), np.uint8)
    mask = np.zeros((news_num, node_num), np.uint8)
    lib.expand_graph(idx, cos, off, news_num, top_m, hops, node_num, threshold,
                     node_id, graph, mask)
    return node_id, graph.view(bool), mask.view(bool)


def parse_glove_native(path: str, dim: int) -> Tuple[Dict[str, int], np.ndarray]:
    """Multithreaded parse of a GloVe text file: the contract of
    `data.tokenize._load_glove_txt_py` (a duplicate word keeps its last
    index, as the dict overwrite does there)."""
    lib = library()
    _check_readable(path)
    handle = lib.parse_glove(path.encode("utf-8"), dim)
    try:
        sizes = np.zeros(3, np.int64)
        lib.glove_sizes(handle, sizes)
        rows, word_bytes, ok = (int(x) for x in sizes)
        if not ok:
            raise NativeParseError(f"native GloVe parse failed for {path}")
        words_buf = np.zeros(word_bytes, np.uint8)
        vecs = np.zeros((rows, dim), np.float32)
        lib.glove_fill(handle, words_buf, vecs)
    finally:
        lib.glove_free(handle)
    words = words_buf.tobytes().decode("utf-8").split("\n")[:-1] if word_bytes else []
    stoi = {w: i for i, w in enumerate(words)}
    return stoi, vecs


def parse_behaviors_native(path: str, news_dict: Dict[str, int]) -> Dict[str, np.ndarray]:
    """Parse behaviors.tsv: history, clicks, non-clicks and candidates (with
    their labels, -1 where unlabeled) as ragged (flat, offsets) pairs. Keys
    are matched exactly; an unknown news id is dropped (never present in
    well-formed MIND data)."""
    lib = library()
    _check_readable(path)
    items = sorted(news_dict.items(), key=lambda kv: kv[1])
    keys = "\n".join(k for k, _ in items).encode("utf-8")
    handle = lib.parse_behaviors(path.encode("utf-8"), keys, len(keys), len(items))
    try:
        sizes = np.zeros(6, np.int64)
        lib.behaviors_sizes(handle, sizes)
        rows, n_hist, n_clk, n_nclk, n_cand, ok = (int(x) for x in sizes)
        if not ok:
            raise NativeParseError(f"native behaviors parse failed for {path}")
        out = {
            "history_flat": np.zeros(n_hist, np.int32),
            "history_offsets": np.zeros(rows + 1, np.int64),
            "clicks_flat": np.zeros(n_clk, np.int32),
            "clicks_offsets": np.zeros(rows + 1, np.int64),
            "nonclicks_flat": np.zeros(n_nclk, np.int32),
            "nonclicks_offsets": np.zeros(rows + 1, np.int64),
            "cand_flat": np.zeros(n_cand, np.int32),
            "label_flat": np.zeros(n_cand, np.int8),
            "cand_offsets": np.zeros(rows + 1, np.int64),
        }
        lib.behaviors_fill(handle, out["history_flat"], out["history_offsets"],
                           out["clicks_flat"], out["clicks_offsets"], out["nonclicks_flat"],
                           out["nonclicks_offsets"], out["cand_flat"], out["label_flat"],
                           out["cand_offsets"])
        return out
    finally:
        lib.behaviors_free(handle)
