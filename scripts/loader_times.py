#!/usr/bin/env python3
"""Host seconds of the port's native loader (`digat_tpu_torch/native`)
against its plain Python versions, on seeded files of real sizes.

    python3 scripts/loader_times.py [--glove840b] [--out loader_times.json]
    python3 scripts/loader_times.py --scale 0.01 --device cpu   # a quick try

Writes, in a temporary directory it removes:
  * a MIND-small-shaped corpus from the port's generator
    (`data.synthetic.generate`): 65,238 news in 12 categories (the
    generator's most), 156,965 train and 73,152 dev behaviors rows
    (histories of 0-44 news, 2-75 impressions a row: MIND-small's means
    are about 22 and 37). The generator's first 6,000 rows of each split
    are repeated, renumbered, up to the row counts: its rows cost
    milliseconds each to draw, and a row's parse cost is what is timed;
  * its SAG neighbour lists (M 5), mined by `data.sag.mine_similarity` on
    `--device`, for the BFS at hops 2, G 26;
  * a glove.6B.300d-shaped file, 400,000 x 300 (six decimals), and with
    `--glove840b` a glove.840B.300d-shaped one, 2,196,017 x 300 (five
    decimals): words w0, w1, ..., each line's numbers one of 4,096 rows
    drawn from N(0, 0.4) from the seed.

Then times each entry point as the port calls it, native (the median of
three calls) against plain (one call): `tokenize.load_glove_txt` against
`_load_glove_txt_py`, `corpus._parse_behaviors` against
`_parse_behaviors_py` for each split, and `sag.expand_graph` at its
default against `use_native=False`; and checks that each pair gives equal
results. The files are read warm (just written). Prints the card's name
and power limit (`nvidia-smi`) and the host's cores beside the times, and
one JSON line last; `--out` writes that JSON to a file too. Exits 1 if a
pair differs."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from digat_tpu_torch.data import corpus, sag, synthetic  # noqa: E402
from digat_tpu_torch.data import tokenize as tok  # noqa: E402
from digat_tpu_torch.native import bindings  # noqa: E402

MIND_SMALL = dict(news_num=65_238, train=156_965, dev=73_152)
BLOCK = 6_000  # the generator's rows of each split, repeated up to the counts
TOP_M, HOPS, G = 5, 2, 26
GLOVE = {"glove.6B.300d": (400_000, 300, 6), "glove.840B.300d": (2_196_017, 300, 5)}
POOL = 4_096


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def timed(fn, *args, repeat=1, **kw):
    """(the last call's result, each call's seconds)."""
    seconds = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds.append(time.perf_counter() - t0)
    return out, seconds


def write_corpus(root: str, scale: float, seed: int) -> dict:
    """The corpus's TSV files; -> rows by split."""
    block = max(1, int(BLOCK * min(scale, 1.0)))
    synthetic.generate(root, news_num=max(50, int(MIND_SMALL["news_num"] * scale)),
                       categories=12, train_behaviors=block, dev_behaviors=block,
                       test_behaviors=1, users=50_000, max_impressions=75, min_history=0,
                       max_history=45, seed=seed)
    rows = {}
    for split in ("train", "dev"):
        path = os.path.join(root, split, "behaviors.tsv")
        with open(path, encoding="utf-8") as f:
            lines = [line.rstrip("\n").split("\t", 1)[1] for line in f]
        rows[split] = max(1, int(MIND_SMALL[split] * scale))
        with open(path, "w", encoding="utf-8") as f:
            for i in range(rows[split]):
                f.write(f"{i + 1}\t{lines[i % len(lines)]}\n")
    return rows


def write_glove(path: str, rows: int, dim: int, decimals: int, seed: int) -> int:
    """A GloVe-format file; -> its bytes."""
    rng = np.random.default_rng(seed)
    pool = [" ".join(f"{x:.{decimals}f}" for x in rng.normal(0.0, 0.4, dim))
            for _ in range(POOL)]
    pick = rng.integers(0, POOL, rows)
    with open(path, "w", encoding="utf-8") as f:
        for s in range(0, rows, 100_000):
            f.write("".join(f"w{i} {pool[pick[i]]}\n" for i in range(s, min(rows, s + 100_000))))
    return os.path.getsize(path)


def same_behaviors(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--glove840b", action="store_true",
                    help="also the glove.840B.300d-shaped file (about 5.6 GB on disk)")
    ap.add_argument("--scale", type=float, default=1.0, help="cut every count (a quick try)")
    ap.add_argument("--device", default="cuda", help="where the SAG lists are mined")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    rec = {"card": card(), "host_cores": os.cpu_count(),
           "cores_usable": len(os.sched_getaffinity(0)), "scale": args.scale, "results": []}
    print(rec["card"], flush=True)
    print(f"host: {rec['host_cores']} cores ({rec['cores_usable']} usable)", flush=True)
    _, build_s = timed(bindings.build_library)
    bindings.library()
    rec["build_s"] = build_s[0]
    print(f"loader g++ build {build_s[0]:.2f}s", flush=True)

    def record(what, size, native_s, plain_s, equal):
        r = dict(what=what, size=size, native_s=native_s, native_median_s=float(
            np.median(native_s)), plain_s=plain_s, speedup=plain_s / float(np.median(native_s)),
            equal=bool(equal))
        rec["results"].append(r)
        print(f"{what} ({size}): native {r['native_median_s']:.4f}s (median of "
              f"{', '.join(f'{t:.4f}' for t in native_s)}) plain {plain_s:.4f}s, "
              f"{r['speedup']:.1f}x; equal {equal}", flush=True)

    with tempfile.TemporaryDirectory() as work:
        # ---- the MIND-small-shaped corpus: behaviors and the SAG's BFS ----
        root = os.path.join(work, "MIND-small")
        t0 = time.perf_counter()
        rows = write_corpus(root, args.scale, args.seed)
        roots = {s: os.path.join(root, s) for s in corpus.SPLITS}
        news_dict, cat_dict = {"<PAD>": 0}, {}
        for split in corpus.SPLITS:
            for news_id, cat, _, _, _ in corpus._read_news_tsv(os.path.join(roots[split],
                                                                            "news.tsv")):
                if news_id not in news_dict:
                    news_dict[news_id] = len(news_dict)
                    cat_dict.setdefault(cat, len(cat_dict))
        print(f"corpus written in {time.perf_counter() - t0:.2f}s: {len(news_dict) - 1} news, "
              f"{rows['train']} train and {rows['dev']} dev rows", flush=True)
        for split in ("train", "dev"):
            path = os.path.join(roots[split], "behaviors.tsv")
            got, native_s = timed(corpus._parse_behaviors, path, news_dict, repeat=3)
            want, plain_s = timed(corpus._parse_behaviors_py, path, news_dict)
            record(f"behaviors {split}", f"{rows[split]} rows, "
                   f"{os.path.getsize(path)} bytes, {len(got['cand_flat'])} impressions",
                   native_s, plain_s[0], same_behaviors(got, want))
        t0 = time.perf_counter()
        sims = sag.mine_similarity(corpus._rows_by_category(roots, cat_dict), news_dict, TOP_M,
                                   seed=args.seed, device=args.device)
        print(f"SAG lists mined on {args.device} in {time.perf_counter() - t0:.2f}s", flush=True)
        bfs = (sims, news_dict, TOP_M, HOPS, G)
        got, native_s = timed(sag.expand_graph, *bfs, repeat=3)
        want, plain_s = timed(sag.expand_graph, *bfs, use_native=False)
        record("SAG BFS", f"{len(news_dict)} news, M {TOP_M}, hops {HOPS}, G {G}", native_s,
               plain_s[0], all(a.dtype == b.dtype and np.array_equal(a, b)
                               for a, b in zip(got, want)))
        del got, want, sims
        shutil.rmtree(root)

        # ---- GloVe files ----
        for name, (n, dim, decimals) in GLOVE.items():
            if name == "glove.840B.300d" and not args.glove840b:
                continue
            n = max(1, int(n * args.scale))
            path = os.path.join(work, f"{name}.txt")
            free = shutil.disk_usage(work).free
            need = int(n * dim * (decimals + 4) * 1.2)
            if free < need:
                print(f"{name}: skipped, {free} bytes free of the {need} it needs", flush=True)
                rec["results"].append(dict(what=name, skipped=f"{free} bytes free"))
                continue
            t0 = time.perf_counter()
            size = write_glove(path, n, dim, decimals, args.seed)
            print(f"{name}: {n} x {dim}, {size} bytes written in "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
            got, native_s = timed(tok.load_glove_txt, path, dim, repeat=3)
            want, plain_s = timed(tok._load_glove_txt_py, path, dim)
            equal = got[0] == want[0] and np.array_equal(got[1], want[1])
            record(name, f"{n} x {dim}, {size} bytes", native_s, plain_s[0], equal)
            del got, want
            os.unlink(path)

    line = json.dumps(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if all(r.get("equal", True) for r in rec["results"]) else 1


if __name__ == "__main__":
    sys.exit(main())
