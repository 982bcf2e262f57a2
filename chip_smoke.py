#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port (digat_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `digat_tpu_torch/csrc` (one nvcc call),
holds each kernel against its plain PyTorch version on the card at the
serving path's shapes, then serves the production MSA-DIGAT model (full
width: 300-d words, L 32, 16 x 25 heads, depth 3, Gn 26, Gu 68; random
weights from a seed) through the two-stage cached scorer on a seeded
20,000-news corpus, checks that stage 1 ran kernel A and stage 2 kernel B,
and compares a smaller corpus scored on the card with the same model's
plain path on the CPU.

Prints progress lines, the card's name and power limit, a `kernels` JSON
line, and as its last line `{"ok": true, "device": {...}}`. Exits nonzero,
without that line, if CUDA is missing, the package is missing, any phase
fails, or the run passes the watchdog. Imports nothing of JAX or of the
JAX package; writes nothing but the kernel build directory.
"""

from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

WATCHDOG_S = 600
SEED = 0

# Tolerances on the card. Kernel vs plain: fp32 sums in another order, so
# max |kernel - plain| <= 1e-4 * max(1, max |plain|). Slice, card vs CPU:
# three GAT layers and two contexts compound the same differences, so
# max |card - cpu| <= 1e-4 * max(1, max |cpu score|), and the per-impression
# rank order must agree except between scores closer than that bound.
KERNEL_RTOL = 1e-4
SLICE_RTOL = 1e-4

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on the CUDA
# cores and HBM3 bandwidth. A card below 700 W runs slower under load.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def say(msg: str) -> None:
    print(msg, flush=True)


def _watchdog(signum, frame):
    print(f"chip_smoke: watchdog: run exceeded {WATCHDOG_S} s", file=sys.stderr, flush=True)
    os._exit(3)


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def msa_work(N, L, Din, D, A):
    flops = (2 * N * L * Din * 3 * D  # Q|K|V projections
             + 4 * N * L * L * D  # QK^T and PV over all heads
             + 2 * N * L * D * A + 2 * N * L * A  # pool MLP and its v-product
             + 2 * N * L * D)  # pooled sum
    nbytes = 4 * N * L * Din + N * L + 4 * (Din * 3 * D + 3 * D + D * A + 2 * A) + 4 * N * D
    return flops, nbytes


def gat_work(B, G, D):
    flops = (2 * B * G * D * 3 * D + 2 * B * D * D  # projections, k3
             + 4 * B * G * G * D  # Eq. 8: add, add, relu, multiply-add per (i, j, d)
             + 2 * B * G * G * D)  # alpha h
    nbytes = 4 * B * G * D + B * G * G + 4 * B * D + 4 * (4 * D * D + 3 * D) + 4 * B * G * D
    return flops, nbytes


def time_ms(torch, fn, warmup: int = 3, iters: int = 10) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def make_tables(torch, cfg, news_num: int, device, seed: int):
    """Seeded corpus tables made on `device` (as bench.py makes them for the
    JAX package): title lengths 1..L as valid prefixes, news 0 the all-pad
    padding news, SAG node 0 the news itself, random graphs with
    self-loops, slot 0 of the graph mask zeroed."""
    from digat_tpu_torch.models.model import CorpusTables

    g = torch.Generator(device=device).manual_seed(seed)
    L, Gn, V = cfg.max_title_length, cfg.news_graph_size, cfg.vocabulary_size
    lengths = torch.randint(1, L + 1, (news_num, 1), generator=g, device=device)
    mask = torch.arange(L, device=device)[None, :] < lengths
    mask[0] = False
    node_id = torch.randint(0, news_num, (news_num, Gn), generator=g, device=device)
    node_id[:, 0] = torch.arange(news_num, device=device)
    graph = torch.rand((news_num, Gn, Gn), generator=g, device=device) < 0.25
    graph |= torch.eye(Gn, dtype=torch.bool, device=device)
    gmask = torch.rand((news_num, Gn), generator=g, device=device) < 0.9
    gmask[:, 0] = False
    return CorpusTables(
        news_title_text=torch.randint(0, V, (news_num, L), generator=g, device=device),
        news_title_mask=mask, news_node_id=node_id, news_graph=graph, news_graph_mask=gmask,
    )


def make_impressions(cfg, news_num: int, n_imp: int, per_imp: int, seed: int):
    """Seeded impressions on the host: H-slot histories with 1..H valid
    items (pads: news 0, category C), per_imp candidates, 0/1 labels with
    one positive and one negative per impression at least."""
    rng = np.random.default_rng(seed)
    H, C = cfg.max_history_num, cfg.category_num
    hist = rng.integers(1, news_num, (n_imp, H))
    cat = rng.integers(0, C, (n_imp, H))
    for r, n in enumerate(rng.integers(1, H + 1, n_imp)):
        hist[r, n:] = 0
        cat[r, n:] = C
    imp_index = np.repeat(np.arange(n_imp), per_imp)
    cand = rng.integers(1, news_num, n_imp * per_imp)
    labels = (rng.random(n_imp * per_imp) < 0.2).astype(np.float32)
    labels[0::per_imp], labels[1::per_imp] = 1.0, 0.0
    return hist, cat, imp_index, cand, labels


def check_kernel(torch, name, kernel, plain, args, flops, nbytes):
    """Kernel vs plain on the same inputs, timed; returns the kernels-line
    entry without launches (filled from the main-path run)."""
    out = kernel(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(torch, lambda: kernel(*args))
    plain_ms = time_ms(torch, lambda: plain(*args))
    bound_ms, bound_by = bound(flops, nbytes)
    ok = finite and err <= KERNEL_RTOL * scale
    say(f"  {name}: max_abs_err {err:.3e} (limit {KERNEL_RTOL * scale:.3e}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound_ms {bound_ms:.4f} ({bound_by}) ok {ok}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, ok=ok)


def main() -> int:
    signal.signal(signal.SIGALRM, _watchdog)
    signal.alarm(WATCHDOG_S)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to check",
              file=sys.stderr)
        return 2
    try:
        from digat_tpu_torch.config import Config
        from digat_tpu_torch.eval import metrics as M
        from digat_tpu_torch.eval.scorer import CachedScorer
        from digat_tpu_torch.models.model import Model
        from digat_tpu_torch.ops import build
        from digat_tpu_torch.ops.gat_layer import (
            gat_layer_attend,
            gat_layer_project,
            interactive_gat_layer_fused,
            interactive_gat_layer_plain,
        )
        from digat_tpu_torch.ops.msa_encoder import msa_encoder_pooled, msa_encoder_pooled_plain
        from digat_tpu_torch.runtime import exact_fp32
    except ImportError as e:
        print(f"chip_smoke: cannot import the port package digat_tpu_torch: {e}", file=sys.stderr)
        return 2
    exact_fp32()
    failures = []
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    t0 = time.perf_counter()
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60,
        )
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
            else f"nvidia-smi failed: {smi.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        card = f"nvidia-smi failed: {e}"
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(f"[1 device] {time.perf_counter() - t0:.2f}s torch {torch.__version__} "
        f"cuda {torch.version.cuda} device_count {count}")
    say(card)

    # ---- 2. build ----
    t0 = time.perf_counter()
    path, nvcc_s = build.build_library()
    build.load_library()
    say(f"[2 build] {time.perf_counter() - t0:.2f}s nvcc {nvcc_s:.2f}s "
        f"({'compiled' if nvcc_s else 'reused'} {path.name})")

    # ---- model and corpus at full width ----
    t0 = time.perf_counter()
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    news_num = 20_000
    tables = make_tables(torch, cfg, news_num, dev, SEED)
    hist, cat, imp_index, cand, labels = make_impressions(cfg, news_num, 512, 8, SEED + 1)
    torch.cuda.synchronize()
    L, Din, D, A = cfg.max_title_length, cfg.word_embedding_dim, cfg.news_embedding_dim, \
        cfg.attention_dim
    bs = cfg.effective_eval_batch_size()
    say(f"[setup] {time.perf_counter() - t0:.2f}s model {cfg.model_name} D {D} depth "
        f"{cfg.graph_depth} Gn {cfg.news_graph_size} Gu {cfg.user_graph_size} news {news_num} "
        f"items {len(cand)} eval batch {bs}")

    entries = {}
    # ---- 3. kernel A ----
    t0 = time.perf_counter()
    try:
        ne = model.news_encoder
        mha, pool = ne.multiheadSelfattention, ne.attention
        x = ne.word_embedding.weight[tables.news_title_text[:bs]].contiguous()
        mask = tables.news_title_mask[:bs].contiguous()
        args_a = (x, mask, mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(),
                  mha.W_V.weight.t(), mha.W_V.bias, pool.affine1.weight.t(), pool.affine1.bias,
                  pool.affine2.weight[0], cfg.MSA_head_num)
        entries["msa_encoder_pooled"] = check_kernel(
            torch, f"msa_encoder_pooled [{bs},{L},{Din}]->[{bs},{D}]", msa_encoder_pooled,
            msa_encoder_pooled_plain, args_a, *msa_work(bs, L, Din, D, A))
    except Exception:
        traceback.print_exc()
        entries["msa_encoder_pooled"] = dict(ok=False)
    say(f"[3 kernel A] {time.perf_counter() - t0:.2f}s")

    # ---- 4. kernel B at G = 26 and 68 ----
    t0 = time.perf_counter()
    ge = model.graph_encoder
    by_shape = {}
    for G, prefix in ((cfg.news_graph_size, "news_graph_attention"),
                      (cfg.user_graph_size, "user_graph_attention")):
        try:
            g = torch.Generator(device=dev).manual_seed(SEED + G)
            xb = torch.randn((bs, G, D), generator=g, device=dev) * 0.5
            adj = (torch.rand((bs, G, G), generator=g, device=dev) < 0.25) \
                | torch.eye(G, dtype=torch.bool, device=dev)
            adj[0, 1] = False  # a row with no neighbour
            q = torch.randn((bs, D), generator=g, device=dev) * 0.5
            W, W3 = getattr(ge, f"{prefix}_W")[0], getattr(ge, f"{prefix}_ffn3")[0]
            args_b = (xb, adj, q, W.weight.t(), W.bias,
                      getattr(ge, f"{prefix}_ffn1")[0].weight.t(),
                      getattr(ge, f"{prefix}_ffn2")[0].weight.t(), W3.weight.t(), W3.bias,
                      getattr(ge, f"{prefix}_a")[0].weight[0])
            entry = check_kernel(
                torch, f"interactive_gat_layer_fused B={bs} G={G} D={D}",
                interactive_gat_layer_fused, interactive_gat_layer_plain, args_b,
                *gat_work(bs, G, D))
            # the wrapper's two steps, each timed alone
            wr = [w.weight for w in (W, getattr(ge, f"{prefix}_ffn1")[0],
                                     getattr(ge, f"{prefix}_ffn2")[0], W3)]
            project = lambda: gat_layer_project(xb, q, wr[0], W.bias, wr[1], wr[2], wr[3],
                                                W3.bias)
            y, k3 = project()
            entry["project_ms"] = time_ms(torch, project)
            entry["attend_ms"] = time_ms(torch, lambda: gat_layer_attend(xb, adj, y, k3,
                                                                         args_b[9], 0.2))
            project_flops = 2 * bs * G * D * 3 * D + 2 * bs * D * D
            say(f"    steps: project {entry['project_ms']:.4f} ms "
                f"({project_flops / entry['project_ms'] / 1e9:.1f} TFLOP/s), "
                f"attend {entry['attend_ms']:.4f} ms")
            by_shape[f"G{G}"] = entry
        except Exception:
            traceback.print_exc()
            by_shape[f"G{G}"] = dict(ok=False)
    big = by_shape.get(f"G{cfg.user_graph_size}", {})
    entries["interactive_gat_layer_fused"] = dict(
        big, ok=all(v.get("ok") for v in by_shape.values()),
        max_abs_err=max((v.get("max_abs_err", math.inf) for v in by_shape.values())),
        by_shape=by_shape)
    say(f"[4 kernel B] {time.perf_counter() - t0:.2f}s")
    for name, e in entries.items():
        if not e.get("ok"):
            failures.append(f"kernel {name}")

    # ---- 5. the slice: main path ----
    t0 = time.perf_counter()
    launches = {}
    try:
        scorer = CachedScorer(model, bs)
        msa_encoder_pooled.launches = 0
        interactive_gat_layer_fused.launches = 0
        scores = scorer.score_items(tables, hist, cat, imp_index, cand)
        launches = {"msa_encoder_pooled": msa_encoder_pooled.launches,
                    "interactive_gat_layer_fused": interactive_gat_layer_fused.launches}
        tm = dict(scorer.timings)
        want_a = -(-news_num // bs)
        want_b = 2 * cfg.graph_depth * tm["stage2_batches"]
        auc, mrr, n5, n10 = M.score_impressions_flat(imp_index, labels, scores)
        scorer.score_items(tables, hist, cat, imp_index, cand)  # warm pass, timing only
        warm = scorer.timings
        say(f"  stage 1: {tm['stage1_s']:.3f}s ({news_num} news, warm {warm['stage1_s']:.3f}s); "
            f"stage 2: {tm['items'] / tm['stage2_s']:.1f} items/s ({tm['items']} items, "
            f"{tm['stage2_batches']} batches, warm {warm['items'] / warm['stage2_s']:.1f} items/s)")
        say(f"  launches: A {launches['msa_encoder_pooled']} (want {want_a}), "
            f"B {launches['interactive_gat_layer_fused']} (want {want_b})")
        say(f"  metrics on random weights: auc {auc:.4f} mrr {mrr:.4f} ndcg5 {n5:.4f} "
            f"ndcg10 {n10:.4f}")
        if not (scores.shape == (len(cand),) and np.isfinite(scores).all()):
            failures.append("slice scores not finite or of the wrong shape")
        if launches["msa_encoder_pooled"] != want_a:
            failures.append("stage 1 did not run kernel A once per chunk")
        if launches["interactive_gat_layer_fused"] != want_b:
            failures.append("stage 2 did not run kernel B 2*depth times per batch")
    except Exception:
        traceback.print_exc()
        failures.append("slice")
    say(f"[5 slice] {time.perf_counter() - t0:.2f}s")

    # ---- 6. slice parity: card vs the plain path on the CPU ----
    t0 = time.perf_counter()
    try:
        small_news, small_bs = 2048, 256
        cpu_model = Model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        small = make_tables(torch, cfg, small_news, dev, SEED + 2)
        small_cpu = type(small)(*(t.cpu() for t in small))
        imps = make_impressions(cfg, small_news, 32, 8, SEED + 3)
        out = {}
        with tempfile.TemporaryDirectory() as tmp:
            for tag, m, t in (("gpu", model, small), ("cpu", cpu_model, small_cpu)):
                s = CachedScorer(m, small_bs).score_items(t, *imps[:4])
                rank_file = os.path.join(tmp, f"{tag}.txt")
                M.write_rank_file(rank_file, M.group_by_impression(imps[2], s))
                metrics = M.score_impressions_flat(imps[2], imps[4], s)
                with open(rank_file, encoding="utf-8") as f:
                    out[tag] = (s, metrics, f.read())
        (s_gpu, m_gpu, r_gpu), (s_cpu, m_cpu, r_cpu) = out["gpu"], out["cpu"]
        err = float(np.abs(s_gpu - s_cpu).max())
        limit = SLICE_RTOL * max(1.0, float(np.abs(s_cpu).max()))
        flips = 0
        for sg, sc in zip(M.group_by_impression(imps[2], s_gpu),
                          M.group_by_impression(imps[2], s_cpu)):
            og, oc = np.argsort(-sg, kind="stable"), np.argsort(-sc, kind="stable")
            for a, b in zip(og, oc):
                if a != b and abs(float(sc[a]) - float(sc[b])) > 2 * limit:
                    flips += 1
        say(f"  {small_news} news, {len(imps[3])} items: max |gpu - cpu| {err:.3e} "
            f"(limit {limit:.3e}); rank flips beyond ties {flips}; rank files identical "
            f"{r_gpu == r_cpu}; metrics gpu {np.round(m_gpu, 6).tolist()} "
            f"cpu {np.round(m_cpu, 6).tolist()}")
        if not (err <= limit and flips == 0 and np.isfinite(s_gpu).all()):
            failures.append("slice parity card vs cpu")
    except Exception:
        traceback.print_exc()
        failures.append("slice parity")
    say(f"[6 parity] {time.perf_counter() - t0:.2f}s")

    # ---- 7. kernels line ----
    source = {"msa_encoder_pooled": ("digat_tpu_torch/csrc/msa_encoder.cu",
                                     "digat_tpu/ops/pallas/msa_encoder.py:533"),
              "interactive_gat_layer_fused": ("digat_tpu_torch/csrc/gat_layer.cu",
                                              "digat_tpu/ops/pallas/gat_layer.py:135")}
    kernels = []
    for name, (src, replaces) in source.items():
        e = entries.get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": e.get("max_abs_err"),
            "ms": e.get("ms"), "plain_ms": e.get("plain_ms"), "bound_ms": e.get("bound_ms"),
            "bound_by": e.get("bound_by"), "library_ms": None, "ok": bool(e.get("ok")),
            **({"by_shape": e["by_shape"]} if "by_shape" in e else {}),
        })
    say(json.dumps({"kernels": kernels}))
    say(f"[total] {time.perf_counter() - t_start:.2f}s")
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
