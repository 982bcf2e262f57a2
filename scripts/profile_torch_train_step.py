#!/usr/bin/env python3
"""Where one training step of the PyTorch/CUDA port spends its time on the card.

    python3 scripts/profile_torch_train_step.py [--family digat|nrms] [--steps 5]
                                                [--trace PATH]

Builds the setting of `chip_smoke.py`'s training phase for the family:
full-width MSA-DIGAT (B 64 with unique-title dedup) or NRMS-SA (B 64, no
dedup, M 10), random weights from a seed, the seeded 20,000-news corpus,
dropout 0.2. It runs three warm-up steps, then
traces `--steps` steps with `torch.profiler` (CPU and CUDA activities). It
prints the device time of each kernel by name (top 30, per step), the
device's busy time against the steps' wall time (the idle share), and
with `--trace` writes the Chrome trace there. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.data import batching, sampling  # noqa: E402
from digat_tpu_torch.models.model import CorpusTables, Model  # noqa: E402
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402
from digat_tpu_torch.train.optimizer import Adam  # noqa: E402
from digat_tpu_torch.train.train_step import step_seed, train_step  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("digat", "nrms"), default="digat")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--trace", default="", help="write the Chrome trace to this path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train_step: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    nrms = args.family == "nrms"
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18,
                 model_family=args.family)
    generator = torch.Generator().manual_seed(smoke.SEED)
    model = (NRMSModel if nrms else Model)(cfg, device=dev, generator=generator)
    tables = smoke.make_tables(torch, cfg, 20_000, dev, smoke.SEED)
    warmup = 3
    corpus = smoke.make_train_corpus(cfg, tables, (warmup + args.steps) * cfg.batch_size,
                                     2000, 32, smoke.SEED + 4)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(cfg.seed))
    split = corpus.splits["train"]
    cap = 0 if nrms else batching.estimate_dedup_capacity(
        split.history_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        corpus.news_node_id, cfg.batch_size, seed=cfg.seed)
    batches = [batching.to_device(b, dev) for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        cfg.batch_size, epoch_seed=1, news_node_id=None if nrms else corpus.news_node_id,
        dedup_titles=cap)]
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    if nrms:
        table = NRMSTables.from_arrays(smoke.nrms_tables_for(torch, cfg, tables, smoke.SEED + 6),
                                       dev)
    else:
        table = CorpusTables.from_arrays(corpus.tables(), dev)
    for k in range(warmup):
        train_step(model, opt, table, batches[k], step_seed(cfg.seed, 1, k), cfg.lr)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for k in range(warmup, warmup + args.steps):
            train_step(model, opt, table, batches[k], step_seed(cfg.seed, 1, k), cfg.lr)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / args.steps
    print(f"{args.family}: dedup capacity {cap}; {args.steps} traced steps at B "
          f"{cfg.batch_size}")
    print(f"per step: wall {wall_ms:.3f} ms (traced), device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    print(f"{'device ms/step':>15} {'calls/step':>10}  kernel")
    for e in events[:30]:
        print(f"{e.device_time_total / 1e3 / args.steps:15.3f} {e.count / args.steps:10.1f}  "
              f"{e.key[:110]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
