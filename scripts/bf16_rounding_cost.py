#!/usr/bin/env python3
"""What the port's op-by-op bf16 rounding costs a training step on the card.

    python3 scripts/bf16_rounding_cost.py [--steps N] [--rounds R]

Where the JAX package leaves a bf16 op to XLA, the port rounds as XLA's CPU
backend does (tests/test_torch_bf16_rounding.py): `x @ w + b` rounds the
product and then the sum (`layers.linear`: two launches), `sigmoid` is
1 / (1 + exp(-x)) op by op (four), `leaky_relu` a where over a product
(two), the CNN bank's bias its own add. This script trains NRMS-SA and
CNN-DIGAT (production widths and depth, a GloVe-scale word table for the
CNN, `chip_smoke.py`'s corpora) at compute_dtype bfloat16, B 64, dropout
0.2, and times each step with those functions as they are ("xla") and
with each replaced by its one-rounding PyTorch call ("fused": F.linear
with its bias, torch.sigmoid, F.leaky_relu, F.conv1d with its bias): R + 1
rounds over the same N batches (round 0 a warm-up), each batch stepped by
both arms back to back, the arm that goes first alternating. It prints each
arm's median step, the median of the paired differences, and, from one
step of each arm under torch.profiler, its CUDA kernels and their device
ms. The fused arm is not the port: it only prices the extra launches.
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch import layers as L  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.data import batching, sampling  # noqa: E402
from digat_tpu_torch.models import graph_encoders, nrms  # noqa: E402
from digat_tpu_torch.models.model import CorpusTables, Model  # noqa: E402
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402
from digat_tpu_torch.train.optimizer import Adam  # noqa: E402
from digat_tpu_torch.train.train_step import step_seed, train_step  # noqa: E402


def _bank_fused(self, x):
    lead, (n, c) = x.shape[:-2], x.shape[-2:]
    xt = x.reshape(-1, n, c).transpose(1, 2)
    outs = []
    for name, w in zip(self.names, self.widths):
        conv = getattr(self, name)
        pad = (w - 1) // 2
        outs.append(F.conv1d(F.pad(xt, (pad, pad if w % 2 else pad + 1)), conv.weight,
                             conv.bias))
    h = torch.relu(torch.cat(outs, dim=1)).transpose(1, 2)
    return h.reshape(*lead, n, h.shape[-1])


FUSED = {
    "linear": lambda x, lin: F.linear(*L.promoted(x, lin.weight, lin.bias)),
    "sigmoid": torch.sigmoid,
    "leaky_relu": lambda t, negative_slope=0.2: F.leaky_relu(t, negative_slope),
}


class Arm:
    """The layers' functions as the port has them, or their one-rounding
    replacements, in every module that imported them."""

    def __init__(self, fused: bool):
        self.fused, self.saved = fused, []

    def __enter__(self):
        if not self.fused:
            return
        for mod in (L, graph_encoders, nrms):
            for name, fn in FUSED.items():
                if hasattr(mod, name):
                    self.saved.append((mod, name, getattr(mod, name)))
                    setattr(mod, name, fn)
        self.saved.append((L.ConvBank, "forward", L.ConvBank.forward))
        L.ConvBank.forward = _bank_fused

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)
        self.saved = []


def setup(name, base, tables, dev, steps):
    """(model, optimizer, device tables, B-64 batches) for one model."""
    cfg = dict(smoke.bf16_model_configs(base))[name]
    is_nrms = cfg.model_family == "nrms"
    if not is_nrms:
        cfg = replace(cfg, graph_depth=base.graph_depth)
    corpus = smoke.make_train_corpus(cfg, tables, (steps + 2) * cfg.batch_size, 2000, 32,
                                     smoke.SEED + 83)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(smoke.SEED))
    split = corpus.splits["train"]
    gen = torch.Generator().manual_seed(smoke.SEED + 85)
    if is_nrms:
        model = NRMSModel(cfg, device=dev, generator=gen)
        t = NRMSTables.from_arrays(smoke.nrms_tables_for(torch, cfg, tables, smoke.SEED + 84),
                                   dev)
        cap = 0
    else:
        model = Model(cfg, device=dev, generator=gen,
                      word_embedding=smoke.glove_table(cfg, smoke.SEED + 87))
        t = CorpusTables.from_arrays(tables, dev)
        cap = batching.estimate_dedup_capacity(split.history_idx, corpus.train_behavior_row,
                                               corpus.train_pos, neg, corpus.news_node_id,
                                               cfg.batch_size, seed=cfg.seed)
    batches = [batching.to_device(b, dev) for b in batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
        cfg.batch_size, epoch_seed=smoke.SEED, news_node_id=None if is_nrms else
        corpus.news_node_id, dedup_titles=cap)
        if is_nrms or isinstance(b, batching.DedupTrainBatch)][:steps]
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    return cfg, model, opt, t, batches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_rounding_cost: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    base = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    tables = smoke.make_tables(torch, base, 20_000, dev, smoke.SEED)
    for name in ("NRMS-SA", "CNN-DIGAT"):
        cfg, model, opt, t, batches = setup(name, base, tables, dev, args.steps)

        def step(arm, r, k, b):
            with Arm(arm == "fused"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train_step(model, opt, t, b, step_seed(smoke.SEED, r, k), cfg.lr)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

        by_arm, diffs = {"xla": [], "fused": []}, []
        for r in range(args.rounds + 1):
            for k, b in enumerate(batches):
                order = ("xla", "fused") if (r + k) % 2 == 0 else ("fused", "xla")
                ms = {arm: step(arm, r, k, b) for arm in order}
                if r:
                    for arm in order:
                        by_arm[arm].append(ms[arm])
                    diffs.append(ms["xla"] - ms["fused"])
        med = {a: float(np.median(v)) for a, v in by_arm.items()}
        print(f"{name} bf16 B {cfg.batch_size}, {len(diffs)} steps an arm: median step xla "
              f"{med['xla']:.4f} ms, fused {med['fused']:.4f} ms; median paired difference "
              f"{float(np.median(diffs)):.4f} ms (quartiles {np.percentile(diffs, 25):.4f}, "
              f"{np.percentile(diffs, 75):.4f})", flush=True)
        for arm in ("xla", "fused"):
            try:
                from torch.profiler import ProfilerActivity, profile

                with Arm(arm == "fused"), profile(activities=[ProfilerActivity.CUDA]) as prof:
                    train_step(model, opt, t, batches[0], step_seed(smoke.SEED, 9, 0), cfg.lr)
                    torch.cuda.synchronize()
                rows = prof.key_averages()
                dev_us = sum(getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
                             for e in rows)
                print(f"{name} {arm}: {sum(e.count for e in rows)} CUDA kernels and copies in "
                      f"one step, device time {dev_us / 1e3:.4f} ms", flush=True)
            except Exception as e:  # the profiler is a diagnostic here, not a gate
                print(f"{name} {arm}: profiler gave nothing ({type(e).__name__}: {e})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
