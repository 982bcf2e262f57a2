#!/usr/bin/env python3
"""How far a training step's gradients on the card are from the CPU's, and
each from float64, for the DIGAT variants: the measure behind
`chip_smoke.py`'s training gate (phases 9 and 18).

    python3 scripts/variant_gradient_precision.py [--variants V ...] [--batches K ...]

For each variant (default: DIGAT, the five ablations and CNN-DIGAT at
cnn_kernel_num 400, naive, window 3) and each batch K
(default 0, 1, 2) of the B-8 dedup batches that phase 18 trains on (the
same corpus, weights and dropout seed), one training step from fresh
weights on the card (fp32, the kernels), on the CPU (fp32, the plain
path) and on the CPU in float64; then, per pair, every parameter's
max |a - b| / max |b| (phase 9's ratio, gate 1e-3) and the worst tensor.
The worst tensors of the Eq. (8) projections (ffn1, ffn2, ffn3 of one
layer) moving together mark a ReLU of Eq. (8) whose pre-activation lies
within rounding of 0 and falls on the other side in one of the two
(`interactive_gat_scores`: relu(k1 + k2 + k3)). Needs a CUDA device;
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.data import batching, sampling  # noqa: E402
from digat_tpu_torch.models.model import CorpusTables, Model  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402
from digat_tpu_torch.train.optimizer import Adam  # noqa: E402
from digat_tpu_torch.train.train_step import step_seed, train_step  # noqa: E402

VARIANTS = ("DIGAT", "wo_SA", "Seq_SA", "wo_interaction", "news_graph_wo_inter",
            "user_graph_wo_inter", "CNN-DIGAT")
CNN = dict(news_encoder="CNN", cnn_kernel_num=400, cnn_method="naive", cnn_window_size=3)


def step_gradients(cfg, corpus, batch, device, dtype):
    model = Model(cfg, device=device, generator=torch.Generator().manual_seed(smoke.SEED + 7))
    model = model.to(dtype)
    tables = CorpusTables.from_arrays(corpus.tables(), device)
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    loss = float(train_step(model, opt, tables, batching.to_device(batch, device),
                            step_seed(smoke.SEED, 1, 0), cfg.lr))
    return loss, {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def worst(a, b):
    rows = sorted(((float((a[n] - g).abs().max()) / max(float(g.abs().max()), 1e-12), n)
                   for n, g in b.items()), reverse=True)
    return rows[:3]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--batches", nargs="+", type=int, default=[0, 1, 2])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("variant_gradient_precision: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    base = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    tables = smoke.make_tables(torch, base, 20_000, dev, smoke.SEED)
    for variant in args.variants:
        cfg = replace(base, **(CNN if variant == "CNN-DIGAT" else dict(graph_encoder=variant)))
        corpus = smoke.make_train_corpus(cfg, tables, (smoke.VARIANT_STEPS + 2) * cfg.batch_size,
                                         2000, 32, smoke.SEED + 14)
        B = 8
        neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                        cfg.negative_sample_num, np.random.default_rng(smoke.SEED))
        cap = B * ((1 + cfg.negative_sample_num) * cfg.news_graph_size + cfg.max_history_num)
        split = corpus.splits["train"]
        batches = list(batching.train_batches(
            split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
            B, epoch_seed=smoke.SEED + 1, news_node_id=corpus.news_node_id, dedup_titles=cap))
        for k in args.batches:
            card = step_gradients(cfg, corpus, batches[k], dev, torch.float32)
            cpu = step_gradients(cfg, corpus, batches[k], "cpu", torch.float32)
            exact = step_gradients(cfg, corpus, batches[k], "cpu", torch.float64)
            for name, a, b in (("card vs cpu", card, cpu), ("card vs fp64", card, exact),
                               ("cpu vs fp64", cpu, exact)):
                rows = worst(a[1], b[1])
                print(f"{variant} batch {k} {name}: loss {a[0]:.7f} vs {b[0]:.7f}; worst "
                      + ", ".join(f"{n} {r:.3e}" for r, n in rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
