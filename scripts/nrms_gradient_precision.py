#!/usr/bin/env python3
"""How far the fp32 step-1 gradients of NRMS-SA lie from fp64, on the CPU.

    python3 scripts/nrms_gradient_precision.py [--worst 4]

Builds the setting of `chip_smoke.py`'s NRMS-SA training-parity phase
(full width: 300-d words, L 32, 20 x 20 heads, history 50, M 10; the
seeded 20,000-news corpus; one B-8 batch; dropout 0.2 under one seed),
takes one step's gradients in fp32 and in fp64 from the same weights on
the CPU plain path, and prints the tensors whose fp32 gradient is
farthest from the fp64 one, as max |fp32 - fp64| / max |fp64| of that
tensor: once with the attention pool's written backward
(`layers.SoftmaxPool`, what the port runs) and once with autograd's
(softmax and weighted sum as plain PyTorch ops). A CPU measurement of
arithmetic, not of any device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch import layers  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.data import batching, sampling  # noqa: E402
from digat_tpu_torch.models.nrms import NRMSModel, NRMSTables  # noqa: E402


class AutogradPool:
    """The pool's softmax and weighted sum as plain ops (autograd's backward)."""

    @staticmethod
    def apply(scores, feature):
        return torch.einsum("...l,...ld->...d", torch.softmax(scores, dim=-1), feature)


def step_gradients(cfg, tables, batch, dtype):
    model = NRMSModel(cfg, device="cpu", generator=torch.Generator().manual_seed(smoke.SEED + 7))
    model = model.to(dtype)
    model.loss(NRMSTables.from_arrays(tables, "cpu"), batch, 1234).backward()
    return {n: p.grad.double() for n, p in model.named_parameters()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worst", type=int, default=4)
    args = ap.parse_args()
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18,
                 model_family="nrms")
    tables = smoke.make_tables(torch, cfg, 20_000, torch.device("cpu"), smoke.SEED)
    ntables = smoke.nrms_tables_for(torch, cfg, tables, smoke.SEED + 6)
    corpus = smoke.make_train_corpus(cfg, tables, 12 * cfg.batch_size, 2000, 32, smoke.SEED + 5)
    neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                    cfg.negative_sample_num, np.random.default_rng(smoke.SEED))
    split = corpus.splits["train"]
    batch = batching.to_device(next(batching.train_batches(
        split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg, 8,
        epoch_seed=smoke.SEED + 1)), "cpu")
    written = layers.SoftmaxPool
    for name, pool in (("written backward (layers.SoftmaxPool)", written),
                       ("autograd's backward", AutogradPool)):
        layers.SoftmaxPool = pool  # attn_pool looks the class up at call time
        try:
            g32, g64 = (step_gradients(cfg, ntables, batch, dt)
                        for dt in (torch.float32, torch.float64))
        finally:
            layers.SoftmaxPool = written
        rows = sorted(((float((g32[n] - g).abs().max() / g.abs().max()), float(g.abs().max()), n)
                       for n, g in g64.items()), reverse=True)
        print(f"pool with {name}: max |fp32 - fp64| / max |fp64| per tensor, worst "
              f"{args.worst} of {len(rows)}")
        for rel, top, n in rows[:args.worst]:
            print(f"  {rel:.3e}  (max |fp64| {top:.3e})  {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
