#!/usr/bin/env python3
"""How far a training step's gradients on the card are from the CPU's, and
each from float64, for the DIGAT variants: the measure behind
`chip_smoke.py`'s training gates (phases 9, 18 and 21).

    python3 scripts/variant_gradient_precision.py [--variants V ...] [--batches K ...]
        [--corpus_seed S] [--no_fp64] [--bf16]

For each variant (default: DIGAT, the five ablations and CNN-DIGAT at
cnn_kernel_num 400, naive, window 3) and each batch K (default 0, 1, 2) of
the B-8 dedup batches that phase 18 trains on (its graph depth 2, the same weights and
dropout seed; the corpus phase 18's unless `--corpus_seed` names another),
one training step from fresh weights on the card (fp32, the kernels), on
the CPU (fp32, the plain path) twice, on its own and taking the card's
side at each kink as the smoke's gate does (`chip_smoke.KinkReplay`: the
Eq. (8) sums of C's backward and the model's ReLUs and leaky ReLUs, the
kinks counted by kind), and on the CPU in float64 (unless `--no_fp64`);
then, per pair, every parameter's max |a - b| / max |b| (phase 9's ratio,
gate 1e-3) and the worst tensors. The worst tensors of the Eq. (8)
projections (ffn1, ffn2, ffn3 of one layer) moving together mark a ReLU of
Eq. (8) whose pre-activation lies within rounding of 0 and falls on the
other side in one of the two (`interactive_gat_scores`: relu(k1 + k2 +
k3)).

`--bf16`: phase 21's two DIGAT models at compute_dtype bfloat16 in place
of the variants (CNN-DIGAT with its GloVe-scale table, MSA at L 160; the
corpus phase 21's unless `--corpus_seed`), each pair by phase 21's rule
(`chip_smoke.grad_rel`: beyond one bf16 ulp of the tensor's max), with the
losses' relative error and the control (k3 left out of C's backward on
the card) against the replayed CPU. Needs a CUDA device; imports nothing
of JAX.
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


def step_gradients(cfg, corpus, batch, device, dtype, table=None):
    model = Model(cfg, device=device, generator=torch.Generator().manual_seed(smoke.SEED + 7),
                  word_embedding=table)
    model = model.to(dtype)
    tables = CorpusTables.from_arrays(corpus.tables(), device)
    opt = Adam(model.named_parameters(), cfg.weight_decay, cfg.gradient_clip_norm)
    loss = float(train_step(model, opt, tables, batching.to_device(batch, device),
                            step_seed(smoke.SEED, 1, 0), cfg.lr))
    return loss, {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}


def worst(a, b, bf16=False):
    """The three largest `chip_smoke.grad_rel` and the largest relative
    error in norm."""
    rows = sorted(((smoke.grad_rel(torch, n, a[n].float(), g.float(), bf16, bf16), n)
                   for n, g in b.items()), reverse=True)
    norm = max(float((a[n] - g).norm()) / max(float(g.norm()), 1e-30) for n, g in b.items())
    return rows[:3], norm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--batches", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--corpus_seed", type=int)
    ap.add_argument("--no_fp64", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("variant_gradient_precision: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    base = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    tables = smoke.make_tables(torch, base, 20_000, dev, smoke.SEED)
    if args.bf16:
        runs = [(name, cfg, smoke.BF16_STEPS, smoke.SEED + 83)
                for name, cfg in smoke.bf16_model_configs(base) if cfg.model_family != "nrms"]
    else:
        runs = [(v, replace(base, graph_depth=smoke.CUT_DEPTH,
                            **(CNN if v == "CNN-DIGAT" else dict(graph_encoder=v))),
                 smoke.VARIANT_STEPS, smoke.SEED + 14) for v in args.variants]
    for variant, cfg, steps, seed in runs:
        seed = seed if args.corpus_seed is None else args.corpus_seed
        t = tables if cfg.max_title_length == base.max_title_length else \
            smoke.make_tables(torch, cfg, 4096, dev, smoke.SEED + 86)
        table = smoke.glove_table(cfg, smoke.SEED + 87) if args.bf16 and \
            cfg.news_encoder == "CNN" else None
        corpus = smoke.make_train_corpus(cfg, t, (steps + 2) * cfg.batch_size, 2000, 32, seed)
        B = 8
        neg = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                        cfg.negative_sample_num, np.random.default_rng(smoke.SEED))
        cap = B * ((1 + cfg.negative_sample_num) * cfg.news_graph_size + cfg.max_history_num)
        split = corpus.splits["train"]
        batches = list(batching.train_batches(
            split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos, neg,
            B, epoch_seed=smoke.SEED + 1, news_node_id=corpus.news_node_id, dedup_titles=cap))
        for k in args.batches:
            step = lambda device: step_gradients(cfg, corpus, batches[k], device, torch.float32,
                                                 table)
            kinks = smoke.KinkReplay(torch)
            with kinks.record():
                card = step(dev)
            cpu = step("cpu")
            with kinks.replay():
                replayed = step("cpu")
            pairs = [("card vs cpu", card, cpu),
                     (f"card vs cpu, kinks replayed ({kinks.summary()})", card, replayed)]
            if args.bf16:
                with smoke.k3_left_out():
                    pairs.append(("control (k3 left out) vs replayed cpu", step(dev), replayed))
            elif not args.no_fp64:
                exact = step_gradients(cfg, corpus, batches[k], "cpu", torch.float64)
                pairs += [("card vs fp64", card, exact), ("cpu vs fp64", cpu, exact)]
            for name, a, b in pairs:
                rows, norm = worst(a[1], b[1], args.bf16)
                print(f"{variant} corpus {seed} batch {k} {name}: loss {a[0]:.7f} vs "
                      f"{b[0]:.7f} (relative {abs(a[0] - b[0]) / max(1.0, abs(b[0])):.3e}); "
                      "worst " + ", ".join(f"{n} {r:.3e}" for r, n in rows)
                      + f"; in norm {norm:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
