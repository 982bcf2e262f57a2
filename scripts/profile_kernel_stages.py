#!/usr/bin/env python3
"""Where kernels A (MSA-encoder forward), A' (its backward), C (Eq. 8 scores)
and D (embedding gradient) spend their time on the card, stage by stage, at
the main path's shapes.

    python3 scripts/profile_kernel_stages.py [--reps 5]

Builds the setting of `chip_smoke.py`'s phases 3 and 7: full-width
MSA-DIGAT, random weights from a seed, the seeded 20,000-news corpus, the
dedup capacity at B 64 (8,960 titles). Traces `--reps` calls of each wrapper
with `torch.profiler` and prints the device ms of every launch of one call
in launch order (`chip_smoke.stage_split`): A with word dropout 0.2 at the
dedup capacity and without at the serving chunk of 1,024 titles, A' with
word dropout 0.2, C forward and backward at B 320 and G 26 and 68 (k1 and
k2 as column blocks of the fused projection, as the training GAT layer
passes them), D on the uniform token stream and on the pad stream (token 0
wherever the title mask is False, as the corpus writes titles). Beside each
it prints the wrapper's CUDA-event time, and for D
`embedding_dense_backward`'s. It uses only the wrappers' public entry
points, so a copy beside an older tree of the package (with that tree's
`chip_smoke.py`) profiles that tree's kernels. Needs a CUDA device; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.data import batching, sampling  # noqa: E402
from digat_tpu_torch.models.model import Model  # noqa: E402
from digat_tpu_torch.ops import emb_grad as EG  # noqa: E402
from digat_tpu_torch.ops import gat_scores as GS  # noqa: E402
from digat_tpu_torch.ops import msa_encoder as ME  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_kernel_stages: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", "0"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), torch.__version__, torch.version.cuda, flush=True)
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(smoke.SEED))
    tables = smoke.make_tables(torch, cfg, 20_000, dev, smoke.SEED)
    corpus = smoke.make_train_corpus(cfg, tables, (smoke.TRAIN_STEPS + 2) * cfg.batch_size,
                                     2000, 32, smoke.SEED + 4)
    probe = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                      cfg.negative_sample_num, np.random.default_rng(cfg.seed))
    cap = batching.estimate_dedup_capacity(
        corpus.splits["train"].history_idx, corpus.train_behavior_row, corpus.train_pos, probe,
        corpus.news_node_id, cfg.batch_size, seed=cfg.seed)
    L, Din, V = cfg.max_title_length, cfg.word_embedding_dim, cfg.vocabulary_size
    heads, p = cfg.MSA_head_num, cfg.dropout_rate

    ne = model.news_encoder
    mha, pool = ne.multiheadSelfattention, ne.attention
    text, tmask = tables.news_title_text[:cap], tables.news_title_mask[:cap].contiguous()
    with torch.no_grad():
        x = ne.word_embedding.weight[text].contiguous()
    w = [t.detach() for t in (mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(),
                              mha.W_V.weight.t(), mha.W_V.bias, pool.affine1.weight.t(),
                              pool.affine1.bias, pool.affine2.weight[0])]
    bs = cfg.effective_eval_batch_size()
    for n, rate in ((cap, p), (bs, 0.0)):
        fwd = lambda n=n, rate=rate: ME.msa_encoder_pooled(x[:n], tmask[:n], *w, heads, rate,
                                                           987, 0)
        print(f"A [{n},{L},{Din}] dropout {rate}: wrapper ms {smoke.time_ms(torch, fwd):.4f}",
              flush=True)
        smoke.say_stages(f"A (N {n})", smoke.stage_split(torch, fwd, args.reps))

    D = cfg.news_embedding_dim
    B = cfg.batch_size * (1 + cfg.negative_sample_num)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 9)
    for G in (cfg.news_graph_size, cfg.user_graph_size):
        r = lambda *s: torch.randn(s, generator=gen, device=dev) * 0.5
        y = r(B, G, 3 * D)
        sargs = (y[..., D:2 * D], y[..., 2 * D:], r(B, D), r(D))
        gout = r(B, G, G)
        for what, fn in (("fwd", lambda: GS.gat_scores_fwd(*sargs)),
                         ("bwd", lambda: GS.gat_scores_bwd(*sargs, gout))):
            print(f"C {what} B {B} G {G} D {D}: wrapper ms {smoke.time_ms(torch, fn):.4f}",
                  flush=True)
            smoke.say_stages(f"C {what} (G {G})", smoke.stage_split(torch, fn, args.reps))

    dp = torch.randn((cap, cfg.news_embedding_dim),
                     generator=torch.Generator(device=dev).manual_seed(smoke.SEED + 5), device=dev)
    bwd = lambda: ME.msa_encoder_bwd(x, tmask, *w, dp, heads, p, 987, 0)
    print(f"A' [{cap},{L},{Din}] dropout {p}: wrapper ms {smoke.time_ms(torch, bwd):.4f}",
          flush=True)
    smoke.say_stages("A'", smoke.stage_split(torch, bwd, args.reps))

    g = torch.randn((cap * L, Din), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    streams = {"uniform": text.reshape(-1),
               "pad": torch.where(tmask, text, torch.zeros_like(text)).reshape(-1)}
    for what, tok in streams.items():
        pad = float((tok == 0).float().mean())
        fn = lambda: EG.embedding_grad(tok, g, V)
        lib = lambda: torch.ops.aten.embedding_dense_backward(g, tok, V, -1, False)
        print(f"D {what} stream, ntok {tok.numel()} V {V} (token 0 on {pad:.3f} of slots): "
              f"wrapper ms {smoke.time_ms(torch, fn):.4f}, embedding_dense_backward ms "
              f"{smoke.time_ms(torch, lib):.4f}", flush=True)
        smoke.say_stages(f"D ({what})", smoke.stage_split(torch, fn, args.reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
