#!/usr/bin/env python3
"""How far kernel A' and its fp32 plain version are from float64, output by
output, and why: the ReLU after the attention.

    python3 scripts/msa_bwd_precision.py [N ...] [--seeds S ...] [--geometry prod|matrix]

Builds the setting of `chip_smoke.py`'s phase 7 (full-width MSA-DIGAT,
random weights from a seed, the seeded 20,000-news corpus, word dropout
0.2) and, for each title count N (default 8,960, the dedup capacity at
B 64), prints for each of A''s nine outputs the limit of the kernel gate
(1e-4 * max(1, max |plain|)) beside max |kernel - plain|, max |kernel -
fp64| and max |plain - fp64|, where fp64 is the plain version in float64.

Then, at the largest N, the pre-activations o = P v of the attention (the
values the ReLU cuts at 0): how many fall on the other side of 0 in the fp32
plain than in float64, and in a 3xTF32 Q|K|V product (emulated: each
operand split into hi = rna_tf32(x) and lo = rna_tf32(x - hi), the three
products summed in float64 and rounded to fp32) than in the fp32 plain;
the largest gap of each from float64 relative to sum_j p_ij |v_jc|; and how
many pre-activations and (title, head) units lie within a tolerance of 0
relative to that sum, for the tolerances around the kernel's kReluTol
(1e-5), and how many of the 3xTF32 product's flips lie outside kReluTol,
which the kernel's ReLU fix would not catch.

Each seed offset S (default 0, phase 7's setting) draws the weights, the
corpus, dp and the dropout bits anew (seeds SEED + S, SEED + 5 + S and
987 + S), and the last line of each seed gives the worst |kernel - plain|
as a share of its limit. `--geometry matrix` runs the parity matrix's
widths instead of the production ones: titles of L 16, 100-d words, 10 x 20
heads, attention 64 (scripts/torch_parity_cells.py GEOMETRY). Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.models.model import Model  # noqa: E402
from digat_tpu_torch.ops import msa_encoder as ME  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402

RATE, DROP_SEED, SITE = 0.2, 987, 0
RELU_TOL = 1e-5  # kReluTol in csrc/msa_encoder_bwd.cu
NAMES = ("dx", "dwq", "dbq", "dwk", "dwv", "dbv", "dw1", "db1", "dv")
MATRIX = dict(max_title_length=16, word_embedding_dim=100, MSA_head_num=10, MSA_head_dim=20,
              attention_dim=64)


def rna_tf32(t):
    """float32 -> float32 rounded to TF32 as cvt.rna.tf32.f32 does."""
    b = t.view(torch.int32).to(torch.int64)
    b = (b + 0x1000) & 0xFFFFE000
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def tf32x3(a, w):
    ah, wh = rna_tf32(a), rna_tf32(w)
    al, wl = rna_tf32(a - ah), rna_tf32(w - wh)
    return al.double() @ wh.double() + ah.double() @ wl.double() + ah.double() @ wh.double()


def attention(q, k, v, heads):
    """Pre-activations o = P v and sum_j p_ij |v_jc|, flat."""
    N, L, D = q.shape
    dk = D // heads
    q, k, v = (t.reshape(N, L, heads, dk) for t in (q, k, v))
    p = torch.softmax(torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(float(dk)), -1)
    o = torch.einsum("nhqk,nkhd->nqhd", p, v)
    s = torch.einsum("nhqk,nkhd->nqhd", p, v.abs())
    return o.reshape(-1), s.reshape(-1)


def one_seed(cfg, dev, sizes, offset):
    heads = cfg.MSA_head_num
    seed, drop_seed = smoke.SEED + offset, DROP_SEED + offset
    model = Model(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    tables = smoke.make_tables(torch, cfg, 20_000, dev, seed)
    ne = model.news_encoder
    mha, pool = ne.multiheadSelfattention, ne.attention
    w = [t.detach() for t in (mha.W_Q.weight.t(), mha.W_Q.bias, mha.W_K.weight.t(),
                              mha.W_V.weight.t(), mha.W_V.bias, pool.affine1.weight.t(),
                              pool.affine1.bias, pool.affine2.weight[0])]
    worst = (0.0, "")
    for n in sizes:
        text, tmask = tables.news_title_text[:n], tables.news_title_mask[:n].contiguous()
        with torch.no_grad():
            x = ne.word_embedding.weight[text].contiguous()
        dp = torch.randn((n, cfg.news_embedding_dim),
                         generator=torch.Generator(device=dev).manual_seed(seed + 5),
                         device=dev)
        got = ME.msa_encoder_bwd(x, tmask, *w, dp, heads, RATE, drop_seed, SITE)
        ref = ME.msa_encoder_bwd_plain(x, tmask, *w, dp, heads, RATE, drop_seed, SITE)
        ref64 = ME.msa_encoder_bwd_plain(x.double(), tmask, *(t.double() for t in w),
                                         dp.double(), heads, RATE, drop_seed, SITE)
        for name, a, b, c in zip(NAMES, got, ref, ref64):
            a, b = a.double(), b.double()
            limit = 1e-4 * max(1.0, float(b.abs().max()))
            gap = float((a - b).abs().max())
            worst = max(worst, (gap / limit, f"{name} at N {n}"))
            print(f"seed +{offset} N {n} {name}: limit {limit:.3e} |kernel - plain| "
                  f"{gap:.3e} |kernel - fp64| "
                  f"{float((a - c).abs().max()):.3e} |plain - fp64| "
                  f"{float((b - c).abs().max()):.3e}", flush=True)
        del got, ref, ref64
    n = sizes[-1]
    wq, bq, wk, wv, bv = w[:5]
    with torch.no_grad():
        xd = ME.drop_titles_plain(x, RATE, drop_seed, SITE)
        o32, _ = attention(xd @ wq + bq, xd @ wk, xd @ wv + bv, heads)
        x64 = xd.double()
        o64, s64 = attention(x64 @ wq.double() + bq.double(), x64 @ wk.double(),
                             x64 @ wv.double() + bv.double(), heads)
        o3, _ = attention((tf32x3(xd, wq) + bq.double()).float(), tf32x3(xd, wk).float(),
                          (tf32x3(xd, wv) + bv.double()).float(), heads)
        flips = (o3 > 0) != (o32 > 0)
        missed = flips & (o3.double().abs() > RELU_TOL * s64)
        rel_gap = lambda a, b: float(((a.double() - b.double()).abs() / s64).max())
        print(f"seed +{offset} N {n}: {o32.numel()} pre-activations; largest gap from fp64 "
              f"relative to sum_j p|v|: fp32 {rel_gap(o32, o64):.3e}, 3xTF32 "
              f"{rel_gap(o3, o64):.3e}, 3xTF32 from fp32 {rel_gap(o3, o32):.3e}; "
              f"sides of 0 that differ: fp32 vs fp64 {int(((o32 > 0) != (o64 > 0)).sum())}, "
              f"3xTF32 vs fp32 {int(flips.sum())}, of these outside kReluTol "
              f"{int(missed.sum())}")
        rel = o64.abs() / s64
        dk = cfg.news_embedding_dim // heads
        for tol in (1e-4, 3e-5, 1e-5, 3e-6, 1e-6):
            near = rel < tol
            units = near.reshape(n, cfg.max_title_length, heads, dk).any(3).any(1)
            print(f"  within {tol:g} of 0: {int(near.sum())} pre-activations, "
                  f"{int(units.sum())} of {units.numel()} (title, head) units")
    print(f"seed +{offset}: worst |kernel - plain| {worst[0]:.3f} of its limit ({worst[1]})",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sizes", nargs="*", type=int, default=[8960])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--geometry", choices=("prod", "matrix"), default="prod")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("msa_bwd_precision: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    widths = MATRIX if args.geometry == "matrix" else {}
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18, **widths)
    print(torch.cuda.get_device_name(0), torch.__version__, f"geometry {args.geometry}: L "
          f"{cfg.max_title_length}, Din {cfg.word_embedding_dim}, {cfg.MSA_head_num} x "
          f"{cfg.MSA_head_dim} heads, A {cfg.attention_dim}", flush=True)
    for offset in args.seeds:
        one_seed(cfg, dev, args.sizes, offset)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
