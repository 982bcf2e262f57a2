#!/usr/bin/env python3
"""Why two data-parallel ranks and one process stepping the whole batch in
one pass give step-1 gradients 5e-4 of a tensor's max apart on the card
(`chip_smoke.py` phase 22): the witness.

    python3 scripts/dp_kink_witness.py

Phase 22's MSA-DIGAT job (full width, B 64, depth 3, dedup, the same
weights and first global batch, dropout 0) is stepped four ways: on the
card in one pass and as the two ranks' row groups in turn (which give the
ranks' gradients bit for bit: phase 22 gates that), each with its kink
sides recorded (`chip_smoke.KinkReplay`: the Eq. (8) sums of C's backward,
the ReLUs and leaky ReLUs); and on the CPU the same two ways, each taking
the side that its card run took at every kink. It prints the kinks where
the card's groups and one pass took opposite sides, each card run against
its own CPU reference and against the other's, and the two CPU references
against each other (which differ in the kink sides they take and in the
order of a few sums). If each card run lies as close to its own reference
as the other does, and the two references differ by the whole gap, the
gap is those kinks: fp32 rounding at other row shapes, not a fault. Needs
a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import replace

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402
from digat_tpu_torch.config import Config  # noqa: E402
from digat_tpu_torch.ops import build  # noqa: E402
from digat_tpu_torch.runtime import exact_fp32  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("dp_kink_witness: no CUDA device", file=sys.stderr)
        return 2
    exact_fp32()
    dev = torch.device("cuda", 0)
    build.build_library()
    build.load_library()
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(min(torch.get_num_threads(), cores))
    cfg = Config(dataset="synthetic", vocabulary_size=40_000, category_num=18)
    part = smoke.dp_job(torch, cfg, replace(cfg, model_family="nrms"), dev)["digat"]
    kinks = {"one pass": smoke.KinkReplay(torch), "row groups": smoke.KinkReplay(torch)}
    groups = {"one pass": 1, "row groups": smoke.DP_WORLD}
    card, cpu = {}, {}
    t0 = time.perf_counter()
    for way, k in kinks.items():
        with k.record():
            card[way] = smoke.reference_step(torch, part, dev, groups=groups[way])[:2]
    for way, k in kinks.items():
        with k.replay():
            cpu[way] = smoke.reference_step(torch, part, torch.device("cpu"),
                                            groups=groups[way])[:2]
        smoke.say(f"{way}: kinks where the CPU took the card's side against its own: "
                  f"{k.summary()}")
    apart = smoke.kink_sides_apart(torch, kinks["one pass"], kinks["row groups"], smoke.DP_WORLD)
    smoke.say(f"kinks where the card's row groups took the other side than its one pass: "
              + "; ".join(f"{k} {v[0]} of {v[1]}" if v else f"{k} not comparable"
                          for k, v in apart.items())
              + f" ({time.perf_counter() - t0:.2f}s)")
    for got in ("one pass", "row groups"):
        for ref in ("one pass", "row groups"):
            loss_err = abs(card[got][0] - cpu[ref][0]) / max(1.0, abs(cpu[ref][0]))
            smoke.say_spread(f"card {got} against the CPU {ref}",
                             smoke.grad_spread(card[got][1], cpu[ref][1]), loss_err)
    smoke.say_spread("the CPU row groups against the CPU one pass",
                     smoke.grad_spread(cpu["row groups"][1], cpu["one pass"][1]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
