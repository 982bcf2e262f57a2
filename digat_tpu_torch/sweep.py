"""Ablation sweeps: the port's own copy of `digat_tpu.sweep`.

Runs a grid of experiments, each point a full train, dev and test cycle of
`cli.run_train` (on one device, or on every rank under torchrun), results
landing in the shared results tree, then `eval.aggregate` over it: the
grid the reference documents as separate shell invocations
(graph-encoder ablations, SAG geometry, graph depth, news encoder).

    python -m digat_tpu_torch.sweep --dataset MIND-small \
        --axis graph_encoder=DIGAT,wo_SA,Seq_SA --axis graph_depth=1,2,3

Axes combine as a cartesian product. Each point reuses every cached
artifact whose configuration keys it shares with earlier points (a SAG
sweep rebuilds only the news graph).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
from typing import List, Sequence, Tuple

from digat_tpu_torch import cli
from digat_tpu_torch.config import Config
from digat_tpu_torch.eval.aggregate import aggregate
from digat_tpu_torch.parallel import dist as dist_lib


def parse_axis(spec: str) -> Tuple[str, List[str]]:
    name, _, values = spec.partition("=")
    if not values:
        raise ValueError(f"axis spec '{spec}' needs name=v1,v2,...")
    return name, values.split(",")


def _coerce(cfg_field_type, value: str):
    if cfg_field_type is int:
        return int(value)
    if cfg_field_type is float:
        return float(value)
    if cfg_field_type is bool:
        return value.lower() in ("1", "true", "yes")
    return value


def sweep_points(base: Config, axes: Sequence[Tuple[str, List[str]]]):
    """Yields ({axis: value string}, Config) for every combination."""
    field_types = {f.name: type(f.default) for f in dataclasses.fields(Config)}
    names = [a[0] for a in axes]
    for combo in itertools.product(*[a[1] for a in axes]):
        cfg = dataclasses.replace(base)
        for name, value in zip(names, combo):
            setattr(cfg, name, _coerce(field_types[name], value))
        yield dict(zip(names, combo)), cfg.check_options()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="digat_tpu_torch ablation sweeps")
    parser.add_argument("--axis", action="append", default=[], help="name=v1,v2,...")
    parser.add_argument("--base", nargs=argparse.REMAINDER, default=[],
                        help="remaining args parsed as the base Config")
    known, rest = parser.parse_known_args(argv)
    base = Config.from_args((known.base or []) + rest)
    axes = [parse_axis(s) for s in known.axis]
    points = list(sweep_points(base, axes))
    dist = dist_lib.init_distributed(base)
    try:
        dist_lib.build_kernels(dist)
        say = print if dist.is_main else (lambda *a: None)
        say(f"[sweep] {len(points)} points over axes {[a[0] for a in axes]}", flush=True)
        for i, (combo, cfg) in enumerate(points):
            say(f"[sweep] point {i + 1}/{len(points)}: {combo}", flush=True)
            cli.run_train(cfg, dist)
        if not dist.is_main:
            return
        for mode in ("dev", "test"):
            overall = aggregate(base.run_root, base.dataset, mode)
            for name, m in overall.items():
                print("[sweep %s] %s AUC=%.4f MRR=%.4f nDCG@5=%.4f nDCG@10=%.4f"
                      % (mode, name, *m), flush=True)
    finally:
        dist_lib.destroy(dist)


if __name__ == "__main__":
    main(sys.argv[1:])
