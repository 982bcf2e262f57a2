"""Cross-run result aggregation: the port's own copy of
`digat_tpu.eval.aggregate`, writing the same bytes.

Scans <run_root>/results/<dataset>/<model>/#N-{dev,test} files (the CLI
writes them; an empty one marks a run that never finished and is skipped),
writes per-model `experiment_results-{dev,test}.tsv` (one row per run, then
mean and std rows) and a dataset-level `overall-{dev,test}.tsv` with the
per-model means: the multi-run statistics behind a seed study.

    python -m digat_tpu_torch.eval.aggregate --run_root runs --dataset MIND-small
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Tuple

METRICS = ("auc", "mrr", "ndcg5", "ndcg10")


def _read_runs(model_dir: str, mode: str) -> List[Tuple[int, List[float]]]:
    runs = []
    for name in sorted(os.listdir(model_dir)):
        if not (name.startswith("#") and name.endswith(f"-{mode}")):
            continue
        path = os.path.join(model_dir, name)
        with open(path) as f:
            content = f.read().strip()
        if not content:
            continue  # allocated-but-unfinished run markers
        parts = content.split("\t")
        runs.append((int(parts[0][1:]), [float(x) for x in parts[1:5]]))
    return sorted(runs)


def _mean_std(rows: List[List[float]]) -> Tuple[List[float], List[float]]:
    n = len(rows)
    mean = [sum(r[i] for r in rows) / n for i in range(4)]
    std = [
        math.sqrt(sum((r[i] - mean[i]) ** 2 for r in rows) / n) for i in range(4)
    ]
    return mean, std


def aggregate(run_root: str, dataset: str, mode: str = "dev") -> Dict[str, List[float]]:
    """Returns {model_name: mean metrics}; writes the tsv artifacts."""
    results_dir = os.path.join(run_root, "results", dataset)
    if not os.path.isdir(results_dir):
        return {}
    overall: Dict[str, List[float]] = {}
    for model_name in sorted(os.listdir(results_dir)):
        model_dir = os.path.join(results_dir, model_name)
        if not os.path.isdir(model_dir):
            continue
        runs = _read_runs(model_dir, mode)
        if not runs:
            continue
        mean, std = _mean_std([m for _, m in runs])
        out = os.path.join(model_dir, f"experiment_results-{mode}.tsv")
        with open(out, "w", encoding="utf-8") as f:
            f.write("run\tAUC\tMRR\tnDCG@5\tnDCG@10\n")
            for idx, m in runs:
                f.write("#%d\t%.4f\t%.4f\t%.4f\t%.4f\n" % (idx, *m))
            f.write("mean\t%.4f\t%.4f\t%.4f\t%.4f\n" % tuple(mean))
            f.write("std\t%.4f\t%.4f\t%.4f\t%.4f\n" % tuple(std))
        overall[model_name] = mean
    if overall:
        with open(
            os.path.join(results_dir, f"overall-{mode}.tsv"), "w", encoding="utf-8"
        ) as f:
            f.write("model\tAUC\tMRR\tnDCG@5\tnDCG@10\n")
            for name in sorted(overall):
                f.write("%s\t%.4f\t%.4f\t%.4f\t%.4f\n" % (name, *overall[name]))
    return overall


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="aggregate run results")
    p.add_argument("--run_root", default="runs")
    p.add_argument("--dataset", default="MIND-small")
    args = p.parse_args(argv)
    for mode in ("dev", "test"):
        overall = aggregate(args.run_root, args.dataset, mode)
        if overall:
            print(f"[{mode}]")
            for name, m in overall.items():
                print("  %s  AUC=%.4f MRR=%.4f nDCG@5=%.4f nDCG@10=%.4f" % (name, *m))


if __name__ == "__main__":
    main(sys.argv[1:])
