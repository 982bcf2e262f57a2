"""The port's tools against the JAX package's, on the CPU:

  * `eval.aggregate.aggregate` writes TSV files byte for byte as
    `digat_tpu.eval.aggregate.aggregate` does on a fabricated results tree
    (two models, dev and test, an empty run marker), and returns the same
    means (exactly);
  * `sweep.sweep_points` yields the combinations and field values of
    `digat_tpu.sweep.sweep_points` for the same axes;
  * a 2-point sweep (`sweep.main`, graph depth 1 and 2, one epoch at narrow
    widths) trains both points and ends in the aggregate lines;
  * `utils.profiling.StepTimer` summarises the same durations as the JAX
    package's (the same clock readings; exactly);
  * a `Trainer` epoch with `profile_dir` writes one Chrome trace holding the
    `train_step` spans of steps 10-19 (10 of them), and its record the
    StepTimer summary of its steps after two of warm-up."""

import dataclasses
import glob
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest

from digat_tpu import sweep as jax_sweep
from digat_tpu.config import Config as JaxConfig
from digat_tpu.eval.aggregate import aggregate as jax_aggregate
from digat_tpu.utils import profiling as jax_profiling
from digat_tpu_torch import sweep
from digat_tpu_torch.config import Config
from digat_tpu_torch.eval.aggregate import aggregate
from digat_tpu_torch.models.model import Model
from digat_tpu_torch.train.trainer import Trainer
from digat_tpu_torch.utils import profiling
from tests.test_torch_support import one_thread, port_config, train_corpus  # noqa: F401

NARROW = ["--dataset", "synthetic", "--device", "cpu", "--epoch", "1", "--batch_size", "16",
          "--max_history_num", "12", "--max_title_length", "16", "--SAG_neighbors", "3",
          "--eval_batch_size", "64", "--word_embedding_dim", "32", "--MSA_head_num", "4",
          "--MSA_head_dim", "8", "--attention_dim", "16"]


def _results_tree(root):
    """runs/results/d/<model>/#N-{dev,test}: three runs of MSA-DIGAT (#3
    allocated, never finished: empty), one of NRMS-SA."""
    rng = np.random.default_rng(0)
    for model, runs in (("MSA-DIGAT", (1, 2, 3)), ("NRMS-SA", (4,))):
        d = os.path.join(root, "results", "d", model)
        os.makedirs(d)
        for n in runs:
            for mode in ("dev", "test"):
                with open(os.path.join(d, f"#{n}-{mode}"), "w") as f:
                    if n != 3:
                        f.write(f"#{n}\t" + "\t".join(str(v) for v in rng.random(4)) + "\n")


def _tsv_files(root):
    return {os.path.relpath(p, root): Path(p).read_bytes()
            for p in sorted(glob.glob(os.path.join(root, "**", "*.tsv"), recursive=True))}


def test_aggregate_writes_the_jax_packages_bytes(tmp_path):
    for side in ("jax", "port"):
        _results_tree(str(tmp_path / side))
    for mode in ("dev", "test"):
        want = jax_aggregate(str(tmp_path / "jax"), "d", mode)
        got = aggregate(str(tmp_path / "port"), "d", mode)
        assert got == want and sorted(got) == ["MSA-DIGAT", "NRMS-SA"]
    want_files = _tsv_files(str(tmp_path / "jax"))
    assert len(want_files) == 6  # 2 models x 2 modes + overall-{dev,test}
    assert _tsv_files(str(tmp_path / "port")) == want_files
    assert aggregate(str(tmp_path / "none"), "d") == {}


def test_sweep_points_match_jax():
    flags = ["--dataset", "synthetic", "--batch_size", "16", "--lr", "1e-3"]
    axes = [sweep.parse_axis("graph_encoder=DIGAT,wo_SA"), ("graph_depth", ["1", "2"]),
            ("dropout_rate", ["0.1"]), ("resume", ["x.ckpt"])]
    got = list(sweep.sweep_points(Config.from_args(flags), axes))
    want = list(jax_sweep.sweep_points(JaxConfig.from_args(flags), axes))
    assert [c for c, _ in got] == [c for c, _ in want] and len(got) == 4
    shared = set(f.name for f in dataclasses.fields(Config)) & set(
        f.name for f in dataclasses.fields(JaxConfig))
    for (_, g), (_, w) in zip(got, want):
        assert {k: getattr(g, k) for k in shared} == {k: getattr(w, k) for k in shared}
    with pytest.raises(ValueError, match="name=v1"):
        sweep.parse_axis("graph_depth")


def test_two_point_sweep_ends_in_the_aggregate_lines(tmp_path, monkeypatch, capsys, one_thread):
    monkeypatch.chdir(tmp_path)
    sweep.main(["--axis", "graph_depth=1,2", *NARROW])
    out = capsys.readouterr().out
    assert "[sweep] 2 points over axes ['graph_depth']" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("[sweep dev] MSA-DIGAT AUC=")]
    assert len(lines) == 1 and "[sweep test] MSA-DIGAT AUC=" in out
    results = tmp_path / "runs" / "results" / "synthetic" / "MSA-DIGAT"
    rows = (results / "experiment_results-dev.tsv").read_text().splitlines()
    assert [r.split("\t")[0] for r in rows] == ["run", "#1", "#2", "mean", "std"]
    configs = [json.loads((tmp_path / "runs" / "synthetic" / "MSA-DIGAT" / f"#{n}" /
                           "config.json").read_text()) for n in (1, 2)]
    assert [c["graph_depth"] for c in configs] == [1, 2]


def test_step_timer_summary_matches_jax(monkeypatch):
    durations = [0.5, 0.4, 0.011, 0.013, 0.012, 0.02, 0.0105, 0.014]
    clock = []
    for d in durations:
        start = 100.0 + len(clock)
        clock += [start, start + d]
    timers = {}
    for name, module in (("jax", jax_profiling), ("port", profiling)):
        ticks = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = module.StepTimer(warmup=2)
        for _ in durations:
            with t.step():
                pass
        timers[name] = t.summary()
    assert timers["port"] == timers["jax"] and timers["port"]["steps"] == 6
    assert profiling.StepTimer().summary() == jax_profiling.StepTimer().summary()


def test_trainer_traces_steps_10_to_20_into_profile_dir(tmp_path, one_thread):
    cfg = port_config(epoch_override=1, batch_size=4, dropout_rate=0.0,
                      profile_dir=str(tmp_path / "trace"))
    corpus = train_corpus(np.random.default_rng(0), cfg, 30, 20, 88)  # 22 steps of 4
    model = Model(cfg, device="cpu")
    (rec,) = Trainer(model, cfg, corpus, str(tmp_path / "run"), verbose=False).train()
    assert len(rec["step_ms"]) == 22 and rec["steps"]["steps"] == 20
    assert rec["steps"]["median_ms"] == pytest.approx(float(np.median(rec["step_ms"][2:])))
    (trace,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == "train_step" and e.get("ph") == "X"]
    assert len(spans) == 10
