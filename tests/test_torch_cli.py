"""`python -m digat_tpu_torch.cli` on the CPU (`--device cpu`), on the
synthetic corpus at L 16, B 16, history 12, SAG 3, depth 2, eval batch 64
and narrow widths, 2 epochs:

  * a train run writes `#1-dev`, `#1-test`, `config.json`, `best.ckpt`, the
    truth files and each epoch's dev rank file where the JAX CLI writes
    them, and the official scorer reads each rank file back to the epoch's
    metrics; a second run takes `#2`;
  * `--mode dev` and `--mode test` on `best.ckpt` give the recorded best
    epoch's dev metrics and the auto-test's metrics again, exactly;
  * a JAX command line parses, a TPU-only value the port does not run
    raises naming its ROADMAP item, and MIND-small without its files raises
    the message naming them without opening a socket;
  * NRMS-SA trains one epoch through the same CLI;
  * `run_train` and `run_eval` without a data-parallel context build the
    model on the configured device (CUDA stays CUDA);
  * scripts/torch_parity_cells.py imports with jax and digat_tpu blocked."""

import json
import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from digat_tpu.config import Config as JaxConfig
from digat_tpu_torch import cli
from digat_tpu_torch.config import Config
from digat_tpu_torch.eval import metrics as PM
from digat_tpu_torch.parallel import dist as dist_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("auc", "mrr", "ndcg5", "ndcg10")


def _flags(tmp, *extra):
    return ["--dataset", "synthetic", "--device", "cpu", "--epoch", "2", "--batch_size", "16",
            "--max_history_num", "12", "--max_title_length", "16", "--SAG_neighbors", "3",
            "--graph_depth", "2", "--eval_batch_size", "64", "--word_embedding_dim", "32",
            "--MSA_head_num", "4", "--MSA_head_dim", "8", "--attention_dim", "16",
            "--nrms_head_num", "4", "--nrms_head_dim", "8", "--nrms_attention_dim", "16",
            "--augmented_news_num", "4", "--data_root", os.path.join(tmp, "data"),
            "--run_root", os.path.join(tmp, "runs"), *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    return tmp, cli.main(_flags(tmp))


def _read_metrics(path):
    with open(path) as f:
        parts = f.read().strip().split("\t")
    return parts[0], tuple(float(x) for x in parts[1:])


def test_train_writes_the_run_layout(trained):
    tmp, rec = trained
    runs = os.path.join(tmp, "runs")
    run_dir = os.path.join(runs, "synthetic", "MSA-DIGAT", "#1")
    results = os.path.join(runs, "results", "synthetic", "MSA-DIGAT")
    assert rec["run_index"] == 1 and rec["run_dir"] == run_dir and len(rec["history"]) == 2
    for name in ("config.json", "best.ckpt", "dev_log.txt", "test-prediction.txt",
                 "dev-epoch1.txt", "dev-epoch2.txt"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    with open(os.path.join(run_dir, "config.json")) as f:
        cfg = Config(**json.load(f))
    assert cfg.run_index == 1 and cfg.max_title_length == 16 and cfg.device == "cpu"
    best = rec["history"][rec["best_epoch"] - 1]
    assert _read_metrics(os.path.join(results, "#1-dev")) == \
        ("#1", tuple(best[k] for k in KEYS))
    assert _read_metrics(os.path.join(results, "#1-test")) == ("#1", rec["test"])
    truth = os.path.join(runs, "dev", "synthetic", "ref", "truth.txt")
    assert os.path.exists(os.path.join(runs, "test", "synthetic", "ref", "truth.txt"))
    for h in rec["history"]:
        got = PM.scoring_from_files(truth, os.path.join(run_dir, f"dev-epoch{h['epoch']}.txt"))
        np.testing.assert_allclose(got, [h[k] for k in KEYS], rtol=0, atol=1e-9)
        assert np.isfinite(h["loss"]) and len(h["step_ms"]) == len(h["step_losses"]) > 0


def test_checkpoint_scores_again_exactly(trained):
    tmp, rec = trained
    ckpt = os.path.join(rec["run_dir"], "best.ckpt")
    best = rec["history"][rec["best_epoch"] - 1]
    dev = cli.main(_flags(tmp, "--mode", "dev", "--dev_model_path", ckpt))
    assert dev == tuple(best[k] for k in KEYS)
    test = cli.main(_flags(tmp, "--mode", "test", "--test_model_path", ckpt))
    assert test == rec["test"]


def test_second_run_takes_the_next_index(trained):
    tmp, _ = trained
    rec = cli.main(_flags(tmp, "--epoch", "1"))
    assert rec["run_index"] == 2
    assert os.path.exists(os.path.join(tmp, "runs", "results", "synthetic", "MSA-DIGAT",
                                       "#2-test"))


def test_nrms_sa_trains_through_the_cli(trained):
    tmp, _ = trained
    rec = cli.main(_flags(tmp, "--epoch", "1", "--model_family", "nrms"))
    assert rec["run_index"] == 1 and len(rec["history"]) == 1
    assert all(np.isfinite(rec["test"]))
    assert os.path.exists(os.path.join(tmp, "runs", "results", "synthetic", "NRMS-SA", "#1-dev"))


def test_jax_command_line_parses_and_tpu_only_values_raise():
    jcfg = JaxConfig(dataset="MIND-small", max_title_length=16, epoch_override=8,
                     use_pallas=False, rng_impl="threefry", dedup_titles=0)
    flags = [a for k, v in vars(jcfg).items() for a in (f"--{k}", str(v))]
    cfg = Config.from_args(flags)
    assert (cfg.max_title_length, cfg.epoch, cfg.dedup_titles, cfg.device) == (16, 8, 0, "cuda")
    # --mesh_model parses; one process cannot hold a model axis of 2 (it
    # does not divide the process's one rank), and neither does a
    # vocabulary that 2 does not split into equal row blocks
    assert Config.from_args(["--mesh_model", "2"]).mesh_model == 2
    with pytest.raises(ValueError, match="mesh_model 2 needs as many ranks"):
        dist_lib.init_distributed(Config.from_args(["--mesh_model", "2", "--device", "cpu"]))
    with pytest.raises(ValueError, match="mesh_model 2 does not split"):
        Config.from_args(["--mesh_model", "2", "--dataset", "synthetic", "--vocabulary_size",
                          "7", "--category_num", "4"]).validate()
    # the scatter-add word gradient is a route of the port: the flag is a field
    assert Config.from_args(["--sorted_emb_grad", "false"]).sorted_emb_grad is False
    assert cfg.sorted_emb_grad is True
    # the distribution flags and the profile directory are fields, which
    # parallel.dist.init_distributed holds against the launcher
    cfg = Config.from_args(["--mesh_data", "4", "--profile_dir", "/tmp/trace",
                            "--coordinator_address", "10.0.0.1:1234", "--num_processes", "2",
                            "--process_id", "1"])
    assert (cfg.mesh_data, cfg.profile_dir, cfg.coordinator_address, cfg.num_processes,
            cfg.process_id) == (4, "/tmp/trace", "10.0.0.1:1234", 2, 1)
    # every title length runs on the card: kernels A and A' up to 128, the
    # attention pair beyond, as the JAX package routes them
    assert Config.from_args(["--max_title_length", "40"]).max_title_length == 40
    assert Config.from_args(["--max_title_length", "160"]).max_title_length == 160
    assert Config.from_args(["--max_title_length", "40", "--device", "cpu"]).max_title_length == 40
    for flags in (["--news_encoder", "CNN"], ["--graph_encoder", "wo_SA"]):
        assert Config.from_args(flags).device == "cuda"
    # every model runs at bfloat16, as in the JAX package
    assert Config.from_args(["--compute_dtype", "bfloat16", "--model_family",
                             "nrms"]).compute_dtype == "bfloat16"


@pytest.mark.parametrize("mode", ["train", "dev"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_entry_points_without_a_context_build_on_the_configured_device(monkeypatch, mode,
                                                                        device):
    """`run_train` and `run_eval` called as before data parallelism (no
    `dist`) build the model on `cfg.device`: CUDA stays CUDA. The corpus is
    a stub and the model is not built, so no card is needed."""
    class Built(Exception):
        pass

    seen = []

    def build_model(cfg, word_embedding=None, device=None, dist=None):
        seen.append(device)
        raise Built

    monkeypatch.setattr(cli, "prepare", lambda cfg, dist: SimpleNamespace(word_embedding=None))
    monkeypatch.setattr(cli, "build_model", build_model)
    cfg = Config(device=device, dev_model_path="best.ckpt")
    with pytest.raises(Built):
        cli.run_train(cfg) if mode == "train" else cli.run_eval(cfg, mode)
    assert seen == [torch.device(device)]


def test_mind_small_without_data_raises_without_network(tmp_path, monkeypatch):
    def no_socket(*a, **k):
        raise AssertionError("opened a socket")

    monkeypatch.setattr(socket, "socket", no_socket)
    monkeypatch.setattr(socket, "create_connection", no_socket)
    with pytest.raises(FileNotFoundError, match="does not download MIND"):
        cli.main(["--dataset", "MIND-small", "--device", "cpu", "--data_root",
                  str(tmp_path / "data"), "--run_root", str(tmp_path / "runs")])


def test_parity_cells_script_imports_without_jax():
    code = """
import importlib.util, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "digat_tpu"}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
spec = importlib.util.spec_from_file_location("cells", "scripts/torch_parity_cells.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert sorted(mod.CELLS) == ["matrix-cnn", "matrix-msa", "matrix-news_graph_wo_inter",
                             "matrix-nrms", "matrix-nrms-sa", "matrix-seq_sa",
                             "matrix-user_graph_wo_inter", "matrix-wo_interaction",
                             "matrix-wo_sa", "prod", "refprot"]
assert set(mod.TARGETS) <= set(mod.CELLS)
print("ok")
"""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
