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
  * scripts/torch_parity_cells.py imports with jax and digat_tpu blocked."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from digat_tpu.config import Config as JaxConfig
from digat_tpu_torch import cli
from digat_tpu_torch.config import Config
from digat_tpu_torch.eval import metrics as PM

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
    for flags, item in [(["--compute_dtype", "bfloat16", "--model_family", "nrms"],
                         "section 1, item 3"),
                        (["--mesh_data", "4"], "multi-GPU"),
                        (["--profile_dir", "/tmp/trace"], "StepTimer"),
                        (["--sorted_emb_grad", "false"], "kernel D"),
                        (["--coordinator_address", "10.0.0.1:1234"], "multi-GPU")]:
        with pytest.raises(NotImplementedError, match=item):
            Config.from_args(flags)
    # every title length runs on the card: kernels A and A' up to 128, the
    # attention pair beyond, as the JAX package routes them
    assert Config.from_args(["--max_title_length", "40"]).max_title_length == 40
    assert Config.from_args(["--max_title_length", "160"]).max_title_length == 160
    assert Config.from_args(["--max_title_length", "40", "--device", "cpu"]).max_title_length == 40
    for flags in (["--news_encoder", "CNN"], ["--graph_encoder", "wo_SA"]):
        assert Config.from_args(flags).device == "cuda"


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
