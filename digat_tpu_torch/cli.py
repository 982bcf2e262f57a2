"""Experiment driver: train, dev and test modes, from MIND-layout TSV files.

The port's counterpart of `digat_tpu/cli.py`. `train` prepares the corpus
(the synthetic dataset generates itself; MIND-small and MIND-large must
already be on disk, `data.prepare`), trains, scores dev after each epoch,
then tests the best checkpoint; `dev` and `test` score a checkpoint.
Layout, as the JAX package writes it:

    <run_root>/results/<dataset>/<model>/#N-dev, #N-test   best dev, test metrics
    <run_root>/<dataset>/<model>/#N/   config.json, best.ckpt, dev-epoch<e>.txt,
                                       dev_log.txt, test-prediction.txt
    <run_root>/{dev,test}/<dataset>/ref/truth.txt   the official scorer's truth
    <run_root>/prediction/<dataset>/<model>/#N/prediction.zip   MIND-large test

One process on one device, CUDA unless `--device cpu`; or one process a
GPU under torchrun, data parallel (`parallel.dist`; on the CPU over gloo),
with the word table row-sharded over `--mesh_model` M of them
(`parallel.sharded_table`; `--mesh_data` x `--mesh_model` ranks):

    python -m digat_tpu_torch.cli --dataset synthetic --device cpu --epoch 2
    python -m torch.distributed.run --nproc_per_node N -m digat_tpu_torch.cli ...
    python -m torch.distributed.run --nproc_per_node 4 -m digat_tpu_torch.cli \
        --mesh_data 2 --mesh_model 2 ...

Across ranks, rank 0 prepares the data and builds the kernels while the
others wait at a barrier; every rank trains and scores its share, rank 0
alone writes the run's files, and every rank joins the test of the best
checkpoint, which rank 0 loads and broadcasts (on a model axis, each rank
of rank 0's model group loads its rows and broadcasts them to its data
group). `--profile_dir` traces
steps 10-20 of the first epoch. `--compute_dtype bfloat16` trains and
scores every model (MSA or CNN DIGAT and its ablations, NRMS, NRMS-SA) on
bf16 compute copies of the fp32 weights (`models.model.ComputeCopy`); the
checkpoints hold the fp32 masters.
"""

from __future__ import annotations

import os
import sys
import time
import zipfile
from typing import Optional

import torch

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import corpus as corpus_lib
from digat_tpu_torch.data import prepare as prepare_lib
from digat_tpu_torch.data import synthetic
from digat_tpu_torch.eval import metrics as metrics_lib
from digat_tpu_torch.eval.scorer import compute_scores
from digat_tpu_torch.models.model import Model
from digat_tpu_torch.models.nrms import NRMSModel
from digat_tpu_torch.parallel import dist as dist_lib
from digat_tpu_torch.parallel import sharded_table
from digat_tpu_torch.parallel.dist import DistContext
from digat_tpu_torch.runtime import resolve_device
from digat_tpu_torch.train import checkpoint
from digat_tpu_torch.train.trainer import Trainer, get_run_index


def build_model(cfg: Config, word_embedding=None, device=None, dist=None):
    """The DIGAT stack or the NRMS / NRMS-SA stack on `device` (by default
    `cfg.device`), its word table from `word_embedding` where given and
    row-sharded where `dist` has a model axis."""
    family = NRMSModel if cfg.model_family == "nrms" else Model
    return family(cfg, device=cfg.device if device is None else device,
                  word_embedding=word_embedding, dist=dist)


def _single_or(cfg: Config, dist: Optional[DistContext]) -> DistContext:
    """`dist`, or (None) the single-device context on `cfg.device`."""
    return DistContext(device=resolve_device(cfg.device)) if dist is None else dist


def prepare(cfg: Config, dist: Optional[DistContext] = None) -> corpus_lib.Corpus:
    """Data on disk, every cached artifact, the truth files -> the corpus.
    Across ranks rank 0 prepares and the others wait, then each loads."""
    dist = _single_or(cfg, dist)
    if dist.is_main:
        root = os.path.join(cfg.data_root, cfg.dataset)
        if cfg.dataset == "synthetic":
            if not os.path.exists(os.path.join(root, "train", "behaviors.tsv")):
                print(f"[prepare] generating synthetic dataset under {root}", flush=True)
                synthetic.generate(root)
        else:
            prepare_lib.prepare(cfg.dataset, cfg.data_root, cfg.seed)
        corpus_lib.preprocess(cfg, verbose=True)
        write_truth_files(cfg)
    dist.wait_for_main()
    return corpus_lib.Corpus(cfg)


def write_truth_files(cfg: Config) -> None:
    """The official scorer's ground truth under <run_root>/<split>/<dataset>/
    ref/: dev always, test when labeled (MIND-large's test labels are not
    public)."""
    for split in ("dev", "test"):
        if cfg.dataset == "MIND-large" and split == "test":
            continue
        behaviors = os.path.join(cfg.data_root, cfg.dataset, split, "behaviors.tsv")
        ref_dir = os.path.join(cfg.run_root, split, cfg.dataset, "ref")
        path = os.path.join(ref_dir, "truth.txt")
        if os.path.exists(path) or not os.path.exists(behaviors):
            continue
        os.makedirs(ref_dir, exist_ok=True)
        metrics_lib.write_truth_file(behaviors, path)


def _prediction_file(cfg: Config, model_name: str, run_index: int) -> str:
    d = os.path.join(cfg.run_root, "prediction", cfg.dataset, model_name, f"#{run_index}")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, "prediction.txt")


def _zip_prediction(result_file: str) -> str:
    zip_path = os.path.join(os.path.dirname(result_file), "prediction.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        z.write(result_file, "prediction.txt")
    return zip_path


def run_train(cfg: Config, dist: Optional[DistContext] = None) -> dict:
    """Train, then test the best checkpoint. Returns the run's record:
    run_index, run_dir, best_epoch, the epoch records (`Trainer.history`)
    and the test metrics (None for an unlabeled test split). Across ranks
    only rank 0's record has the run's index and directory. Without `dist`,
    one process on `cfg.device`."""
    dist = _single_or(cfg, dist)
    corpus = prepare(cfg, dist)
    model = build_model(cfg, corpus.word_embedding, dist.device, dist)
    results_dir = os.path.join(cfg.run_root, "results", cfg.dataset, model.model_name)
    run_dir = ""
    if dist.is_main:
        cfg.run_index = get_run_index(results_dir)
        run_dir = os.path.join(cfg.run_root, cfg.dataset, model.model_name, f"#{cfg.run_index}")
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())
    trainer = Trainer(model, cfg, corpus, run_dir, results_dir=results_dir, dist=dist)
    history = trainer.train()
    record = {"run_index": cfg.run_index, "run_dir": run_dir, "best_epoch": trainer.best_epoch,
              "history": history, "test": None}
    best = os.path.join(run_dir, "best.ckpt")
    # every rank joins the sharded test, or rank 0 would wait in it alone
    if not dist.broadcast_flag(dist.is_main and os.path.exists(best)):
        return record
    epoch = torch.zeros(1, dtype=torch.int64, device=dist.device)
    if dist.model_world > 1:  # the path on every rank of rank 0's model group
        index = torch.full((1,), cfg.run_index, dtype=torch.int64, device=dist.device)
        dist.broadcast_([index])
        best = os.path.join(cfg.run_root, cfg.dataset, model.model_name, f"#{int(index)}",
                            "best.ckpt")
    if dist.data_rank == 0:  # rank 0 and its model group, on its node
        epoch += checkpoint.load(best, model)
    sharded_table.broadcast_state_(model, dist, [epoch])
    epoch = int(epoch)
    t0 = time.time()
    unlabeled = corpus.test_unlabeled
    result_file = None
    if dist.is_main:
        result_file = (_prediction_file(cfg, model.model_name, cfg.run_index) if unlabeled
                       else os.path.join(run_dir, "test-prediction.txt"))
    auc, mrr, ndcg5, ndcg10 = compute_scores(model, corpus, "test", result_file=result_file,
                                             dist=dist)
    if not dist.is_main:
        record["test"] = None if unlabeled else (auc, mrr, ndcg5, ndcg10)
        return record
    if unlabeled:
        print(f"[test] epoch {epoch}: unlabeled split - wrote leaderboard submission "
              f"{_zip_prediction(result_file)} ({time.time() - t0:.1f}s)", flush=True)
        return record
    print(f"[test] epoch {epoch}: AUC={auc:.4f} MRR={mrr:.4f} nDCG@5={ndcg5:.4f} "
          f"nDCG@10={ndcg10:.4f} ({time.time() - t0:.1f}s)", flush=True)
    with open(os.path.join(results_dir, f"#{cfg.run_index}-test"), "w") as f:
        f.write(f"#{cfg.run_index}\t{auc}\t{mrr}\t{ndcg5}\t{ndcg10}\n")
    record["test"] = (auc, mrr, ndcg5, ndcg10)
    return record


def run_eval(cfg: Config, mode: str, dist: Optional[DistContext] = None) -> tuple:
    """Score the checkpoint `--{mode}_model_path` on that split -> (auc, mrr,
    ndcg5, ndcg10); MIND-large's test split writes the leaderboard zip.
    Across ranks every rank loads the checkpoint and scores its share, and
    rank 0 writes and reports. Without `dist`, one process on `cfg.device`."""
    path = cfg.dev_model_path if mode == "dev" else cfg.test_model_path
    if not path:
        raise ValueError(f"--{mode}_model_path required")
    dist = _single_or(cfg, dist)
    corpus = prepare(cfg, dist)
    model = build_model(cfg, corpus.word_embedding, dist.device, dist)
    epoch = checkpoint.load(path, model)
    t0 = time.time()
    out = cfg.test_output_file or None
    large_test = cfg.dataset == "MIND-large" and mode == "test"
    if large_test and not out and dist.is_main:
        out = _prediction_file(cfg, model.model_name, cfg.run_index)
    metrics = compute_scores(model, corpus, mode, result_file=out if dist.is_main else None,
                             dist=dist)
    if not dist.is_main:
        return metrics
    if large_test:
        print(f"[test] wrote leaderboard submission {_zip_prediction(out)} "
              f"({time.time() - t0:.1f}s)", flush=True)
        return metrics
    auc, mrr, ndcg5, ndcg10 = metrics
    print(f"[{mode}] epoch {epoch}: AUC={auc:.4f} MRR={mrr:.4f} nDCG@5={ndcg5:.4f} "
          f"nDCG@10={ndcg10:.4f} ({time.time() - t0:.1f}s)", flush=True)
    return metrics


def main(argv=None):
    cfg = Config.from_args(argv)
    dist = dist_lib.init_distributed(cfg)  # before any other device use
    try:
        dist_lib.build_kernels(dist)
        if cfg.mode == "train":
            return run_train(cfg, dist)
        return run_eval(cfg, cfg.mode, dist)
    finally:
        dist_lib.destroy(dist)


if __name__ == "__main__":
    main(sys.argv[1:])
