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

One process on one device: CUDA unless `--device cpu`. `--compute_dtype
bfloat16` trains and scores MSA-DIGAT and its ablations on bf16 compute
copies of the fp32 weights (`models.model.Model.compute_params`); the
checkpoints hold the fp32 masters.

    python -m digat_tpu_torch.cli --dataset synthetic --device cpu --epoch 2
"""

from __future__ import annotations

import os
import sys
import time
import zipfile

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import corpus as corpus_lib
from digat_tpu_torch.data import prepare as prepare_lib
from digat_tpu_torch.data import synthetic
from digat_tpu_torch.eval import metrics as metrics_lib
from digat_tpu_torch.eval.scorer import compute_scores
from digat_tpu_torch.models.model import Model
from digat_tpu_torch.models.nrms import NRMSModel
from digat_tpu_torch.train import checkpoint
from digat_tpu_torch.train.trainer import Trainer, get_run_index


def build_model(cfg: Config, word_embedding=None):
    """The DIGAT stack or the NRMS / NRMS-SA stack on `cfg.device`, its word
    table from `word_embedding` where given."""
    family = NRMSModel if cfg.model_family == "nrms" else Model
    return family(cfg, device=cfg.device, word_embedding=word_embedding)


def prepare(cfg: Config) -> corpus_lib.Corpus:
    """Data on disk, every cached artifact, the truth files -> the corpus."""
    root = os.path.join(cfg.data_root, cfg.dataset)
    if cfg.dataset == "synthetic":
        if not os.path.exists(os.path.join(root, "train", "behaviors.tsv")):
            print(f"[prepare] generating synthetic dataset under {root}", flush=True)
            synthetic.generate(root)
    else:
        prepare_lib.prepare(cfg.dataset, cfg.data_root, cfg.seed)
    corpus_lib.preprocess(cfg, verbose=True)
    write_truth_files(cfg)
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


def run_train(cfg: Config) -> dict:
    """Train, then test the best checkpoint. Returns the run's record:
    run_index, run_dir, best_epoch, the epoch records (`Trainer.history`)
    and the test metrics (None for an unlabeled test split)."""
    corpus = prepare(cfg)
    model = build_model(cfg, corpus.word_embedding)
    results_dir = os.path.join(cfg.run_root, "results", cfg.dataset, model.model_name)
    cfg.run_index = get_run_index(results_dir)
    run_dir = os.path.join(cfg.run_root, cfg.dataset, model.model_name, f"#{cfg.run_index}")
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    trainer = Trainer(model, cfg, corpus, run_dir, results_dir=results_dir)
    history = trainer.train()
    record = {"run_index": cfg.run_index, "run_dir": run_dir, "best_epoch": trainer.best_epoch,
              "history": history, "test": None}
    best = os.path.join(run_dir, "best.ckpt")
    if not os.path.exists(best):
        return record
    epoch = checkpoint.load(best, model)
    t0 = time.time()
    unlabeled = corpus.test_unlabeled
    result_file = (_prediction_file(cfg, model.model_name, cfg.run_index) if unlabeled
                   else os.path.join(run_dir, "test-prediction.txt"))
    auc, mrr, ndcg5, ndcg10 = compute_scores(model, corpus, "test", result_file=result_file)
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


def run_eval(cfg: Config, mode: str) -> tuple:
    """Score the checkpoint `--{mode}_model_path` on that split -> (auc, mrr,
    ndcg5, ndcg10); MIND-large's test split writes the leaderboard zip."""
    path = cfg.dev_model_path if mode == "dev" else cfg.test_model_path
    if not path:
        raise ValueError(f"--{mode}_model_path required")
    corpus = prepare(cfg)
    model = build_model(cfg, corpus.word_embedding)
    epoch = checkpoint.load(path, model)
    t0 = time.time()
    out = cfg.test_output_file or None
    large_test = cfg.dataset == "MIND-large" and mode == "test"
    if large_test and not out:
        out = _prediction_file(cfg, model.model_name, cfg.run_index)
    metrics = compute_scores(model, corpus, mode, result_file=out)
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
    if cfg.mode == "train":
        return run_train(cfg)
    return run_eval(cfg, cfg.mode)


if __name__ == "__main__":
    main(sys.argv[1:])
