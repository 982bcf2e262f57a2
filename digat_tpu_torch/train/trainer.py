"""Training orchestration on one device.

Counterpart of `digat_tpu.train.trainer.Trainer.train` with the
reference's protocol: per-epoch negative re-sampling, shuffled batches
with unique-title dedup (capacity sized from a sample of batches unless
the configuration fixes it), lr/10 from the decay epoch, the listwise
loss, dev scoring after each epoch through the two-stage `CachedScorer`,
the best checkpoint by the configured criterion, early stopping after
`early_stopping_epoch` stale epochs, and `resume` from a checkpoint.
Batches are assembled on a background thread and copied to the device
from pinned memory (`data.batching.Prefetcher`).

The model is a `Model` (MSA-DIGAT) or an `NRMSModel`. The NRMS family takes
`nrms_tables()` and plain batches (no dedup), as the JAX trainer does; the
rest of the epoch loop is the same for both.

The corpus is any object with the fields the JAX package's `Corpus` has
for this: `tables()` (the five `CorpusTables` arrays) or, for the NRMS
family, `nrms_tables()` (the three `NRMSTables` arrays), `news_node_id`,
`splits["train"]` and `splits["dev"]` (`history_idx`, `cat_idx`),
`train_behavior_row`, `train_pos`, `train_neg_flat`, `train_neg_offsets`,
and `dev_imp_index`, `dev_cand`, `dev_labels`: `data.corpus.Corpus` builds
one from MIND-layout files.

Each epoch's record in `history` holds its loss, the loss of every step,
each step's time (CUDA events on the card, host clock on the CPU), the
count of batches that overflowed the dedup capacity, and the dev metrics."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from digat_tpu_torch.config import Config
from digat_tpu_torch.data import batching, sampling
from digat_tpu_torch.eval import metrics as M
from digat_tpu_torch.eval.scorer import compute_scores
from digat_tpu_torch.models.model import CorpusTables, DedupTrainBatch
from digat_tpu_torch.models.nrms import NRMSTables
from digat_tpu_torch.train import checkpoint
from digat_tpu_torch.train.optimizer import Adam, lr_at_epoch
from digat_tpu_torch.train.train_step import step_seed, train_step


def get_run_index(results_dir: str) -> int:
    """The next run index #N: one past the largest `#N-dev` file under
    `results_dir`, whose empty `#N-dev` it writes to claim the index."""
    os.makedirs(results_dir, exist_ok=True)
    max_index = 0
    for name in os.listdir(results_dir):
        name = name.strip()
        if name.startswith("#") and name.endswith("-dev"):
            try:
                max_index = max(max_index, int(name[1:-4]))
            except ValueError:
                pass
    open(os.path.join(results_dir, f"#{max_index + 1}-dev"), "w").close()
    return max_index + 1


class Trainer:
    """`run_dir` receives the checkpoints, the dev rank files and the dev
    log; with `results_dir` the best epoch's dev metrics also go to
    `<results_dir>/#<config.run_index>-dev`, as the JAX trainer writes them."""

    def __init__(self, model, config: Config, corpus, run_dir: str,
                 verbose: bool = True, results_dir: str = ""):
        self.model = model
        self.config = config
        self.corpus = corpus
        self.run_dir = run_dir
        self.results_dir = results_dir
        self.verbose = verbose
        self.optimizer = Adam(model.named_parameters(), config.weight_decay,
                              config.gradient_clip_norm)
        self.history: list = []
        self.best_epoch = 0
        os.makedirs(run_dir, exist_ok=True)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)

    def _criterion(self, metrics) -> float:
        auc, mrr, ndcg5, ndcg10 = metrics
        return {"auc": auc, "mrr": mrr, "ndcg5": ndcg5, "ndcg10": ndcg10,
                "avg": M.avg_metric(auc, mrr, ndcg5, ndcg10)}[self.config.dev_criterion]

    def dedup_capacity(self) -> int:
        """Unique-title capacity of a training batch (0: dedup off; always
        off for the NRMS family)."""
        cfg, corpus = self.config, self.corpus
        if self.nrms:
            return 0
        if cfg.dedup_titles >= 0:
            return cfg.dedup_titles
        probe = sampling.sample_negatives(corpus.train_neg_flat, corpus.train_neg_offsets,
                                          cfg.negative_sample_num,
                                          np.random.default_rng(cfg.seed))
        return batching.estimate_dedup_capacity(
            corpus.splits["train"].history_idx, corpus.train_behavior_row, corpus.train_pos,
            probe, corpus.news_node_id, cfg.batch_size, seed=cfg.seed)

    @property
    def nrms(self) -> bool:
        return getattr(self.model, "family", "digat") == "nrms"

    def train_epoch(self, epoch: int, tables, dedup: int) -> dict:
        """One pass over the training samples -> the epoch's record."""
        cfg, corpus, model = self.config, self.corpus, self.model
        negatives = sampling.sample_negatives(
            corpus.train_neg_flat, corpus.train_neg_offsets, cfg.negative_sample_num,
            np.random.default_rng(cfg.seed * 1_000_003 + epoch))
        lr = lr_at_epoch(cfg.lr, epoch, cfg.lr_decay_epoch)
        split = corpus.splits["train"]
        it = batching.train_batches(
            split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos,
            negatives, cfg.batch_size, epoch_seed=cfg.seed * 7_000_003 + epoch,
            news_node_id=corpus.news_node_id if dedup else None, dedup_titles=dedup)
        cuda = model.device.type == "cuda"
        losses, marks, overflow = [], [], 0
        t0 = time.perf_counter()
        prefetcher = batching.Prefetcher(it, model.device)
        try:
            for step, batch in enumerate(prefetcher):
                overflow += dedup > 0 and not isinstance(batch, DedupTrainBatch)
                start = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
                if cuda:
                    start.record()
                losses.append(train_step(model, self.optimizer, tables, batch,
                                         step_seed(cfg.seed, epoch, step), lr))
                if cuda:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    marks.append((start, end))
                else:
                    marks.append((start, time.perf_counter()))
        finally:
            prefetcher.close()
        step_losses = torch.stack(losses).tolist() if losses else []  # waits for the device
        wall = time.perf_counter() - t0
        step_ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
        return {"epoch": epoch, "lr": lr, "loss": float(np.mean(step_losses)) if losses else 0.0,
                "step_losses": step_losses, "step_ms": step_ms, "overflow_batches": overflow,
                "wall_s": wall, "samples_per_s": len(losses) * cfg.batch_size / wall}

    def train(self):
        """The epoch loop; returns the epoch records (also in `history`)."""
        cfg, model = self.config, self.model
        start_epoch = 1
        if cfg.resume:
            start_epoch = checkpoint.load(cfg.resume, model, self.optimizer) + 1
            self._log(f"[resume] {cfg.resume} -> continuing at epoch {start_epoch}")
        if self.nrms:
            tables = NRMSTables.from_arrays(self.corpus.nrms_tables(), model.device)
        else:
            tables = CorpusTables.from_arrays(self.corpus.tables(), model.device)
        dedup = self.dedup_capacity()
        self._log(f"[dedup] unique-title capacity = {dedup}")
        best, stale = -1.0, 0
        for epoch in range(start_epoch, cfg.epoch + 1):
            rec = self.train_epoch(epoch, tables, dedup)
            rank_file = os.path.join(self.run_dir, f"dev-epoch{epoch}.txt")
            metrics = compute_scores(model, self.corpus, "dev", result_file=rank_file)
            rec.update(zip(("auc", "mrr", "ndcg5", "ndcg10"), metrics))
            self.history.append(rec)
            self._log(f"Epoch {epoch}: loss={rec['loss']:.4f} steps={len(rec['step_losses'])} "
                      f"{rec['wall_s']:.1f}s lr={rec['lr']:g} {rec['samples_per_s']:.1f} "
                      f"samples/s | dev AUC={metrics[0]:.4f} MRR={metrics[1]:.4f} "
                      f"nDCG@5={metrics[2]:.4f} nDCG@10={metrics[3]:.4f}")
            crit = self._criterion(metrics)
            if crit >= best:
                best, stale, self.best_epoch = crit, 0, epoch
                if self.results_dir:
                    with open(os.path.join(self.results_dir, f"#{cfg.run_index}-dev"), "w") as f:
                        f.write(f"#{cfg.run_index}\t" + "\t".join(map(str, metrics)) + "\n")
                checkpoint.save(os.path.join(self.run_dir, "best.ckpt"), model, self.optimizer,
                                epoch)
            else:
                stale += 1
            if stale > cfg.early_stopping_epoch:
                self._log(f"Early stop at epoch {epoch} (best {self.best_epoch})")
                break
        with open(os.path.join(self.run_dir, "dev_log.txt"), "w", encoding="utf-8") as f:
            f.write("Epoch\tAUC\tMRR\tnDCG@5\tnDCG@10\n")
            for h in self.history:
                f.write("%d\t%.4f\t%.4f\t%.4f\t%.4f\n"
                        % (h["epoch"], h["auc"], h["mrr"], h["ndcg5"], h["ndcg10"]))
            f.write(f"Best dev epoch : {self.best_epoch}\n")
        return self.history
