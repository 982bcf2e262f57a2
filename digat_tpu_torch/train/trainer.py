"""Training orchestration, on one device or across ranks.

Counterpart of `digat_tpu.train.trainer.Trainer.train` with the
reference's protocol: per-epoch negative re-sampling, shuffled batches
with unique-title dedup (capacity sized from a sample of batches unless
the configuration fixes it), lr/10 from the decay epoch, the listwise
loss, dev scoring after each epoch through the two-stage `CachedScorer`,
the best checkpoint by the configured criterion, early stopping after
`early_stopping_epoch` stale epochs, and `resume` from a checkpoint.
Batches are assembled on a background thread and copied to the device
from pinned memory (`data.batching.Prefetcher`).

Across ranks (`dist`, a `parallel.dist.DistContext` with a process group),
the JAX package's single-host data-parallel layout: every rank of a node
runs the node's batch iterator (the same epoch seed, samples strided
across nodes) and keeps its contiguous row group of each batch, rows
[r B/S, (r+1) B/S) for local rank r of S, deduplicated per shard
(`batching.rank_rows`; an overflowing shard sends every shard the plain
rows); the dedup capacity is sized for B/S rows. The step sums the
gradients over the ranks (`train.train_step`), so the weights stay equal
on every rank; they start equal from rank 0's. Every rank scores dev
through the sharded scorer; rank 0 alone writes the checkpoint, the
`#N-dev` file, the rank files and `dev_log.txt`, and its early-stop
decision is broadcast. `resume` loads on every rank.

On a grid with a model axis (`--mesh_model` M > 1; the model built with
the same `dist`, its word table row-sharded) the row groups go by data
index: the M ranks of a model group take the same rows (their node's
local data index of local_world / M), the step's seed folds in the data
index, the optimizer keeps the moments of the rank's table rows alone, and
every rank of rank 0's model group joins the gather of each checkpoint,
which holds the whole table. Samples/s counts each global batch once.

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
each step's time (CUDA events on the card, host clock on the CPU) and
their `utils.profiling.StepTimer` summary, the count of batches that
overflowed the dedup capacity, and the dev metrics. With
`config.profile_dir` set, steps 10-20 of epoch 1 are traced into it
(`utils.profiling.trace`), each step a `train_step` span."""

from __future__ import annotations

import contextlib
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
from digat_tpu_torch.parallel import sharded_table
from digat_tpu_torch.parallel.dist import DistContext
from digat_tpu_torch.train import checkpoint
from digat_tpu_torch.train.optimizer import Adam, lr_at_epoch
from digat_tpu_torch.train.train_step import seed_index, step_seed, train_step
from digat_tpu_torch.utils import profiling

PROFILE_STEPS = (10, 20)  # the steps of epoch 1 that `profile_dir` traces


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
    `<results_dir>/#<config.run_index>-dev`, as the JAX trainer writes them.
    Across ranks (`dist`) only rank 0 writes, and the other ranks' `run_dir`
    is not read; every rank logs, its lines tagged with its rank."""

    def __init__(self, model, config: Config, corpus, run_dir: str,
                 verbose: bool = True, results_dir: str = "",
                 dist: DistContext = DistContext()):
        self.model = model
        self.config = config
        self.corpus = corpus
        self.run_dir = run_dir
        self.results_dir = results_dir
        self.dist = dist
        self.verbose = verbose
        if config.batch_size % dist.local_data_world:
            raise ValueError(f"batch_size {config.batch_size} does not split over the "
                             f"{dist.local_data_world} data indices of a node")
        self.optimizer = Adam(model.named_parameters(), config.weight_decay,
                              config.gradient_clip_norm, shards=sharded_table.tables(model))
        self.history: list = []
        self.best_epoch = 0
        if dist.is_main:
            os.makedirs(run_dir, exist_ok=True)

    def _log(self, msg: str) -> None:
        """Print `msg`; across ranks every rank prints, each line tagged."""
        if self.verbose:
            tag = f"[rank {self.dist.rank}/{self.dist.world}] " if self.dist.world > 1 else ""
            print(tag + msg, flush=True)

    def _criterion(self, metrics) -> float:
        auc, mrr, ndcg5, ndcg10 = metrics
        return {"auc": auc, "mrr": mrr, "ndcg5": ndcg5, "ndcg10": ndcg10,
                "avg": M.avg_metric(auc, mrr, ndcg5, ndcg10)}[self.config.dev_criterion]

    def dedup_capacity(self) -> int:
        """Unique-title capacity of one rank's rows of a training batch (0:
        dedup off; always off for the NRMS family)."""
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
            probe, corpus.news_node_id, cfg.batch_size // self.dist.local_data_world,
            seed=cfg.seed)

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
        split, dist = corpus.splits["train"], self.dist
        it = batching.train_batches(
            split.history_idx, split.cat_idx, corpus.train_behavior_row, corpus.train_pos,
            negatives, cfg.batch_size, epoch_seed=cfg.seed * 7_000_003 + epoch,
            shard_index=dist.node, shard_count=dist.nodes)
        rows = (batching.rank_rows(b, dist.local_data_rank, dist.local_data_world,
                                   corpus.news_node_id, dedup) for b in it)
        rank = seed_index(dist)
        cuda = model.device.type == "cuda"
        losses, marks, overflow = [], [], 0
        profile = contextlib.ExitStack() if cfg.profile_dir and epoch == 1 else None
        t0 = time.perf_counter()
        prefetcher = batching.Prefetcher(rows, model.device)
        try:
            for step, batch in enumerate(prefetcher):
                if profile is not None and step == PROFILE_STEPS[0]:
                    profile.enter_context(profiling.trace(cfg.profile_dir))
                overflow += dedup > 0 and not isinstance(batch, DedupTrainBatch)
                start = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
                if cuda:
                    start.record()
                traced = profile is not None and PROFILE_STEPS[0] <= step < PROFILE_STEPS[1]
                with profiling.annotate("train_step") if traced else contextlib.nullcontext():
                    losses.append(train_step(model, self.optimizer, tables, batch,
                                             step_seed(cfg.seed, epoch, step, rank), lr, dist))
                if cuda:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    marks.append((start, end))
                else:
                    marks.append((start, time.perf_counter()))
                if profile is not None and step + 1 == PROFILE_STEPS[1]:
                    profile.close()
        finally:
            prefetcher.close()
            if profile is not None:
                profile.close()
        step_losses = torch.stack(losses).tolist() if losses else []  # waits for the device
        wall = time.perf_counter() - t0
        step_ms = [s.elapsed_time(e) if cuda else (e - s) * 1e3 for s, e in marks]
        timer = profiling.StepTimer(warmup=2)
        for ms in step_ms:
            timer.add(ms / 1e3)
        return {"epoch": epoch, "lr": lr, "loss": float(np.mean(step_losses)) if losses else 0.0,
                "step_losses": step_losses, "step_ms": step_ms, "steps": timer.summary(),
                "overflow_batches": overflow, "wall_s": wall,
                "samples_per_s": len(losses) * cfg.batch_size * dist.nodes / wall}

    def train(self):
        """The epoch loop; returns the epoch records (also in `history`)."""
        cfg, model, dist = self.config, self.model, self.dist
        start_epoch = 1
        if cfg.resume:
            start_epoch = checkpoint.load(cfg.resume, model, self.optimizer) + 1
            self._log(f"[resume] {cfg.resume} -> continuing at epoch {start_epoch}")
        sharded_table.broadcast_state_(model, dist)  # rank 0's weights everywhere
        if self.nrms:
            tables = NRMSTables.from_arrays(self.corpus.nrms_tables(), model.device)
        else:
            tables = CorpusTables.from_arrays(self.corpus.tables(), model.device)
        dedup = self.dedup_capacity()
        self._log(f"[dedup] unique-title capacity = {dedup}")
        best, stale = -1.0, 0
        for epoch in range(start_epoch, cfg.epoch + 1):
            rec = self.train_epoch(epoch, tables, dedup)
            rank_file = (os.path.join(self.run_dir, f"dev-epoch{epoch}.txt") if dist.is_main
                         else None)
            metrics = compute_scores(model, self.corpus, "dev", result_file=rank_file, dist=dist)
            rec.update(zip(("auc", "mrr", "ndcg5", "ndcg10"), metrics))
            self.history.append(rec)
            self._log(f"Epoch {epoch}: loss={rec['loss']:.4f} steps={len(rec['step_losses'])} "
                      f"{rec['wall_s']:.1f}s lr={rec['lr']:g} {rec['samples_per_s']:.1f} "
                      f"samples/s | dev AUC={metrics[0]:.4f} MRR={metrics[1]:.4f} "
                      f"nDCG@5={metrics[2]:.4f} nDCG@10={metrics[3]:.4f}")
            crit = self._criterion(metrics)
            if crit >= best:
                best, stale, self.best_epoch = crit, 0, epoch
                if self.results_dir and dist.is_main:
                    with open(os.path.join(self.results_dir, f"#{cfg.run_index}-dev"), "w") as f:
                        f.write(f"#{cfg.run_index}\t" + "\t".join(map(str, metrics)) + "\n")
                checkpoint.save(os.path.join(self.run_dir, "best.ckpt"), model,
                                self.optimizer, epoch, write=dist.is_main)
            else:
                stale += 1
            # rank 0's decision on every rank: none breaks out of the loop alone
            if dist.broadcast_flag(stale > cfg.early_stopping_epoch):
                self._log(f"Early stop at epoch {epoch} (best {self.best_epoch})")
                break
        if dist.is_main:
            with open(os.path.join(self.run_dir, "dev_log.txt"), "w", encoding="utf-8") as f:
                f.write("Epoch\tAUC\tMRR\tnDCG@5\tnDCG@10\n")
                for h in self.history:
                    f.write("%d\t%.4f\t%.4f\t%.4f\t%.4f\n"
                            % (h["epoch"], h["auc"], h["mrr"], h["ndcg5"], h["ndcg10"]))
                f.write(f"Best dev epoch : {self.best_epoch}\n")
        return self.history
