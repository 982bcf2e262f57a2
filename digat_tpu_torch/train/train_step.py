"""One training step: listwise loss, backward, clip, Adam.

Counterpart of `digat_tpu.train.train_step`: `make_train_step` on one
device, and `make_shardmap_train_step` across ranks. PyTorch runs eagerly,
so there is nothing to compile: the step is a function. The learning rate
is an argument, so the lr/10 decay needs no second step. Each step's
dropout seed is derived from (seed, epoch, step) as the JAX trainer folds
`epoch * 1_000_000 + step` into its key, and across more than one data
index that index as well, as the JAX data-parallel step folds in its axis
index (the rank itself where there is no model axis; the ranks of a model
group draw the same masks). At
`compute_dtype` bfloat16 the loss runs on the model's bf16 compute copy and
the gradients, their all-reduce, clip and Adam act on the fp32 masters.

Across ranks (a `parallel.dist.DistContext` with a process group) the loss
is the global weighted mean, as JAX's `psum(num) / max(psum(den), 1)`:
each rank's batch weights are summed over the ranks before the forward,
the local loss is num_local / max(den, 1), and after the backward every
gradient (and the local loss) is summed over the ranks in one flat
`all_reduce` before the optimizer clips and steps. A mean of per-rank means
(DDP's averaging) would differ wherever a rank holds weight-0 tail rows.

On a grid with a model axis (`--mesh_model` M > 1) these sums run over
the data group alone: the ranks of a model group hold the same batch rows
and the same replicated weights, each with its own rows of the word table
(`parallel.sharded_table`), so a sum over the world would count each row
M times. The optimizer then adds the table shards' squared sums over the
model group to the clip norm."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from digat_tpu_torch.train.optimizer import Adam


def step_seed(seed: int, epoch: int, step: int, rank: Optional[int] = None) -> int:
    """The 32-bit dropout seed of a training step (of one data index, where
    `rank` is given)."""
    key = [seed, epoch * 1_000_000 + step] + ([] if rank is None else [rank])
    return int(np.random.SeedSequence(key).generate_state(1)[0])


def seed_index(dist) -> Optional[int]:
    """The index a step's dropout seed folds in across ranks (`step_seed`'s
    `rank`): the data index where there is more than one, else None."""
    if dist is None or dist.data_world == 1:
        return None
    return dist.data_rank


def train_step(model, optimizer: Adam, tables, batch, seed: int, lr: float,
               dist=None) -> torch.Tensor:
    """Loss, gradients, clip and Adam update in place, for a `Model` with
    its `CorpusTables` or an `NRMSModel` with its `NRMSTables`; returns the
    loss (a 0-d tensor on the model's device; reading it waits for the
    step). With `dist` active, `batch` is this rank's rows and the loss is
    the global one, the same on every rank."""
    optimizer.zero_grad()
    if dist is None or not dist.active:
        loss = model.loss(tables, batch, seed)
        loss.backward()
        optimizer.step(lr)
        return loss.detach()
    den = batch.weight.sum(dtype=torch.float64).reshape(1)
    dist.all_reduce_sum_([den], group=dist.data_group)
    num, _ = model.loss_parts(tables, batch, seed)
    loss = num / den[0].to(num.dtype).clamp(min=1.0)
    loss.backward()
    for p in optimizer.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in optimizer.params]
    total = loss.detach().to(grads[0].dtype).reshape(1)
    dist.all_reduce_sum_(grads + [total], group=dist.data_group)
    optimizer.step(lr)
    return total[0]
