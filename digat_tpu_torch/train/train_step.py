"""One training step: listwise loss, backward, clip, Adam.

Counterpart of `digat_tpu.train.train_step.make_train_step` on one device.
PyTorch runs eagerly, so there is nothing to compile: the step is a
function. The learning rate is an argument, so the lr/10 decay needs no
second step. Each step's dropout seed is derived from (seed, epoch, step)
as the JAX trainer folds `epoch * 1_000_000 + step` into its key."""

from __future__ import annotations

import numpy as np
import torch

from digat_tpu_torch.train.optimizer import Adam


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The 32-bit dropout seed of a training step."""
    return int(np.random.SeedSequence([seed, epoch * 1_000_000 + step]).generate_state(1)[0])


def train_step(model, optimizer: Adam, tables, batch, seed: int, lr: float) -> torch.Tensor:
    """Loss, gradients, clip and Adam update in place, for a `Model` with
    its `CorpusTables` or an `NRMSModel` with its `NRMSTables`; returns the
    loss (a 0-d tensor on the model's device; reading it waits for the
    step)."""
    optimizer.zero_grad()
    loss = model.loss(tables, batch, seed)
    loss.backward()
    optimizer.step(lr)
    return loss.detach()
