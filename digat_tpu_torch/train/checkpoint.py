"""Checkpoints: model, optimizer state and epoch, resumable.

Counterpart of `digat_tpu.train.checkpoint`. The whole training state goes
into one file, written to a temporary name and then renamed, so a run that
is killed mid-write leaves the previous checkpoint whole.

The file holds the whole word table and its moments whatever the grid: a
model whose table is row-sharded (`--mesh_model` M > 1) gathers them over
its model group before the write (so every rank of that group calls
`save`, and rank 0 alone writes), and `load` keeps each rank's rows. A
checkpoint written at M 2 resumes at M 1 and the other way round."""

from __future__ import annotations

import os
from typing import Optional

import torch

from torch import nn

from digat_tpu_torch.parallel import sharded_table
from digat_tpu_torch.train.optimizer import Adam


def save(path: str, model: nn.Module, optimizer: Adam, epoch: int, write: bool = True) -> None:
    """Write the training state to `path` where `write`; a model with table
    shards gathers them first, on every rank of its model group, whether it
    writes or not."""
    if not (write or sharded_table.tables(model)):
        return
    state = {"model": sharded_table.full_state_dict(model),
             "optimizer": optimizer.state_dict(), "epoch": epoch}
    if not write:
        return
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load(path: str, model: nn.Module, optimizer: Optional[Adam] = None) -> int:
    """Restore `model` and, if given, `optimizer` in place (a sharded table
    keeps its rows); returns the epoch saved."""
    state = torch.load(path, map_location=model.device, weights_only=True)
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
