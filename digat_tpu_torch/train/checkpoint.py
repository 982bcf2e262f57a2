"""Checkpoints: model, optimizer state and epoch, resumable.

Counterpart of `digat_tpu.train.checkpoint`. The whole training state goes
into one file, written to a temporary name and then renamed, so a run that
is killed mid-write leaves the previous checkpoint whole."""

from __future__ import annotations

import os

import torch

from torch import nn

from digat_tpu_torch.train.optimizer import Adam


def save(path: str, model: nn.Module, optimizer: Adam, epoch: int) -> None:
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "epoch": epoch}
    tmp = f"{path}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load(path: str, model: nn.Module, optimizer: Adam) -> int:
    """Restore `model` and `optimizer` in place; returns the epoch saved."""
    state = torch.load(path, map_location=model.device, weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return int(state["epoch"])
