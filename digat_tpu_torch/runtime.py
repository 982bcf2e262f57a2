"""Device selection and numeric settings shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no CUDA present this raises instead of falling
    back to the CPU, so a run that was meant for the card never measures the
    host by accident."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "digat_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def exact_fp32() -> None:
    """Keep fp32 products in full fp32 (no TF32) for matmul and cuDNN, so the
    plain path is held against the kernels and the JAX CPU reference at fp32
    accuracy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
