"""Tracing and per-step timing.

Counterpart of `digat_tpu.utils.profiling`:

  * `StepTimer`: per-step durations with mean, median and p95 summaries,
    the first `warmup` steps left out;
  * `trace`: `torch.profiler` over the CPU and, where there is one, CUDA,
    for the block, writing a Chrome trace (`*.pt.trace.json`, for
    Perfetto or TensorBoard) into a directory; a no-op when the directory
    is empty (`Config.profile_dir`, which the trainer traces over steps
    10-20 of epoch 1);
  * `annotate`: a named span in that trace (`torch.profiler.record_function`).

A CUDA launch returns before the device finishes, so `StepTimer.step`
around one measures the host's side; the trainer feeds it the CUDA-event
times of its steps instead (`add`)."""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


class StepTimer:
    """Collects per-step durations; skips the first `warmup` steps."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.durations: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if self._t0 is None:
            return
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.add(dt)

    def add(self, seconds: float) -> None:
        """One step's duration, measured elsewhere."""
        self._seen += 1
        if self._seen > self.warmup:
            self.durations.append(seconds)

    @contextlib.contextmanager
    def step(self):
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        if not self.durations:
            return {"steps": 0}
        d = np.asarray(self.durations)
        return {
            "steps": int(len(d)),
            "mean_ms": float(d.mean() * 1e3),
            "median_ms": float(np.median(d) * 1e3),
            "p95_ms": float(np.percentile(d, 95) * 1e3),
            "steps_per_s": float(1.0 / d.mean()),
        }


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """torch.profiler over the block, its Chrome trace written into
    `log_dir` when the block ends; a no-op when `log_dir` is empty."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """A named span in the trace of an enclosing `trace`."""
    return torch.profiler.record_function(name)
