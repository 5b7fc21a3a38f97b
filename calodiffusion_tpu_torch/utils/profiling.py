"""Profiling utilities (port of ``calodiffusion_tpu/utils/profiling.py``):

- ``trace(logdir)``: a ``torch.profiler`` trace of the card and the host
  into ``logdir`` in TensorBoard's format (no-op when logdir is falsy);
- ``annotate(name)``: a named trace region (``record_function``);
- ``StepTimer``: per-phase wall-clock aggregation for the trainer (data /
  host->device / step), printed per epoch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a trace of the host and, where there is one, the CUDA card
    into ``logdir`` (a ``*.pt.trace.json`` a process; no-op when logdir is
    falsy)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Accumulates wall-clock per named phase; ``summary()`` resets."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self, reset: bool = True) -> str:
        parts = [
            f"{k}: {self.totals[k]:.2f}s/{self.counts[k]}"
            for k in sorted(self.totals)
        ]
        out = " | ".join(parts)
        if reset:
            self.totals.clear()
            self.counts.clear()
        return out
