"""Profiling utilities: ``StepTimer``, per-phase wall-clock aggregation for
the trainer (data / host->device / step), printed per epoch.

A copy of ``StepTimer`` from ``calodiffusion_tpu/utils/profiling.py``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


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
