"""The cores a run keeps to.  Imports nothing but the standard library, so
that ``run.py`` can pin the process before torch starts its threads."""

from __future__ import annotations

import os

PIN_ENV = "PORTBENCH_PIN"  # cores to keep to; 0 leaves the process unpinned
PIN_DEFAULT = 2  # the Python thread and the autograd engine's device thread


def pin_cores(n=None) -> list:
    """Keep this process, and the threads it starts later, to the last
    ``n`` cores that it may use: a run that stays on the same cores does
    not migrate between them.  Returns the cores, or [] unpinned."""
    n = int(os.environ.get(PIN_ENV, PIN_DEFAULT) if n is None else n)
    if n <= 0 or not hasattr(os, "sched_setaffinity"):
        return []
    cores = sorted(os.sched_getaffinity(0))[-n:]
    os.sched_setaffinity(0, cores)
    return cores
