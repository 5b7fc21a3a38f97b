"""A run keeps to fixed cores, or to none where asked."""

from __future__ import annotations

import os

import pytest

from portbench import host


def test_pinning_keeps_to_the_last_allowed_cores_and_can_be_left_off(monkeypatch):
    if not hasattr(os, "sched_setaffinity"):
        pytest.skip("no CPU affinity on this system")
    saved = os.sched_getaffinity(0)
    try:
        monkeypatch.setenv(host.PIN_ENV, "0")
        assert host.pin_cores() == [] and os.sched_getaffinity(0) == saved
        monkeypatch.setenv(host.PIN_ENV, "1")
        cores = host.pin_cores()
        assert cores == sorted(saved)[-1:] and os.sched_getaffinity(0) == set(cores)
    finally:
        os.sched_setaffinity(0, saved)
