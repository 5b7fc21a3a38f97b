"""The reduction of a profiler trace: the idle share from the union of the
device intervals, kernels to ranges by correlation, the breakdown."""

from __future__ import annotations

import pytest

from portbench.trace import ATTN, CONV, Span, TracedSpans, reduce_events


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_idle_is_the_complement_of_the_union_and_kernels_go_to_their_range():
    events = [
        _ev("user_annotation", CONV, 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 4, 1, corr=2),
        _ev("user_annotation", ATTN, 20, 10),
        _ev("cuda_driver", "cuLaunchKernelEx", 22, 1, corr=3),
        _ev("cpu_op", "aten::copy_", 150, 40),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=4),
        # two overlapping kernels in the conv range: busy 100..130, not 50
        _ev("kernel", "conv_a", 100, 30, corr=1),
        _ev("kernel", "conv_b", 105, 20, corr=2),
        _ev("kernel", "k1", 150, 10, corr=3),
        _ev("kernel", "elementwise", 200, 20, corr=4),
        # launched before the span: counts as busy, belongs to no range
        _ev("kernel", "earlier", 90, 5, corr=99),
    ]
    tr = reduce_events(events)
    assert tr.window_s == pytest.approx(120e-6)  # 100 .. 220
    assert tr.busy_s == pytest.approx(60e-6)
    assert tr.range_device_s[CONV] == pytest.approx(50e-6)
    assert tr.range_device_s[ATTN] == pytest.approx(10e-6)
    assert tr.device_ops[0] == ["conv_a", pytest.approx(30e-6)]
    assert tr.idle_gaps[0][1] == pytest.approx(40e-6)  # 160 .. 200
    assert tr.idle_gaps[0][0] == "aten::copy_"
    assert tr.unattributed_kernels == 0


def test_a_span_with_no_launch_reads_nothing():
    tr = reduce_events([_ev("kernel", "k", 0, 5, corr=7)])
    assert tr.window_s == 0 and tr.busy_s == 0


def test_a_device_only_span_starts_at_its_first_device_operation():
    events = [_ev("kernel", "a", 10, 5, corr=7), _ev("gpu_memcpy", "m", 30, 10, corr=8)]
    tr = reduce_events(events, need_launch=False)
    assert tr.window_s == pytest.approx(30e-6) and tr.busy_s == pytest.approx(15e-6)


def test_the_spans_follow_the_units_after_the_window(monkeypatch):
    calls = []
    monkeypatch.setattr(Span, "start", lambda self: calls.append(("start", self.host)))
    monkeypatch.setattr(Span, "stop", lambda self, units: calls.append(("stop", self.host, units)))
    # the spans are reduced as each stops (a later profiler clears the earlier)
    spans = TracedSpans(None, skip=2, units=3)
    done = [spans.tick(k) for k in range(9)]
    assert done == [False] * 8 + [True]
    assert calls == [("start", False), ("stop", False, 3), ("start", True), ("stop", True, 3)]
