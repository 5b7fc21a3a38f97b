"""The traced spans of a ``--trace 1`` run, and their reduction.

They run after the measured window has closed, so that the window of a
traced run is measured as an untraced one is: first ``trace_from`` units
that let the host run ahead again, then ``trace_units`` under a profiler
of the device alone (the idle share: the profiler records no host
operation, so it slows the host little), then ``trace_units`` under a
profiler of host and device with the ranges below (what each range spent
on the device, the longest operations and idle gaps, each gap with the host
operation under way at its start).

Ranges are opened and closed by hooks the benchmark registers on the
network, chosen by what a module holds, not by its class:

- ``portbench.conv``: a module that owns a 5-D weight (a 3-D convolution or
  its transpose), called outside an attention block;
- ``portbench.attn``: the outermost module whose subtree holds exactly one
  attention projection, a 1x1x1 convolution weight with 3 x 32 outputs:
  the residual attention block.

A kernel belongs to the innermost range open on the host when it was
launched, matched by the profiler's correlation id; what it did on the
device is read from the kernel's own interval.  The device is busy where
the union of the kernel, copy and set intervals covers the span; the span
runs from the first kernel launched inside it to the last one's end.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

CONV, ATTN = "portbench.conv", "portbench.attn"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
HOST_CATS = {"cpu_op", "user_annotation", "python_function"}


def _is_conv(m) -> bool:
    w = getattr(m, "weight", None)
    return isinstance(w, torch.Tensor) and w.dim() == 5


def _is_qkv(m) -> bool:
    w = getattr(m, "weight", None)
    return (isinstance(w, torch.Tensor) and w.dim() == 5 and w.shape[0] == 96
            and tuple(w.shape[2:]) == (1, 1, 1))


def attention_blocks(net) -> list:
    """The outermost modules of ``net`` whose subtree holds exactly one
    attention projection."""
    counts = {}

    def count(m):
        counts[m] = int(_is_qkv(m)) + sum(count(c) for c in m.children())
        return counts[m]

    count(net)
    out = []

    def walk(m):
        if counts[m] == 1 and not _is_qkv(m):
            out.append(m)
            return
        for c in m.children():
            walk(c)

    walk(net)
    return out


class Ranges:
    """Hooks opening a profiler range around each convolution and attention
    block of ``net``; ``close`` removes them.  ``calls`` counts the ranges
    opened, by name."""

    def __init__(self, net):
        self.handles = []
        self.stack: list = []
        self.calls = {CONV: 0, ATTN: 0}
        attn = attention_blocks(net)
        inside = {id(m) for b in attn for m in b.modules()}
        for m in attn:
            self._hook(m, ATTN)
        for m in net.modules():
            if _is_conv(m) and id(m) not in inside:
                self._hook(m, CONV)

    def _hook(self, module, name):
        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            self.stack.append(rf)
            self.calls[name] += 1

        def post(mod, args, out):
            self.stack.pop().__exit__(None, None, None)

        self.handles += [module.register_forward_pre_hook(pre),
                         module.register_forward_hook(post)]

    def close(self):
        for h in self.handles:
            h.remove()
        self.handles = []


@dataclass
class Trace:
    """The reduction of one traced span."""
    window_s: float = 0.0
    busy_s: float = 0.0
    units: int = 0  # network evaluations or train steps traced
    range_device_s: dict = field(default_factory=dict)  # range -> device seconds
    range_calls: dict = field(default_factory=dict)  # range -> ranges opened
    unattributed_kernels: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)
    kernels: int = 0
    start_s: float = 0.0  # the host and device profiler's start
    host_busy_s: float = 0.0  # busy and span under the host and device profiler
    host_window_s: float = 0.0
    device_span_empty: bool = False  # the device-only span recorded nothing


def warm_profiler() -> None:
    """Start and stop a profiler once, so that its one-time set-up (CUPTI's)
    falls in the run's set-up and not inside the traced window."""
    if not torch.cuda.is_available():
        return
    from torch.profiler import ProfilerActivity, profile

    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()


class Span:
    """A profiler over a fixed span of units of a run: of the device alone,
    or with ``host`` of host and device with the network's ranges."""

    def __init__(self, net, host: bool):
        self.net, self.host = net, host
        self.prof = None
        self.ranges = None
        self.units = 0
        self.start_s = 0.0
        self.trace = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        if self.host:
            self.ranges = Ranges(self.net)
            activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        else:
            activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                          else [ProfilerActivity.CPU])
        self.prof = profile(activities=activities)
        self.prof.start()
        self.start_s = time.perf_counter() - t

    def stop(self, units: int):
        """End the span and reduce it at once: a profiler started later
        clears what this one recorded."""
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        if self.ranges is not None:
            self.ranges.close()
        self.units = units
        self.trace = self._reduce()

    def _reduce(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        events = events["traceEvents"] if isinstance(events, dict) else events
        tr = reduce_events(events, need_launch=self.host)
        tr.units = self.units
        tr.range_calls = dict(self.ranges.calls) if self.ranges is not None else {}
        tr.start_s = self.start_s
        return tr


class TracedSpans:
    """The spans after the window (module docstring), driven by ``tick(k)``
    before unit k of the run's work from the window's close."""

    def __init__(self, net, skip: int, units: int):
        self.device = Span(net, host=False)
        self.full = Span(net, host=True)
        self.skip, self.units = skip, units

    def tick(self, k: int) -> bool:
        """Start or stop a span before unit ``k``; True once both are done."""
        if k == self.skip:
            self.device.start()
        elif k == self.skip + self.units:
            self.device.stop(self.units)
            self.full.start()
        elif k == self.skip + 2 * self.units:
            self.full.stop(self.units)
            return True
        return False

    def reduce(self) -> Trace:
        """The host and device span's reduction, with the device span's busy
        and window seconds."""
        tr, dev = self.full.trace, self.device.trace
        tr.host_busy_s, tr.host_window_s = tr.busy_s, tr.window_s
        if dev.window_s > 0:
            tr.busy_s, tr.window_s = dev.busy_s, dev.window_s
        else:
            tr.device_span_empty = True  # the host and device span's stand
        return tr


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_events(events, need_launch: bool = True) -> Trace:
    """Busy and window seconds, device seconds by range, the longest device
    operations and idle gaps, from chrome-trace events (times in us).  The
    span starts at the first device operation launched inside it; without
    ``need_launch``, where the trace holds no launch (a profile of the
    device alone may not), at the first device operation."""
    launches, ranges, host = {}, [], []
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", "?"),
                           (ev.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "?")))
            if ev.get("name") in (CONV, ATTN) and cat == "user_annotation":
                ranges.append((ts, ts + dur, ev["name"]))
    tr = Trace()
    launched = [d for d in device if d[3] in launches]
    if not launched and not need_launch:
        launched = device
    if not launched:
        return tr
    lo = min(d[0] for d in launched)
    hi = max(d[1] for d in device)
    clipped = [(max(s, lo), min(e, hi)) for s, e, _, _ in device if e > lo and s < hi]
    busy = _union(clipped)
    tr.window_s = (hi - lo) * 1e-6
    tr.busy_s = sum(e - s for s, e in busy) * 1e-6
    tr.kernels = len(device)

    ranges.sort()
    starts = [r[0] for r in ranges]
    per_range = {CONV: 0.0, ATTN: 0.0}
    for s, e, name, corr in device:
        t = launches.get(corr)
        if t is None:
            if s >= lo:
                tr.unattributed_kernels += 1
            continue
        owner, width = None, None
        i = bisect.bisect_right(starts, t)
        for rs, re_, rname in reversed(ranges[max(0, i - 64):i]):
            if rs <= t <= re_ and (width is None or re_ - rs < width):
                owner, width = rname, re_ - rs
        if owner is not None:
            per_range[owner] += (e - s) * 1e-6
    tr.range_device_s = per_range

    by_name: dict = {}
    for s, e, name, _ in device:
        by_name[name[:160]] = by_name.get(name[:160], 0.0) + (e - s) * 1e-6
    tr.device_ops = sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10]

    gaps = [(busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)]
    gaps.sort(reverse=True)
    host.sort()
    out = []
    for width, at in gaps[:10]:
        label, best = "none", None
        for hs, he, hname in host:
            if hs > at:
                break
            if he >= at and (best is None or he - hs < best):
                label, best = hname, he - hs
        out.append([label[:160], width * 1e-6])
    tr.idle_gaps = out
    return tr
