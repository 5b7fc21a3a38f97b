"""One run of one cell: set-up, the measured window, the check, the result.

The harness is driven by data.  ``BENCHMARK.json`` names each cell's
configuration and traffic mix and the metrics each cell reports; the files
are found by name:

- ``configs/<name>.json``: the configuration as it is run (the file that
  ``BENCHMARK.json`` gives);
- ``traffic/<name>.json``: the entry the window drives (``generate`` or
  ``train_step``) and its parameters;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<name>.py``: a ``read(run)`` that returns the metric's value
  from a ``RunRecord``, or None where it finds nothing to read; a metric
  split by cell (``showers_per_s.ds3``) may read with the file of its
  unsplit name (``showers_per_s.py``).

Every entry counts its unit of work itself: a forward pre-hook on the
program's network counts its evaluations, the train loop its steps.  At the
first unit that starts after ``seconds``, the harness synchronises once,
records the time and the work completed, and ends the window: a generation
call in flight is abandoned by raising from the hook.  A run whose window
is shorter than one call finishes that call and reports over it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from portbench import inputs, judge
from portbench.trace import Trace, TracedSpans, warm_profiler

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "calodiffusion_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Finding a cell's files by name
# ---------------------------------------------------------------------------

class Bench:
    """``BENCHMARK.json`` and the directories its files are found in:
    ``dirs`` are searched in order for ``traffic/``, ``limits/`` and
    ``metrics/``; configuration files are read relative to ``base``."""

    def __init__(self, spec: dict, base: Path = REPO, dirs=(HERE,)):
        self.spec, self.base, self.dirs = spec, Path(base), [Path(d) for d in dirs]

    @classmethod
    def load(cls, path: Path = REPO / "BENCHMARK.json") -> "Bench":
        with open(path) as f:
            return cls(json.load(f), base=Path(path).parent)

    def _find(self, sub: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / sub / f"{name}{suffix}"
            if p.exists():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{suffix} under {[str(d) for d in self.dirs]}")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.base / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self._find("traffic", name, ".json")) as f:
            return json.load(f)

    def limits(self, workload: str) -> dict:
        with open(self._find("limits", workload, ".json")) as f:
            return json.load(f)

    def metrics(self, workload: str, traced: bool) -> list:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: those that list it, or list no cells."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        """``metrics/<name>.py``'s ``read``; a metric with no file of its own
        reads with that of the name without its last dotted part
        (``showers_per_s.ds3`` with ``showers_per_s.py``), and so on."""
        parts = name.split(".")
        for n in range(len(parts), 0, -1):
            try:
                path = self._find("metrics", ".".join(parts[:n]), ".py")
                break
            except FileNotFoundError:
                if n == 1:
                    raise
        spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


# ---------------------------------------------------------------------------
# What the metric readers read
# ---------------------------------------------------------------------------

@dataclass
class RunRecord:
    """One run as the metric readers see it."""
    entry: str
    config: dict
    traffic: dict
    batch: int
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0  # network evaluations (generate) or train steps in the window
    calls: int = 0  # generation calls completed in the window
    evals_per_call: int = 0
    trace: Optional[Trace] = None
    setup_parts: dict = field(default_factory=dict)


class WindowClosed(Exception):
    """Raised from the network's pre-hook to abandon the call in flight."""


def _batch(config, traffic) -> int:
    b = traffic["batch"]
    return int(config[b] if isinstance(b, str) else b)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Generation: CaloDiffusion.generate, back to back
# ---------------------------------------------------------------------------

def build_generation(config, traffic, seed, device):
    """The model with the benchmark's weights, the conditioning pool (device
    tensors), its loaders (numpy, as the program's loaders give them) and
    the sampler."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    model = CaloDiffusion(config, n_steps=config["NSTEPS"], loss_type=config["LOSS_TYPE"],
                          device=device)
    weights = inputs.make_weights(config, seed, device)
    model.load_state_dict(weights)
    del weights
    conds = inputs.conditioning(config, _batch(config, traffic), traffic["inputs"], seed, device)
    loaders = [[(E.cpu().numpy(), None if L is None else L.cpu().numpy(), None)]
               for E, L in conds]
    return model, conds, loaders, model.make_sampler(traffic["sampler"])


def generate_call(model, loaders, sampler, traffic, seed, call, gen, steps=None):
    """Generation call ``call``: its conditioning and start noise."""
    gen.manual_seed(inputs.call_seed(seed, call))
    showers, _ = model.generate(loaders[call % len(loaders)], steps or traffic["steps"],
                                generator=gen, sampler=sampler)
    return showers


def _generate(config, traffic, limits, seed, seconds, traced, device, t0, rec: RunRecord):
    t = time.perf_counter()
    model, conds, loaders, sampler = build_generation(config, traffic, seed, device)
    gen = torch.Generator(device=device)
    rec.setup_parts["model_weights_inputs"] = time.perf_counter() - t

    t = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        generate_call(model, loaders, sampler, traffic, seed, 2**32 + i, gen,
                      traffic["warmup_steps"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_parts["warmup"] = time.perf_counter() - t
    if traced:
        warm_profiler()

    # one counter of evaluations: the check's hooks count every one
    capture = judge.Capture(model.net, *judge.capture_plan(seed, rec.batch, traffic))
    st = SimpleNamespace(calls=0, t_close=None, done=0)

    def close(mod, args):
        if st.calls >= 1 and time.perf_counter() >= t_end:
            if device.type == "cuda":
                torch.cuda.synchronize()
            st.t_close, st.done = time.perf_counter(), capture.evals
            raise WindowClosed

    outputs = []  # (call, showers)
    rec.setup_s = time.perf_counter() - t0
    hook = model.net.register_forward_pre_hook(close)
    t_start = time.perf_counter()
    t_end = t_start + seconds
    call = 0
    try:
        while True:
            before = capture.evals
            capture.begin(call)
            showers = generate_call(model, loaders, sampler, traffic, seed, call, gen)
            capture.end()
            outputs.append((call, showers))
            st.calls += 1
            rec.evals_per_call = rec.evals_per_call or capture.evals - before
            call += 1
            if time.perf_counter() >= t_end:
                st.t_close, st.done = time.perf_counter(), capture.evals
                break
    except WindowClosed:
        capture.end()
    finally:
        hook.remove()
    rec.window_s = st.t_close - t_start
    rec.units, rec.calls = st.done, st.calls

    if traced:
        # after the window, from the next call on, across calls if need be
        spans = TracedSpans(model.net, traffic["trace_from"], traffic["trace_units"])
        first = capture.evals

        def drive(mod, args):
            if spans.tick(capture.evals - first):
                raise WindowClosed

        hook = model.net.register_forward_pre_hook(drive)
        try:
            while True:
                generate_call(model, loaders, sampler, traffic, seed, call, gen)
                call += 1
        except WindowClosed:
            pass
        finally:
            hook.remove()
        rec.trace = spans.reduce()
    capture.close()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    del model, sampler
    _free()
    numbers, failed, stages = judge.check_generation(config, traffic, seed, outputs, capture,
                                                     conds, device, limits)
    log("widest gap by stage: " + json.dumps(stages))
    return peak, numbers, failed, rec.calls


# ---------------------------------------------------------------------------
# Training: TrainDiffusion.train_step, back to back
# ---------------------------------------------------------------------------

def build_training(config, traffic, seed, device, parts=None):
    """The training object with the benchmark's weights, its optimizer and
    draws, the pool of batches, and ``step(i)``: train step i on batch i
    of the pool, cycled.  ``parts``: where to note the trainer's own
    construction time."""
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    B = _batch(config, traffic)
    t = time.perf_counter()
    trainer = TrainDiffusion(SimpleNamespace(seed=1), config, load_data=False,
                             save_model=False, device=device)
    trainer.init_model()
    if parts is not None:
        parts["trainer_model"] = time.perf_counter() - t
    weights = inputs.make_weights(config, seed, device)
    trainer.model.load_state_dict(weights)
    del weights
    t = time.perf_counter()
    trainer.make_optimizer(float(config["LR"]))
    if parts is not None:
        parts["optimizer"] = time.perf_counter() - t
    trainer.generator = inputs.generator(seed, inputs.TRAIN_DRAWS, device=device)
    n_pool = traffic["pool"]
    data = inputs.showers(config, B, n_pool, seed, device)
    conds = inputs.conditioning(config, B, n_pool, seed, device)
    layer_cond = trainer.model.layer_cond

    def step(i):
        E, L = conds[i % n_pool]
        return trainer.train_step(data[i % n_pool], E, L if layer_cond else None)

    return trainer, data, conds, step


def checked_steps(trainer, step, n_steps: int, n_checked: int):
    """Run steps 0 .. n_steps - 1; returns (their losses, the program's
    readings of the first ``n_checked``: "grad1" (Adam's first moment after
    one step over 1 - beta1: a step that left the optimizer untouched got
    no gradient at all), "grads" (each step's gradients as the optimizer
    got them), "states" (the parameters before each step) and "after")."""
    params = dict(trainer.model.named_parameters())
    beta1 = trainer.opt.param_groups[0]["betas"][0]
    losses = []
    readings = {"grads": [], "states": []}
    for i in range(n_steps):
        if i < n_checked:
            readings["states"].append({k: p.detach().clone() for k, p in params.items()})
        losses.append(step(i))
        if i < n_checked:
            readings["grads"].append({
                k: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
                for k, p in params.items()})
        if i == 0:
            readings["grad1"] = {
                k: trainer.opt.state[p].get("exp_avg", torch.zeros_like(p)).detach() / (1 - beta1)
                for k, p in params.items()}
        if i == n_checked - 1:
            readings["after"] = {k: p.detach().clone() for k, p in params.items()}
    return losses, readings


def _train(config, traffic, limits, seed, seconds, traced, device, t0, rec: RunRecord):
    t = time.perf_counter()
    trainer, data, conds, step = build_training(config, traffic, seed, device,
                                                parts=rec.setup_parts)
    rec.setup_parts["model_weights_inputs"] = time.perf_counter() - t

    # the checked steps: the same object then runs the window
    t = time.perf_counter()
    n_checked = traffic["checked_steps"]
    losses, program = checked_steps(trainer, step, traffic["warmup_steps"], n_checked)
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec.setup_parts["warmup"] = time.perf_counter() - t

    if traced:
        warm_profiler()
    rec.setup_s = time.perf_counter() - t0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = traffic["warmup_steps"]
    n = 0
    while n < 1 or time.perf_counter() < t_end:
        losses.append(step(i))
        i += 1
        n += 1
    if device.type == "cuda":
        torch.cuda.synchronize()
    rec.window_s = time.perf_counter() - t_start
    rec.units = n
    if traced:
        # after the window: the same object's next steps
        spans = TracedSpans(trainer.model.net, traffic["trace_from"], traffic["trace_units"])
        k = 0
        while not spans.tick(k):
            step(i)
            i += 1
            k += 1
        rec.trace = spans.reduce()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    loss_values = torch.stack(losses).float().cpu().numpy()
    program["losses"] = [float(v) for v in loss_values[:n_checked]]
    del trainer, step
    _free()
    numbers = judge.check_training(config, traffic, seed, program, data, conds, device)
    nonfinite = int((~np.isfinite(loss_values)).sum())
    failed = nonfinite + (n_checked if not judge.passes(numbers, limits) else 0)
    return peak, numbers, failed, len(loss_values)


ENTRIES = {"generate": _generate, "train_step": _train}


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run_cell(bench: Bench, workload: str, seed: int, seconds: float, traced: bool,
             device="cuda", t0: Optional[float] = None) -> dict:
    """One run of ``workload``; returns the result object."""
    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    w = bench.workload(workload)
    config = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    limits = bench.limits(workload)
    rec = RunRecord(traffic["entry"], config, traffic, _batch(config, traffic))
    rec.setup_parts["imports"] = time.perf_counter() - t0

    from calodiffusion_tpu_torch.ops import cuda_build

    built_before = {p.name for p in cuda_build.BUILD_DIR.glob("*.so")}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    peak, numbers, failed, attempted = ENTRIES[rec.entry](
        config, traffic, limits, seed, seconds, traced, device, t0, rec)
    built = sorted({p.name for p in cuda_build.BUILD_DIR.glob("*.so")} - built_before)
    log("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in rec.setup_parts.items())
        + f"; total {rec.setup_s:.3f} s; nvcc builds {len(built)}"
        + (f" ({', '.join(built)})" if built else " (every kernel loaded from "
           f"{cuda_build.BUILD_DIR.relative_to(cuda_build.PACKAGE_DIR.parent)}/)"))
    log(f"window: {rec.window_s:.3f} s, {rec.units} units, {rec.calls} calls")
    if rec.trace is not None:
        tr = rec.trace
        log(f"trace after the window: {tr.units} units a span; device only: busy "
            f"{tr.busy_s:.6f} of {tr.window_s:.6f} s; with host operations: busy "
            f"{tr.host_busy_s:.6f} of {tr.host_window_s:.6f} s, {tr.kernels} device operations, "
            f"{tr.unattributed_kernels} without a launch, profiler start {tr.start_s:.3f} s, "
            f"ranges {tr.range_calls}, device s by range {tr.range_device_s}")
        if tr.device_span_empty:
            log("the device-only span recorded nothing: busy and span are the host and "
                "device span's")

    metrics = {}
    for m in bench.metrics(workload, traced):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    if traced:
        dev["busy_s"] = rec.trace.busy_s if rec.trace else 0.0
        dev["window_s"] = rec.trace.window_s if rec.trace else 0.0
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    for k in sorted(set(numbers) - set(limits)):
        log(f"read, not compared: {k} {numbers[k]!r}")
    result = {"correct": judge.passes(numbers, limits) and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return result


def cache_env(root: Path = REPO) -> None:
    """Point the compile caches a torch process may use at fixed folders of
    the checkout (the port's own kernels build into its ``_build/``)."""
    cache = root / "_portbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
