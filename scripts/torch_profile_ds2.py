#!/usr/bin/env python3
"""Where the time of dataset-2 generation goes, on one CUDA card.

    python3 scripts/torch_profile_ds2.py [--calls 10] [--generate-reps 3] [--seed 0] [--out FILE]

Builds calodiffusion_tpu_torch's CaloDiffusion at the full width of
configs/config_dataset2.json (bf16, batch 128, seeded random weights).
First, while the process is cold, times ``generate`` over 2 batches of 128
with 400-step DDim ``--generate-reps`` times (host clock, synchronised), as
chip_smoke.py times it once.  Then warms up, times ``--calls`` denoise calls
with CUDA events, traces the same calls with torch.profiler and sums device
time by kernel family.  Prints the top kernels and one JSON line; ``--out``
also writes them to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion  # noqa: E402
from calodiffusion_tpu_torch.ops import linear_attention  # noqa: E402
from calodiffusion_tpu_torch.utils.config import load_config  # noqa: E402

FAMILIES = (  # first match wins; matched against lower-case kernel names
    ("fused_attention_block", ("attention_block_kernel",)),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "sm90", "dgrad", "wgrad")),
    ("group_norm", ("group_norm", "groupnorm", "welford", "rowwisemoments")),
    ("copy_cast_pad", ("copy", "cast", "pad", "cat", "fill")),
    ("gemm", ("gemm", "cutlass")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise_other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--generate-reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="JSON file for the result and the top kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    linear_attention._library()  # the kernel's build is set-up, not generation
    cfg = load_config(str(ROOT / "configs" / "config_dataset2.json"))
    model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(args.seed))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    B, n_layers = 128, cfg["SHAPE_FINAL"][2] + 1

    rng = np.random.default_rng(args.seed)
    loader = [(rng.uniform(0.0, 1.0, (B, 1)).astype(np.float32),
               rng.standard_normal((B, n_layers)).astype(np.float32), None) for _ in range(2)]
    generate_s = []
    for rep in range(args.generate_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(loader, 400, generator=torch.Generator(device="cuda").manual_seed(rep))
        torch.cuda.synchronize()
        generate_s.append(time.perf_counter() - t0)
        print(f"generate {rep}: {2 * B} showers in {generate_s[-1]:.3f} s", flush=True)

    x = torch.randn(B, 1, 45, 16, 9, generator=g, device="cuda")
    E = torch.rand(B, 1, generator=g, device="cuda")
    layers = torch.randn(B, n_layers, generator=g, device="cuda")
    sigma = torch.full((B, 1, 1, 1, 1), 0.7, device="cuda")

    def call():
        with torch.inference_mode():
            return model.denoise(x, E=E, sigma=sigma, layers=layers)

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(args.calls):
        call()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    event_ms = start.elapsed_time(end) / args.calls

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
    by_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key][0] += dev_us / 1e3 / args.calls
            by_kernel[ev.key][1] += ev.count // args.calls
    device_ms = sum(v[0] for v in by_kernel.values())
    fams = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_kernel.items():
        fams[family(name)][0] += ms
        fams[family(name)][1] += n
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]

    result = {
        "card": card, "batch": B, "calls": args.calls,
        "denoise_ms_events": event_ms, "denoise_ms_host_wall": wall_ms,
        "profiled_device_ms_per_call": device_ms,
        "device_idle_share": (1 - device_ms / event_ms) if device_ms else None,
        "kernels_per_call": sum(v[1] for v in by_kernel.values()),
        "generate_s": generate_s,
        "generate_showers_per_s": [2 * B / t for t in generate_s],
        # generate's wall time beyond its 800 denoise calls at the steady rate
        "generate_beyond_denoise_s": [t - 800 * event_ms / 1e3 for t in generate_s],
        "families_ms_per_call": {k: {"ms": v[0], "launches": v[1]}
                                 for k, v in sorted(fams.items(), key=lambda kv: -kv[1][0])},
    }
    if args.out:
        full = dict(result, top_kernels=[{"name": k, "ms": v[0], "launches": v[1]}
                                         for k, v in top])
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(full, indent=1))
    for k, v in top:
        print(f"{v[0]:9.4f} ms  x{v[1]:4d}  {k[:110]}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
