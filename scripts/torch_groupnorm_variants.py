#!/usr/bin/env python3
"""K5 (GroupNorm + SiLU) by launch and chunk size, timed on one CUDA card.

    python3 scripts/torch_groupnorm_variants.py [--out FILE]

For each of chip_smoke.py's K5 shapes, bf16 and f32: the device time of each
of K5's launches (the kernels of ``csrc/groupnorm_silu.cu`` whose names
start with ``gn_``) from a torch.profiler trace, at every chunk size the
kernel takes (``steps``: 16-byte vectors a thread, the rows of a chunk),
whether the output stays within K5_TOL of the plain version, and, beside
them, the two PyTorch calls F.silu(F.group_norm(.)) on a channels-first
copy of x (PyTorch's native kernels) by name.  Then design variants of the
source (a few text substitutions, built with nvcc into ``_build/variants/``)
at the kernel's own chunk size: ``stats_2_ctas`` lets the statistics
launch take the registers of two CTAs an SM, where the as-built kernel asks
for three (at most 56 registers a thread).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.ops import cuda_build  # noqa: E402
from calodiffusion_tpu_torch.ops import groupnorm as gn  # noqa: E402
from calodiffusion_tpu_torch.ops.tolerances import K5_TOL  # noqa: E402

# chip_smoke.py's K5_SHAPES: ds2 levels 0 and 2 (batch 128), ds3 level 0 (batch 64)
SHAPES = [(128, 45, 16, 9, 32), (128, 23, 8, 4, 64), (64, 45, 50, 18, 32)]
MAX_STEPS = 8
VARIANTS = {
    "stats_2_ctas": [("__launch_bounds__(THREADS, 3)\ngn_stats_kernel",
                      "__launch_bounds__(THREADS)\ngn_stats_kernel")],
}


def build_variant(name: str, subs, dtype):
    """csrc/groupnorm_silu.cu with ``subs`` applied, built for ``dtype``."""
    src = (cuda_build.CSRC_DIR / f"{gn.KERNEL.name}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"variant {name} no longer applies ({old.strip()!r})")
        src = src.replace(old, new)
    out = cuda_build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{gn.KERNEL.name}-{name}.cu"
    path.write_text(src)
    defines = cuda_build.dtype_variant(dtype)
    so = path.with_name(f"{path.stem}-{defines[0].replace('=', '')}.so")
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC_DIR}",
                           *(f"-D{d}" for d in defines), "-o", str(so), str(path)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {path.name}:\n{proc.stderr[-4000:]}")
    regs = [ln.strip()[-60:] for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return gn.KERNEL.bind(ctypes.CDLL(str(so))), regs


def kernel_ms(fn, reps: int = 20) -> dict:
    """Device time of one call by kernel name, from a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {ev.key: getattr(ev, "self_device_time_total", 0.0) / 1e3 / reps
            for ev in prof.key_averages() if getattr(ev, "self_device_time_total", 0.0) > 0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="JSON file for the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    result = {"card": card, "k5": {}, "two_calls": {}, "variants": {}}
    variants = {(name, dt): build_variant(name, subs, dt) for name, subs in VARIANTS.items()
                for dt in (torch.bfloat16, torch.float32)}
    for (name, dt), (_, regs) in variants.items():
        print(f"build {name} {dt}: {'; '.join(regs)}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in SHAPES:
            g = torch.Generator().manual_seed(sum(shape))
            C = shape[-1]
            x = (torch.randn(*shape, generator=g) + 0.5).cuda().to(dtype)
            scale = (1.0 + 0.1 * torch.randn(C, generator=g)).cuda()
            bias = (0.1 * torch.randn(C, generator=g)).cuda()
            want = gn.gn_silu_reference(x, scale, bias, 8).float()
            lib = gn.KERNEL.library(x)
            S = x[0, ..., 0].numel()
            for steps in range(1, MAX_STEPS + 1):
                chunks = lib.calo_groupnorm_silu_chunks(S, C, steps)
                if chunks < 1:
                    break

                def call():
                    return gn.launch(lib, x, scale, bias, 8, 1e-5, True, steps)

                diff = (call().float() - want).abs()
                atol, rtol = K5_TOL[dtype]
                ok = bool((diff <= atol + rtol * want.abs()).all())
                by_kernel = {k: v for k, v in kernel_ms(call).items() if "gn_" in k}
                total = sum(by_kernel.values())
                key = f"{tuple(shape)} {str(dtype).removeprefix('torch.')} steps={steps}"
                result["k5"][key] = dict(chunks=chunks, total_ms=total, within_tol=ok,
                                         by_kernel=by_kernel)
                names = ", ".join(f"{re.search(r'gn_[a-z]+', k).group(0)} {v:.4f}"
                                  for k, v in by_kernel.items())
                print(f"K5 {key}: {chunks} chunks a sample, {total:.4f} ms device ({names}), "
                      f"within K5_TOL {ok}", flush=True)
            for name in VARIANTS:
                vlib = variants[(name, dtype)][0]
                got = gn.launch(vlib, x, scale, bias, 8, 1e-5, True)
                ok = bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())
                by_kernel = {k: v for k, v in kernel_ms(
                    lambda: gn.launch(vlib, x, scale, bias, 8, 1e-5, True)).items() if "gn_" in k}
                key = f"{name} {tuple(shape)} {str(dtype).removeprefix('torch.')}"
                result["variants"][key] = dict(total_ms=sum(by_kernel.values()), within_tol=ok,
                                               by_kernel=by_kernel)
                names = ", ".join(f"{re.search(r'gn_[a-z]+', k).group(0)} {v:.4f}"
                                  for k, v in by_kernel.items())
                print(f"K5 variant {key}: {sum(by_kernel.values()):.4f} ms device ({names}), "
                      f"within K5_TOL {ok}", flush=True)
            x_cf = x.movedim(-1, 1).contiguous()
            sc, bi = scale.to(dtype), bias.to(dtype)
            two = kernel_ms(lambda: F.silu(F.group_norm(x_cf, 8, sc, bi)))
            key = f"{tuple(shape)} {str(dtype).removeprefix('torch.')}"
            result["two_calls"][key] = dict(total_ms=sum(two.values()), by_kernel=two)
            print(f"F.silu(F.group_norm) {key} channels-first: {sum(two.values()):.4f} ms device "
                  f"({len(two)} kernels)", flush=True)
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
