#!/usr/bin/env python3
"""Smoke run of calodiffusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--batches 2] [--steps 400] [--seed 0]

Phases, each printing its own lines; any failed check exits non-zero and
prints no result:

1. card    the card's name and power limit (nvidia-smi), torch and CUDA versions
2. build   every kernel of the main path, built with nvcc from this checkout
3. kernels each kernel against its plain PyTorch version on the card at the
           shapes of the main path (dataset 2, batch 128), in bf16 and f32,
           with its time, the plain version's time and the card's bound
4. main    dataset-2 shower generation at the full width of
           configs/config_dataset2.json (bf16, 400-step DDIM, batch 128)
           through CaloDiffusion.generate, from seeded random weights; the
           showers must be finite, >= 0 and of shape (batches*128, 6480), and
           every kernel must have been launched by it (counts reset just
           before).  The same weights in f32 must agree on the card and on
           the CPU (plain versions) for one denoise call.
5. result  {"kernels": [...]} and, last, {"ok": true, "device": {...}}
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_dataset2.json"

# Published H100 SXM peaks (NVIDIA data sheet, dense): the card's least time
# for a piece of work is the larger of bytes / HBM rate and operations / rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; f32 CUDA cores

# (C, N) of the 7 PreNormResidual(LinearAttention) blocks of one ds2 denoise
# call, in call order: down levels, middle, up levels
DS2_ATTENTION_BLOCKS = [(32, 6480), (64, 736), (32, 96), (32, 96), (64, 96), (32, 736),
                        (32, 6480)]
BATCH = 128

# Kernel vs plain version, elementwise |kernel - plain| <= atol + rtol * |plain|:
# - f32 (TF32 off on both sides): only the order of f32 sums differs, over
#   up to N*C = 207k terms in the GroupNorm statistics: 1e-4 absolute.
# - bf16: the kernel keeps the q/k projections and the softmax numerators in
#   f32 (as the Pallas kernel does) where the plain version rounds them to
#   bf16 first, so the unit-scale post-GN term may differ by a few bf16 ulps
#   (1/64 each below 2), and the residual sum rounds to bf16 at the output's
#   magnitude: 0.0625 plus 2 ulps of the output (2 * 2^-7 relative).
TOL = {torch.bfloat16: (0.0625, 2.0**-6), torch.float32: (1e-4, 0.0)}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_inputs(B, N, C, dtype, seed):
    """Inputs of one attention block on the card, scaled as the U-Net's."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0, offset=0.0):
        return torch.randn(*shape, generator=g) * scale + offset

    args = (rn(B, N, C), rn(C, scale=0.1, offset=1.0), rn(C, scale=0.1),
            rn(C, 96, scale=0.2), rn(32, C, scale=0.2), rn(C, scale=0.1),
            rn(C, scale=0.1, offset=1.0), rn(C, scale=0.1))
    args = [a.cuda() for a in args]
    for i in (0, 3, 4):  # x and the projection weights in the compute dtype
        args[i] = args[i].to(dtype).contiguous()
    return args


def attention_bound(B, N, C, dtype):
    """(bound ms, bound_by) of x + GN(LinAttn(GN(x))): x read once, out
    written once, weights read once; the matrix products' operations."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * N * C * elt + (C * 96 + 32 * C) * elt + 5 * C * 4
    flops = 2 * B * N * (96 * C + 32 * 32 + 32 * 32 + 32 * C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_attention_kernel(attn):
    """Kernel vs plain version at every ds2 (C, N), B=128, bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for C, N in sorted(set(DS2_ATTENTION_BLOCKS)):
            args = block_inputs(BATCH, N, C, dtype, seed=C + N)
            got = attn.fused_attention_block(*args)
            torch.cuda.synchronize()
            want = attn.attention_block_reference(*args)
            atol, rtol = TOL[dtype]
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            if not np.isfinite(err) or (diff > atol + rtol * want.float().abs()).any():
                fail(f"fused_attention_block (C={C}, N={N}, {dtype}) differs from its "
                     f"plain version by up to {err:.3g}, beyond {atol} + {rtol} * |plain|")
            k_ms = time_ms(lambda: attn.fused_attention_block(*args))
            p_ms = time_ms(lambda: attn.attention_block_reference(*args))
            b_ms, b_by = attention_bound(BATCH, N, C, dtype)
            cases.append(dict(
                name="fused_attention_block", replaces=REPLACES,
                shape=[BATCH, N, C], dtype=str(dtype).removeprefix("torch."),
                max_abs_err=err, tol={"atol": atol, "rtol": rtol}, kernel_ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by,
                launches_per_denoise=DS2_ATTENTION_BLOCKS.count((C, N)),
            ))
            print(f"kernel fused_attention_block B={BATCH} N={N} C={C} {cases[-1]['dtype']}: "
                  f"max_abs_err {err:.3g} (tol {atol} + {rtol} * |plain|), kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    return cases


REPLACES = "calodiffusion_tpu/ops/pallas_linear_attention.py:240"


def per_denoise(cases, key, dtype="bfloat16"):
    """Sum of a per-launch number over the 7 attention blocks of one denoise."""
    return sum(c[key] * c["launches_per_denoise"] for c in cases if c["dtype"] == dtype)


def synthetic_loader(batches, n_layers, seed):
    """(E, layers, None) batches as the data loader yields them: normalized
    log-energies in [0, 1) and standardized layer energies."""
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        yield (rng.uniform(0.0, 1.0, (BATCH, 1)).astype(np.float32),
               rng.standard_normal((BATCH, n_layers)).astype(np.float32), None)


def check_card_vs_cpu(cfg, state_dict, seed):
    """One full-width denoise in f32 on the card (kernels) and on the CPU
    (plain versions) from the same weights and inputs."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    cfg = dict(cfg, PRECISION="f32")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 1, 45, 16, 9)).astype(np.float32))
    E = torch.from_numpy(rng.uniform(0, 1, (2, 1)).astype(np.float32))
    lay = torch.from_numpy(rng.standard_normal((2, 46)).astype(np.float32))
    sigma = torch.full((2, 1, 1, 1, 1), 0.7)
    outs = []
    for dev in ("cuda", "cpu"):
        m = CaloDiffusion(cfg, device=dev)
        m.load_state_dict(state_dict)
        with torch.no_grad():
            outs.append(m.denoise(x.to(dev), E=E.to(dev), sigma=sigma.to(dev),
                                  layers=lay.to(dev)).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    # the weight-transfer bound of docs/DESIGN.md:32
    if not err <= 2e-4:
        fail(f"f32 denoise on the card differs from the CPU by {err:.3g} > 2e-4")
    print(f"main: f32 denoise card vs CPU max_abs_err {err:.3g} (tol 2e-4)", flush=True)
    return err


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
        from calodiffusion_tpu_torch.ops import cuda_build
        from calodiffusion_tpu_torch.ops import linear_attention as attn
        from calodiffusion_tpu_torch.utils.config import load_config
    except ImportError as e:
        fail(f"calodiffusion_tpu_torch is not importable here: {e}")
    if not CONFIG.exists():
        fail(f"{CONFIG} missing")

    # 1. card
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    attn._library()
    build_s = time.perf_counter() - t0
    log = cuda_build.library_path("linear_attention_block").with_suffix(".log")
    print(f"build: linear_attention_block.cu in {build_s:.1f} s", flush=True)
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}", flush=True)

    # 3. kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = check_attention_kernel(attn)

    # 4. main path
    cfg = load_config(str(CONFIG))
    model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(args.seed))
    n_layers = cfg["SHAPE_FINAL"][2] + 1
    loader = list(synthetic_loader(args.batches, n_layers, args.seed))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = 0
    t0 = time.perf_counter()
    showers, energies = model.generate(loader, args.steps, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attn.fused_attention_block.launches
    n = args.batches * BATCH
    if showers.shape != (n, 6480) or energies.shape != (n, 1):
        fail(f"showers {showers.shape}, energies {energies.shape}; expected ({n}, 6480), ({n}, 1)")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail("showers are not finite and >= 0")
    want = len(DS2_ATTENTION_BLOCKS) * args.steps * args.batches
    if launches != want:
        fail(f"fused_attention_block launched {launches} times on the main path, expected {want}")
    print(f"main: {n} ds2 showers, {args.steps}-step DDim, bf16, batch {BATCH}: {wall:.2f} s, "
          f"{n / wall:.3f} showers/s on {card}; fused_attention_block launches {launches}",
          flush=True)
    check_card_vs_cpu(cfg, model.state_dict(), args.seed + 1)

    # 5. result
    bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
    kernels = [dict(
        name="fused_attention_block", route="cuda",
        source="calodiffusion_tpu_torch/csrc/linear_attention_block.cu",
        replaces=REPLACES, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in bf16),
        # times of the 7 launches of one ds2 denoise call, B=128, bf16
        ms=per_denoise(cases, "kernel_ms"), plain_ms=per_denoise(cases, "plain_ms"),
        bound_ms=per_denoise(cases, "bound_ms"),
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in bf16) else "operations",
        library_ms=None, launches_per_denoise=len(DS2_ATTENTION_BLOCKS),
        launches_per_batch=len(DS2_ATTENTION_BLOCKS) * args.steps, cases=cases,
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
