#!/usr/bin/env python3
"""Smoke run of calodiffusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--batches 2] [--steps 400] [--train-steps 20] [--seed 0]

Phases, each printing its own lines; any failed check exits non-zero and
prints no result:

1. card     the card's name and power limit (nvidia-smi), torch and CUDA versions
2. build    every kernel of every path (K1-K5 and K4's backward), each
            variant with its own nvcc, all at once, from this checkout; their
            register/spill lines (and ptxas's wgmma notes); the count of
            HGMMA (wgmma) instructions in K4's bf16 backward library
            (cuobjdump -sass), which must not be 0
3. kernels  K1 and K2 against their plain PyTorch versions on the card at the
            shapes of the ds2 paths (batch 128), in bf16 and f32, with their
            times (CUDA events around a call, and the device time with the
            card kept busy while the host launches), the plain versions'
            times and the card's bound: K1 (forward) against
            attention_block_reference, K2 (backward) against
            attention_block_backward_reference, each with the cluster size it
            chose and which of its tensors it kept on chip
4. main     dataset-2 shower generation at the full width of
            configs/config_dataset2.json (bf16, 400-step DDIM, batch 128)
            through CaloDiffusion.generate, from seeded random weights; the
            showers must be finite, >= 0 and of shape (batches*128, 6480), and
            K1 must have been launched 7 times per denoise (counts reset just
            before).  The same weights in f32 must agree on the card and on
            the CPU (plain versions) for one denoise call.
5. train    dataset-2 training at the same full width (bf16, batch 128) through
            TrainDiffusion.train: --train-steps Adam steps on one repeated
            seeded batch and one val batch, checkpoints written; every loss
            finite, K1 and K2 launched 7 times per step (counts reset just
            before); the batch's loss with fixed noise and sigma falls 5 %
            over the steps; one f32 step's loss and every parameter gradient
            agree on the card and on the CPU from the same weights, batch,
            noise and sigma draws.
6. variants the entries that run the other three kernels, in bf16 and f32:
            K3 (LinearAttention alone) against linear_attention_reference at
            every ds2 (C, N), B = 128, and at dataset 3's full grid (B = 64,
            N = 45*50*18 = 40,500, C = 32), with its device time and plan;
            K4 (blockwise softmax attention) against dense_attention at
            (B*H = 8, N = 4096), N = 736,
            and N = 40,500 with B*H = 4 and 16, and at (B*H = 8, N = 4096)
            with q scaled by 8 (a peaked softmax), beside SDPA's time and
            K4's device time; K4's backward kernel against
            attention_backward_reference (the plain gradient, chunk by
            chunk) at the same shapes, beside the time of SDPA's backward
            (torch.autograd.grad through scaled_dot_product_attention), its
            gradients the same bit for bit in two calls; K5 (GroupNorm +
            SiLU) against gn_silu_reference at ds2 levels 0 and 2 and ds3
            level 0, its output the same bit for bit in two calls, beside
            the two calls F.silu(F.group_norm(.)) on a channels-first copy.
            Then, counts reset just before: a LinearAttention(32) forward
            and backward on the ds3 grid (K3 once; output and f32 gradients
            against the plain module's; the bf16 gradients must be finite and
            are printed, not held to a limit), an Attention(32, heads=4)
            forward and backward on (4, 32, 45, 50, 18) (K4 and its backward
            once each; output and f32 gradients against the plain module's,
            the bf16 gradients finite) and groupnorm_silu at the three
            shapes (K5 three times).
7. result   {"kernels": [...]} and, last, {"ok": true, "device": {...}}
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

try:
    from calodiffusion_tpu_torch.ops.tolerances import (K1_TOL, K2_TOL, K3_TOL, K4_TOL,
                                                        K4B_TOL, K5_TOL)
except ImportError as e:  # the script alone, outside a checkout of the repository
    sys.exit(f"chip_smoke FAILED: calodiffusion_tpu_torch is not importable here: {e}")

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "config_dataset2.json"

# Published H100 SXM peaks (NVIDIA data sheet, dense): the card's least time
# for a piece of work is the largest of bytes / HBM rate, operations / rate
# and exponentials / rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; f32 CUDA cores
# Exponentials: 16 a clock on each of the 132 SMs (the special-function
# units' ex2; CUDA C++ Programming Guide, arithmetic-instruction throughput
# table, compute capability 9.0) at the 1980 MHz boost clock that nvidia-smi
# read on the card under load
EXP_PER_S = 132 * 16 * 1.98e9

# (C, N) of the 7 PreNormResidual(LinearAttention) blocks of one ds2 U-Net
# call, in call order: down levels, middle, up levels
DS2_ATTENTION_BLOCKS = [(32, 6480), (64, 736), (32, 96), (32, 96), (64, 96), (32, 736),
                        (32, 6480)]
BATCH = 128
D = 32  # dim_head

# The kernels' tolerances against their plain versions, K1_TOL .. K5_TOL
# and K4B_TOL, and their reasons: calodiffusion_tpu_torch/ops/tolerances.py.

# One f32 train step, card (K1, K2, cuDNN; TF32 off) against CPU (plain
# versions, oneDNN), same weights and inputs.  The f32 forward agrees within
# the 2e-4 weight-transfer bound of docs/DESIGN.md:32; the loss is a weighted
# mean of squared residuals, and each gradient chains ~30 layers of f32 sums
# taken in other orders.  Loss: 1e-3 relative.  Gradients: max|card - cpu| /
# (max|cpu| + 1e-3 * G), G the largest gradient entry of the model, so that a
# tensor whose gradient is near zero (a conv bias ahead of a GroupNorm)
# compares at the model's scale: 5e-3.
STEP_LOSS_RTOL = 1e-3
STEP_GRAD_TOL = 5e-3

# Attention(32, heads=4) on the card (K4) against the plain module, same
# form.  f32: K4's bound.  bf16: K4's and the plain version's outputs may
# sit one bf16 ulp apart here and there, and the module's bf16 output conv
# sums 128 of them and rounds again; outputs are under 0.5 in magnitude, so
# allow four ulps at that scale: 4e-3 + 2^-7 relative.
ATTENTION_MODULE_TOL = {torch.bfloat16: (4e-3, 2.0**-7), torch.float32: (1e-4, 0.0)}
# LinearAttention(32)'s f32 gradients on the ds3 grid, its forward through
# K3, against the plain f32 module's, in max-norm relative error.  Both
# backward through autograd of the plain version, so they differ only
# through K3's forward output, which the post-GroupNorm backward reads; at
# the module's default init the post-GroupNorm divides by y's small spread,
# and K3 sums ctx in another order than the CPU and cuBLAS: 3.0e-4 on the
# CPU (scripts/torch_linear_attention_conditioning.py, batch 2, K3 under the
# g++ emulation), 3.7e-4 on the card over 64 samples: 1e-3.
# The bf16 gradients are not held to a limit.  The attention's part of y
# spreads 0.006 over positions, below one bf16 ulp of y, so the plain bf16
# module's own gradients lie 0.7-1.6 from float64, whatever the forward;
# scaling to_qkv's weight by 4 widens the spread to 0.3-0.5 and still leaves
# them 0.02-0.24 off over six seeds (the same script, --qkv-gain 4), while
# K3's bf16 forward is held elementwise above.  They must be finite.
K3_GRAD_TOL_F32 = 1e-3
# Attention(32, heads=4)'s f32 gradients on (4, 32, 45, 50, 18) through K4
# and its backward kernel against the plain module's (the dense
# formulation, its gradient chunk by chunk), in max-norm relative error:
# the kernels differ from the plain versions within K4_TOL and K4B_TOL, and
# the two 1x1 convs around them (cuDNN, TF32 off) only sum in other orders:
# K4B_TOL's f32 bound.  The bf16 gradients must be finite.
ATTENTION_GRAD_TOL_F32 = K4B_TOL[torch.float32]

# dataset 3's full-resolution grid (configs/config_dataset3.json: SHAPE_FINAL
# 45 x 50 x 18, LAYER_SIZE_UNET[0] = 32)
DS3_GRID = (45, 50, 18)
DS3_N = 45 * 50 * 18
DS3_BATCH = 64
# K4's shapes (B, H, N): scripts/pallas_tpu_check.py:42-55, N = 736 (ds2
# level 1, below the JAX entry's dense limit of 2048, where the port runs K4
# too), and the Attention(32, heads=4) call of the variants path at batch 4
K4_SHAPES = [(1, 8, 4096), (2, 4, 736), (1, 4, DS3_N), (4, 4, DS3_N)]
# and q scaled by 8 at the first: a peaked softmax, a few keys carry the weight
K4_PEAKED = (1, 8, 4096)
ATTENTION_BATCH = 4
# K5's shapes (channels-last), groups 8: ds2 level 0 and 2, ds3 level 0
K5_SHAPES = [(BATCH, 45, 16, 9, 32), (BATCH, 23, 8, 4, 64), (DS3_BATCH, *DS3_GRID, 32)]

REPLACES = {
    "fused_attention_block": "calodiffusion_tpu/ops/pallas_linear_attention.py:240",
    "attention_block_backward": "calodiffusion_tpu/ops/pallas_linear_attention.py:407",
    "fused_linear_attention": "calodiffusion_tpu/ops/pallas_linear_attention.py:94",
    "blockwise_attention": "calodiffusion_tpu/ops/pallas_attention.py:35",
    "blockwise_attention_backward": (
        "calodiffusion_tpu/ops/pallas_attention.py:35 (forward only: the JAX package has no "
        "Pallas VJP and differentiates _dense_attention, :70-77)"),
    "groupnorm_silu": "calodiffusion_tpu/ops/pallas_groupnorm.py:27",
}
SOURCES = {
    "fused_attention_block": "calodiffusion_tpu_torch/csrc/linear_attention_block.cu",
    "attention_block_backward": "calodiffusion_tpu_torch/csrc/linear_attention_block_bwd.cu",
    "fused_linear_attention": "calodiffusion_tpu_torch/csrc/linear_attention.cu",
    "blockwise_attention": "calodiffusion_tpu_torch/csrc/blockwise_attention.cu",
    "blockwise_attention_backward": "calodiffusion_tpu_torch/csrc/blockwise_attention_bwd.cu",
    "groupnorm_silu": "calodiffusion_tpu_torch/csrc/groupnorm_silu.cu",
}


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


# cycles the card spins before each call that device_ms times (~1 ms at the
# H100's clocks, longer than the host takes to launch any kernel here)
SPIN_CYCLES = 2_000_000


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of one call of ``fn``, without the host's launch:
    the card first spins (``torch.cuda._sleep``), so the host has enqueued
    the call before its start event runs.  Where the host takes longer to
    launch a kernel than the card to run it, ``time_ms`` times the host;
    this times the kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


def bound_ms(nbytes, flops, dtype, exps=0, flop_rate=None):
    """(bound ms, bound_by, term): the largest of bytes over the HBM rate,
    FLOPs over the peak for the dtype (or ``flop_rate``) and exponentials
    over the special-function units' rate; bound_by is "bytes" or
    "operations", term names the largest ("bytes", "flops" or "exp")."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "flops": flops / (flop_rate or PEAK_FLOPS[dtype]),
             "exp": exps / EXP_PER_S}
    term = max(terms, key=terms.get)
    return 1e3 * terms[term], "bytes" if term == "bytes" else "operations", term


def attention_bound(B, N, C, dtype):
    """x + GN(LinAttn(GN(x))): x read once, out written once, weights read
    once; the matrix products' operations."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * N * C * elt + (C * 96 + 32 * C) * elt + 5 * C * 4
    flops = 2 * B * N * (96 * C + 32 * 32 + 32 * 32 + 32 * C)
    return bound_ms(nbytes, flops, dtype)


def backward_bound(B, N, C, dtype):
    """Its backward: x and g read once, dx written once, the weights read
    once and their gradients written once; the products of the Pallas
    kernel's body (pallas_linear_attention.py:457-650): 12 of (C x D) and 8
    of (D x D) per position."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 3 * B * N * C * elt + 2 * ((C * 96 + 32 * C) * elt + 5 * C * 4)
    flops = 2 * B * N * (12 * C * D + 8 * D * D)
    return bound_ms(nbytes, flops, dtype)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_attention_kernel(attn):
    """K1 vs plain version at every ds2 (C, N), B=128, bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for C, N in sorted(set(DS2_ATTENTION_BLOCKS)):
            args = block_inputs(BATCH, N, C, dtype, seed=C + N)
            got = attn.fused_attention_block(*args)
            torch.cuda.synchronize()
            want = attn.attention_block_reference(*args)
            atol, rtol = K1_TOL[dtype]
            err = elementwise_err("fused_attention_block", got, want, K1_TOL[dtype],
                                  f"C={C}, N={N}, {dtype}")
            k_ms = time_ms(lambda: attn.fused_attention_block(*args))
            d_ms = device_ms(lambda: attn.fused_attention_block(*args))
            p_ms = time_ms(lambda: attn.attention_block_reference(*args))
            b_ms, b_by, _ = attention_bound(BATCH, N, C, dtype)
            plan = attn.cluster_plan(args[0])
            cases.append(dict(
                name="fused_attention_block", shape=[BATCH, N, C], dtype=dtype_name(dtype),
                max_abs_err=err, tol={"atol": atol, "rtol": rtol}, kernel_ms=k_ms,
                device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                launches_per_call=DS2_ATTENTION_BLOCKS.count((C, N)), cluster_plan=plan,
            ))
            print(f"kernel fused_attention_block B={BATCH} N={N} C={C} {cases[-1]['dtype']}: "
                  f"max_abs_err {err:.3g} (tol {atol} + {rtol} * |plain|), kernel {k_ms:.4f} ms "
                  f"(device {d_ms:.4f}), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"{plan_text(plan)}", flush=True)
    return cases


def plan_text(plan) -> str:
    """A kernel's cluster plan: G, positions a CTA, where each tensor lives."""
    where = ", ".join(f"{k.removesuffix('_resident')} {'on chip' if v else 'in HBM'}"
                      for k, v in plan.items() if k.endswith("_resident"))
    return (f"cluster G={plan['G']}, {plan['P']} positions a CTA, {where}, "
            f"{plan['smem_bytes']} B shared a CTA")


GRAD_NAMES = ("dx", "d_gn_pre_scale", "d_gn_pre_bias", "d_w_qkv", "d_w_out", "d_b_out",
              "d_gn_post_scale", "d_gn_post_bias")


def check_backward_kernel(attn):
    """K2 vs plain backward at every ds2 (C, N), B=128, bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for C, N in sorted(set(DS2_ATTENTION_BLOCKS)):
            args = block_inputs(BATCH, N, C, dtype, seed=C + N + 1)
            g = torch.randn(BATCH, N, C, generator=torch.Generator().manual_seed(N - C))
            g = g.cuda().to(dtype)
            got = attn.attention_block_backward(*args, g)
            torch.cuda.synchronize()
            want = attn.attention_block_backward_reference(*args, g)
            rel = {}
            for name, a, b in zip(GRAD_NAMES, got, want):
                if a.dtype != b.dtype or a.shape != b.shape:
                    fail(f"attention_block_backward {name}: {a.dtype} {tuple(a.shape)}, "
                         f"plain {b.dtype} {tuple(b.shape)}")
                rel[name] = max_norm_rel(a, b)
            worst = max(rel, key=rel.get)
            if not all(np.isfinite(v) for v in rel.values()) or rel[worst] > K2_TOL[dtype]:
                fail(f"attention_block_backward (C={C}, N={N}, {dtype}): {worst} differs from "
                     f"the plain backward by {rel[worst]:.3g} (max-norm relative) > "
                     f"{K2_TOL[dtype]}")
            abs_dx = (got[0].float() - want[0].float()).abs().max().item()
            k_ms = time_ms(lambda: attn.attention_block_backward(*args, g))
            d_ms = device_ms(lambda: attn.attention_block_backward(*args, g))
            p_ms = time_ms(lambda: attn.attention_block_backward_reference(*args, g))
            b_ms, b_by, _ = backward_bound(BATCH, N, C, dtype)
            plan = attn.cluster_plan(args[0], name=attn.BACKWARD_KERNEL)
            cases.append(dict(
                name="attention_block_backward", shape=[BATCH, N, C], dtype=dtype_name(dtype),
                max_abs_err=abs_dx, max_norm_rel_err=rel, tol_max_norm_rel=K2_TOL[dtype],
                kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                launches_per_call=DS2_ATTENTION_BLOCKS.count((C, N)), cluster_plan=plan,
            ))
            print(f"kernel attention_block_backward B={BATCH} N={N} C={C} {cases[-1]['dtype']}: "
                  f"max-norm rel err {rel[worst]:.3g} ({worst}; tol {K2_TOL[dtype]}), dx "
                  f"max_abs_err {abs_dx:.3g}, kernel {k_ms:.4f} ms (device {d_ms:.4f}), plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {plan_text(plan)}", flush=True)
    return cases


def per_call(cases, key, dtype="bfloat16"):
    """Sum of a per-launch number over the 7 attention blocks of one U-Net call."""
    return sum(c[key] * c["launches_per_call"] for c in cases if c["dtype"] == dtype)


def synthetic_loader(batches, n_layers, seed):
    """(E, layers, None) batches as the data loader yields them: normalized
    log-energies in [0, 1) and standardized layer energies."""
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        yield (rng.uniform(0.0, 1.0, (BATCH, 1)).astype(np.float32),
               rng.standard_normal((BATCH, n_layers)).astype(np.float32), None)


def synthetic_batch(batch, n_layers, seed):
    """(E, layers, showers) as the training loader yields them: showers in
    the preprocessed (B, 1, 45, 16, 9) layout, roughly unit scale."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (batch, 1)).astype(np.float32),
            rng.standard_normal((batch, n_layers)).astype(np.float32),
            rng.standard_normal((batch, 1, 45, 16, 9)).astype(np.float32))


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


def check_train_step_card_vs_cpu(cfg, state_dict, seed, attn):
    """One f32 train step's loss and parameter gradients, card against CPU."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    cfg = dict(cfg, PRECISION="f32")
    E, layers, data = synthetic_batch(2, cfg["SHAPE_FINAL"][2] + 1, seed)
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)
    results = []
    for dev in ("cuda", "cpu"):
        m = CaloDiffusion(cfg, device=dev)
        m.load_state_dict(state_dict)
        k2 = attn.attention_block_backward.launches
        loss = m.compute_loss(*(torch.from_numpy(a).to(dev) for a in (data, E)),
                              noise=torch.from_numpy(noise).to(dev),
                              layers=torch.from_numpy(layers).to(dev),
                              rnd_normal=torch.from_numpy(rnd).to(dev))
        loss.backward()
        launched = attn.attention_block_backward.launches - k2
        if launched != (len(DS2_ATTENTION_BLOCKS) if dev == "cuda" else 0):
            fail(f"f32 train step on {dev} launched K2 {launched} times")
        results.append((loss.item(), {k: p.grad.detach().cpu().double()
                                      for k, p in m.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = results
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not np.isfinite(l_card) or loss_rel > STEP_LOSS_RTOL:
        fail(f"f32 train-step loss card {l_card} vs CPU {l_cpu}: {loss_rel:.3g} relative "
             f"> {STEP_LOSS_RTOL}")
    G = max(g.abs().max().item() for g in g_cpu.values())
    errs = {k: ((g_card[k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
            for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    if not all(np.isfinite(v) for v in errs.values()) or errs[worst] > STEP_GRAD_TOL:
        fail(f"f32 train-step gradient {worst} card vs CPU: {errs[worst]:.3g} > {STEP_GRAD_TOL}")
    print(f"train: f32 step card vs CPU: loss {l_card:.6g} vs {l_cpu:.6g} ({loss_rel:.3g} "
          f"relative, tol {STEP_LOSS_RTOL}); {len(errs)} parameter gradients, worst "
          f"{worst} {errs[worst]:.3g}, init_conv.weight {errs['init_conv.weight']:.3g} "
          f"(tol {STEP_GRAD_TOL})", flush=True)
    return dict(loss_rel=loss_rel, worst_grad=worst, worst_grad_err=errs[worst],
                init_conv_weight_err=errs["init_conv.weight"])


def run_training(cfg, args, attn, card):
    """TrainDiffusion.train on the card at full ds2 width: one epoch of
    --train-steps steps on one repeated batch, one val batch."""
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    n_layers = cfg["SHAPE_FINAL"][2] + 1
    batch = synthetic_batch(BATCH, n_layers, args.seed + 2)
    val = [synthetic_batch(BATCH, n_layers, args.seed + 3)]
    steps = []

    # the loss of the train batch with fixed noise and every sample at the
    # log-normal's median sigma, e^-1.2 (no one tiny-sigma sample carries
    # the l2 mean): it must fall over the steps, which draw their own
    E, lay, data = (torch.from_numpy(a).cuda() for a in batch)
    rng = np.random.default_rng(args.seed + 4)
    noise = torch.from_numpy(rng.standard_normal(data.shape).astype(np.float32)).cuda()

    @torch.no_grad()
    def fixed_loss(model):
        return model.compute_loss(data, E, noise=noise, layers=lay,
                                  rnd_normal=torch.zeros(BATCH, device="cuda")).item()

    class Recorded(TrainDiffusion):
        """Records each step's loss, wall time and kernel launches."""

        def train_step(self, data, E, layers):
            k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
            t0 = time.perf_counter()
            loss = super().train_step(data, E, layers)
            torch.cuda.synchronize()
            steps.append(dict(loss=loss.item(), s=time.perf_counter() - t0,
                              k1=attn.fused_attention_block.launches - k1,
                              k2=attn.attention_block_backward.launches - k2))
            return loss

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tcfg = dict(cfg, MAXEPOCH=1, BATCH=BATCH)
        trainer = Recorded(default_flags(checkpoint_folder=ckpt_dir, seed=args.seed), tcfg,
                           loader_train=[batch] * args.train_steps, loader_val=val)
        trainer.init_model()
        fixed_before = fixed_loss(trainer.model)
        torch.cuda.synchronize()
        attn.fused_attention_block.launches = 0
        attn.attention_block_backward.launches = 0
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
        saved = sorted(p.name for p in Path(trainer.checkpoint_folder).iterdir())

    n = len(DS2_ATTENTION_BLOCKS)
    if len(steps) != args.train_steps:
        fail(f"train ran {len(steps)} steps, expected {args.train_steps}")
    if not all(np.isfinite(s["loss"]) for s in steps):
        fail(f"train losses not finite: {[s['loss'] for s in steps]}")
    bad = [i for i, s in enumerate(steps) if (s["k1"], s["k2"]) != (n, n)]
    if bad:
        fail(f"train step {bad[0]} launched K1 {steps[bad[0]]['k1']} and K2 "
             f"{steps[bad[0]]['k2']} times, expected {n} each")
    # every step's 7 + the val batch's forward (7, no backward)
    if (k1, k2) != (n * (args.train_steps + len(val)), n * args.train_steps):
        fail(f"train path launched K1 {k1} and K2 {k2} times")
    for name in ("checkpoint.ckpt", "best_val.ckpt", "final.ckpt", "config.json"):
        if name not in saved:
            fail(f"train wrote {saved}, no {name}")
    fixed_after = fixed_loss(trainer.model)
    if not (np.isfinite([fixed_before, fixed_after]).all()
            and fixed_after < 0.95 * fixed_before):
        fail(f"the fixed-batch loss does not fall 5 % over the steps: {fixed_before} -> "
             f"{fixed_after}")
    cold = steps[0]["s"]
    steady = statistics.mean(s["s"] for s in steps[1:])
    rate = BATCH / steady
    print(f"train: {args.train_steps} steps of {BATCH} ds2 showers, bf16, full width: "
          f"first (cold) step {cold:.3f} s, steady {1e3 * steady:.2f} ms/step, "
          f"{rate:.1f} train samples/s on {card}; TrainDiffusion.train {wall:.2f} s; "
          f"K1 launches {k1}, K2 launches {k2} ({n} each per step); losses "
          f"{steps[0]['loss']:.4g} .. {steps[-1]['loss']:.4g}; fixed-batch loss "
          f"{fixed_before:.4g} -> {fixed_after:.4g}", flush=True)

    return dict(steps=steps, cold_step_s=cold, steady_step_s=steady, samples_per_s=rate,
                k1=k1, k2=k2, fixed_batch_loss=(fixed_before, fixed_after),
                state_dict={k: v.detach().cpu() for k, v in trainer.model.state_dict().items()})


# ---------------------------------------------------------------------------
# 6. variants: K3, K4, K5 and the entries that run them
# ---------------------------------------------------------------------------

def elementwise_err(name, got, want, tol, what):
    """Max |got - want|; fails beyond atol + rtol * |want| or if not finite."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not np.isfinite(err) or (diff > atol + rtol * want.float().abs()).any():
        fail(f"{name} ({what}) differs from its plain version by up to {err:.3g}, beyond "
             f"{atol} + {rtol} * |plain|")
    return err


def case_line(name, shape, dtype, err, tol, k_ms, p_ms, bound, extra=""):
    b_ms, b_by, term = bound
    print(f"kernel {name} {shape} {dtype_name(dtype)}: max_abs_err {err:.3g} (tol {tol[0]} + "
          f"{tol[1]} * |plain|), kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({term}){extra}", flush=True)
    return dict(name=name, shape=list(shape), dtype=dtype_name(dtype), max_abs_err=err,
                tol={"atol": tol[0], "rtol": tol[1]}, kernel_ms=k_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, bound_term=term)


def linear_inputs(B, N, C, dtype, seed):
    """x, w_qkv, w_out, b_out of one LinearAttention on the card."""
    g = torch.Generator().manual_seed(seed)
    x, wqkv, wout, bout = (torch.randn(B, N, C, generator=g), 0.2 * torch.randn(C, 96, generator=g),
                           0.2 * torch.randn(32, C, generator=g), 0.1 * torch.randn(C, generator=g))
    return [x.cuda().to(dtype), wqkv.cuda().to(dtype), wout.cuda().to(dtype), bout.cuda()]


def linear_bound(B, N, C, dtype):
    """LinearAttention alone: x read and y written once, the weights read
    once; the four products; 64 exponentials a position (two softmaxes)."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 2 * B * N * C * elt + (C * 96 + 32 * C) * elt + C * 4
    flops = 2 * B * N * (96 * C + 32 * 32 + 32 * 32 + 32 * C)
    return bound_ms(nbytes, flops, dtype, exps=64 * B * N)


def check_linear_kernel(la):
    """K3 vs plain version at every ds2 (C, N), B = 128, and ds3 level 0."""
    cases = []
    shapes = [(BATCH, N, C) for C, N in sorted(set(DS2_ATTENTION_BLOCKS))]
    shapes.append((DS3_BATCH, DS3_N, 32))
    for dtype in (torch.bfloat16, torch.float32):
        for B, N, C in shapes:
            args = linear_inputs(B, N, C, dtype, seed=B + N + C)
            got = la.linear_attention_forward(*args)
            torch.cuda.synchronize()
            want = la.linear_attention_reference(*args)
            err = elementwise_err("fused_linear_attention", got, want, K3_TOL[dtype],
                                  f"B={B} N={N} C={C} {dtype}")
            k_ms = time_ms(lambda: la.linear_attention_forward(*args))
            d_ms = device_ms(lambda: la.linear_attention_forward(*args))
            p_ms = time_ms(lambda: la.linear_attention_reference(*args))
            plan = la.cluster_plan(args[0], name=la.LINEAR_KERNEL)
            cases.append(case_line("fused_linear_attention", (B, N, C), dtype, err,
                                   K3_TOL[dtype], k_ms, p_ms, linear_bound(B, N, C, dtype),
                                   extra=f", device {d_ms:.4f} ms; {plan_text(plan)}"))
            cases[-1].update(device_ms=d_ms, cluster_plan=plan)
    return cases


def blockwise_bound(B, H, N, dtype):
    """Softmax attention: q, k, v read and out written once; 4 D FLOPs and
    one exponential a score (pallas_attention.py:51-62)."""
    elt = torch.finfo(dtype).bits // 8
    return bound_ms(4 * B * H * N * D * elt, 4 * D * B * H * N * N, dtype, exps=B * H * N * N)


def dense_rows(B, H, N):
    """Query rows a chunk of the plain version takes: about 2 GB of f32
    scores at a time."""
    return max(1, (1 << 29) // (B * H * N))


def check_blockwise_kernel(att):
    """K4 vs plain version, through the entry, with SDPA timed beside it."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for (B, H, N), gain in [(shape, 1) for shape in K4_SHAPES] + [(K4_PEAKED, 8)]:
            g = torch.Generator().manual_seed(B + H + N)
            q, k, v = (torch.randn(B, H, N, D, generator=g).cuda().to(dtype) for _ in range(3))
            q = (q.float() * gain).to(dtype)  # gain 8: a peaked softmax
            before = att.blockwise_attention.launches
            got = att.blockwise_attention(q, k, v)
            torch.cuda.synchronize()
            if att.blockwise_attention.launches != before + 1:
                fail(f"blockwise_attention (N={N}) did not launch K4 once")
            rows = dense_rows(B, H, N)
            want = att.dense_attention(q, k, v, q_rows=rows)
            err = elementwise_err("blockwise_attention", got, want, K4_TOL[dtype],
                                  f"B={B} H={H} N={N} q x {gain} {dtype}")
            big = N > 8192
            reps = dict(warmup=1, reps=5) if big else {}
            k_ms = time_ms(lambda: att.blockwise_attention_forward(q, k, v), **reps)
            d_ms = device_ms(lambda: att.blockwise_attention_forward(q, k, v),
                             reps=3 if big else 10)
            p_ms = time_ms(lambda: att.dense_attention(q, k, v, q_rows=rows), **reps)
            l_ms = time_ms(lambda: sdpa(q, k, v), **reps)
            cases.append(case_line("blockwise_attention", (B, H, N, D), dtype, err,
                                   K4_TOL[dtype], k_ms, p_ms, blockwise_bound(B, H, N, dtype),
                                   extra=f", device {d_ms:.4f} ms, SDPA {l_ms:.4f} ms, "
                                         f"q x {gain}"))
            cases[-1].update(library_ms=l_ms, q_gain=gain, device_ms=d_ms)
    return cases


def blockwise_backward_bound(B, H, N, dtype):
    """Softmax attention's backward: q, k, v, out and dO read and dq, dk, dv
    written once, lse read once; the least work is one recompute of S and
    the four products dV, dP, dK, dQ (10 D FLOPs) and one exponential a
    score."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = 8 * B * H * N * D * elt + 4 * B * H * N
    return bound_ms(nbytes, 10 * D * B * H * N * N, dtype, exps=B * H * N * N)


def check_blockwise_backward(att):
    """K4's backward vs the plain gradient (chunk by chunk) at K4's shapes,
    through its wrapper from K4's out and lse, with SDPA's backward timed
    beside it; two calls must agree bit for bit."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for (B, H, N), gain in [(shape, 1) for shape in K4_SHAPES] + [(K4_PEAKED, 8)]:
            g = torch.Generator().manual_seed(B + H + N + 1)
            q, k, v, dout = (torch.randn(B, H, N, D, generator=g).cuda().to(dtype)
                             for _ in range(4))
            q = (q.float() * gain).to(dtype)
            out, lse = att.blockwise_attention_forward(q, k, v, with_lse=True)
            before = att.blockwise_attention.backward_launches
            got = att.blockwise_attention_backward(q, k, v, out, lse, dout)
            again = att.blockwise_attention_backward(q, k, v, out, lse, dout)
            torch.cuda.synchronize()
            if att.blockwise_attention.backward_launches != before + 2:
                fail(f"blockwise_attention_backward (N={N}) did not launch its kernel")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"blockwise_attention_backward (N={N}, {dtype}): two calls differ")
            rows = dense_rows(B, H, N)
            want = att.attention_backward_reference(q, k, v, dout, rows)
            rel = dict(zip(("dq", "dk", "dv"), (max_norm_rel(a, b) for a, b in zip(got, want))))
            worst = max(rel, key=rel.get)
            if not all(np.isfinite(e) for e in rel.values()) or rel[worst] > K4B_TOL[dtype]:
                fail(f"blockwise_attention_backward (B={B} H={H} N={N} q x {gain} {dtype}): "
                     f"{worst} differs from the plain gradient by {rel[worst]:.3g} (max-norm "
                     f"relative) > {K4B_TOL[dtype]}")
            abs_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            big = N > 8192
            reps = dict(warmup=1, reps=3) if big else {}
            k_ms = time_ms(lambda: att.blockwise_attention_backward(q, k, v, out, lse, dout),
                           **reps)
            d_ms = device_ms(lambda: att.blockwise_attention_backward(q, k, v, out, lse, dout),
                             reps=3 if big else 10)
            p_ms = time_ms(lambda: att.attention_backward_reference(q, k, v, dout, rows), **reps)
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            lib_out = sdpa(ql, kl, vl)
            l_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout,
                                                       retain_graph=True), **reps)
            del lib_out
            b_ms, b_by, term = blockwise_backward_bound(B, H, N, dtype)
            print(f"kernel blockwise_attention_backward {(B, H, N, D)} {dtype_name(dtype)}: "
                  f"max-norm rel err {rel[worst]:.3g} ({worst}; tol {K4B_TOL[dtype]}), "
                  f"max_abs_err {abs_err:.3g}, kernel {k_ms:.4f} ms, device {d_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms, SDPA backward {l_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({term}), q x {gain}; two calls bitwise equal", flush=True)
            cases.append(dict(
                name="blockwise_attention_backward", shape=[B, H, N, D], dtype=dtype_name(dtype),
                max_abs_err=abs_err, max_norm_rel_err=rel, tol_max_norm_rel=K4B_TOL[dtype],
                kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, bound_term=term, q_gain=gain, deterministic=True))
    return cases


def gn_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    return (torch.randn(*shape, generator=g).add_(0.5).cuda().to(dtype),
            (1.0 + 0.1 * torch.randn(C, generator=g)).cuda(),
            (0.1 * torch.randn(C, generator=g)).cuda())


def gn_bound(shape, dtype):
    """GroupNorm + SiLU: x read and out written once; ~10 FLOPs on the CUDA
    cores and one exponential an element."""
    elt = torch.finfo(dtype).bits // 8
    n = int(np.prod(shape))
    return bound_ms(2 * n * elt + 2 * shape[-1] * 4, 10 * n, dtype, exps=n,
                    flop_rate=PEAK_FLOPS[torch.float32])


def check_groupnorm_kernel(gn):
    """K5 vs plain version at ds2 levels 0 and 2 and ds3 level 0, groups 8."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in K5_SHAPES:
            x, sc, bi = gn_inputs(shape, dtype, seed=sum(shape))
            got = gn.groupnorm_silu_forward(x, sc, bi, 8)
            again = gn.groupnorm_silu_forward(x, sc, bi, 8)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"groupnorm_silu ({shape}, {dtype}): two calls differ")
            want = gn.gn_silu_reference(x, sc, bi, 8)
            err = elementwise_err("groupnorm_silu", got, want, K5_TOL[dtype],
                                  f"{shape} {dtype}")
            k_ms = time_ms(lambda: gn.groupnorm_silu_forward(x, sc, bi, 8))
            d_ms = device_ms(lambda: gn.groupnorm_silu_forward(x, sc, bi, 8))
            p_ms = time_ms(lambda: gn.gn_silu_reference(x, sc, bi, 8))
            # two PyTorch calls on a channels-first copy (weights in x's dtype)
            x_cf = x.movedim(-1, 1).contiguous()
            sc_x, bi_x = sc.to(dtype), bi.to(dtype)
            two_ms = time_ms(lambda: F.silu(F.group_norm(x_cf, 8, sc_x, bi_x)))
            cases.append(case_line("groupnorm_silu", shape, dtype, err, K5_TOL[dtype], k_ms,
                                   p_ms, gn_bound(shape, dtype),
                                   extra=f", device {d_ms:.4f} ms, F.silu(F.group_norm) on "
                                         f"channels-first (two calls) {two_ms:.4f} ms; two "
                                         f"calls bitwise equal"))
            cases[-1].update(device_ms=d_ms, two_call_ms=two_ms, deterministic=True)
    return cases


def max_norm_rel(a, b):
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def run_variants_path(seed, la, att, gn, nn_modules):
    """The variants path, in bf16 and f32: LinearAttention(32) forward and
    backward on the ds3 grid, Attention(32, heads=4) forward and backward on
    (4, 32, 45, 50, 18), groupnorm_silu at K5_SHAPES.  Launch counts are
    reset just before each dtype's run and read just after; the outputs
    and gradients are then held against the plain modules."""
    from unittest import mock

    # (name, entry, counter) of every kernel the path may launch
    counters = (("fused_linear_attention", la.fused_linear_attention, "launches"),
                ("blockwise_attention", att.blockwise_attention, "launches"),
                ("blockwise_attention_backward", att.blockwise_attention, "backward_launches"),
                ("groupnorm_silu", gn.groupnorm_silu, "launches"),
                ("fused_attention_block", la.fused_attention_block, "launches"),
                ("attention_block_backward", la.attention_block_backward, "launches"))
    want = (1, 1, 1, len(K5_SHAPES), 0, 0)
    totals, results = [0] * len(counters), {}
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(seed)
        lin = nn_modules.LinearAttention(32, dtype=dtype, generator=gen).cuda()
        full = nn_modules.Attention(32, heads=4, dtype=dtype, generator=gen).cuda()
        x_lin = torch.randn(DS3_BATCH, 32, *DS3_GRID, generator=gen).cuda().requires_grad_(True)
        x_att = torch.randn(ATTENTION_BATCH, 32, *DS3_GRID, generator=gen).cuda().requires_grad_(True)
        gn_args = [gn_inputs(shape, dtype, seed=seed + i) for i, shape in enumerate(K5_SHAPES)]

        def step(module, x):
            module.zero_grad(set_to_none=True)
            x.grad = None
            out = module(x)
            (out.float() ** 2).mean().backward()
            return out.detach(), [x.grad] + [p.grad for p in module.parameters()]

        torch.cuda.synchronize()
        for _, entry, attr in counters:
            setattr(entry, attr, 0)
        t0 = time.perf_counter()
        lin_out, lin_grads = step(lin, x_lin)
        att_out, att_grads = step(full, x_att)
        gn_outs = [gn.groupnorm_silu(*a, groups=8) for a in gn_args]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = tuple(getattr(entry, attr) for _, entry, attr in counters)
        if launched != want:
            fail(f"variants path ({dtype}) launched "
                 f"{', '.join(name for name, _, _ in counters)} {launched} times, expected {want}")
        totals = [t + n for t, n in zip(totals, launched)]

        # the plain modules: the same modules with K3's and K4's entries
        # replaced by their plain versions (K4's, chunk by chunk, with a
        # backward that keeps one chunk's scores at a time)
        rows = dense_rows(ATTENTION_BATCH, 4, DS3_N)
        with mock.patch.object(nn_modules, "fused_linear_attention",
                               la.linear_attention_reference), \
             mock.patch.object(nn_modules, "blockwise_attention",
                               lambda q, k, v: att.dense_attention(q, k, v, q_rows=rows)):
            ref_out, ref_grads = step(lin, x_lin)
            if dtype == torch.bfloat16:
                lin32 = nn_modules.LinearAttention(32).cuda()
                lin32.load_state_dict(lin.state_dict())
                _, true_grads = step(lin32, x_lin)
            att_ref, att_ref_grads = step(full, x_att)
        if lin_out.shape != x_lin.shape or att_out.shape != x_att.shape:
            fail(f"variants path shapes {tuple(lin_out.shape)}, {tuple(att_out.shape)}")
        lin_err = elementwise_err("LinearAttention", lin_out, ref_out, K3_TOL[dtype],
                                  f"module, {dtype}")
        # against the plain f32 module's gradients: held to K3_GRAD_TOL_F32
        # in f32; in bf16 printed beside the plain bf16 module's own error
        plain_errs = []
        if dtype == torch.float32:
            true_grads, grad_note = ref_grads, f"(tol {K3_GRAD_TOL_F32})"
        else:
            plain_errs = [round(max_norm_rel(a, b), 6) for a, b in zip(ref_grads, true_grads)]
            grad_note = f"(no limit; the plain bf16 module: {plain_errs})"
        for name, grads in (("LinearAttention", lin_grads), ("Attention", att_grads)):
            if not all(g is not None and torch.isfinite(g).all() for g in grads):
                fail(f"{name} ({dtype}): a gradient is missing or not finite")
        grad_errs = [max_norm_rel(a, b) for a, b in zip(lin_grads, true_grads)]
        worst = max(range(len(grad_errs)), key=grad_errs.__getitem__)
        if dtype == torch.float32 and grad_errs[worst] > K3_GRAD_TOL_F32:
            fail(f"LinearAttention gradient {worst} ({dtype}): max-norm relative error "
                 f"{grad_errs[worst]:.3g} > {K3_GRAD_TOL_F32}")
        att_err = elementwise_err("Attention", att_out, att_ref, ATTENTION_MODULE_TOL[dtype],
                                  f"module, {dtype}")
        att_grad_errs = [max_norm_rel(a, b) for a, b in zip(att_grads, att_ref_grads)]
        if dtype == torch.float32 and max(att_grad_errs) > ATTENTION_GRAD_TOL_F32:
            fail(f"Attention gradients ({dtype}): max-norm relative errors {att_grad_errs} > "
                 f"{ATTENTION_GRAD_TOL_F32}")
        att_note = (f"(tol {ATTENTION_GRAD_TOL_F32})" if dtype == torch.float32
                    else "(no limit: finite)")
        gn_err = max(elementwise_err("groupnorm_silu", o, gn.gn_silu_reference(*a, 8),
                                     K5_TOL[dtype], f"path, {dtype}")
                     for o, a in zip(gn_outs, gn_args))
        results[dtype_name(dtype)] = dict(
            wall_s=wall, launches=dict(zip((name for name, _, _ in counters), launched)),
            linear_attention_err=lin_err,
            linear_attention_grad_errs=grad_errs,
            linear_attention_grad_tol=K3_GRAD_TOL_F32 if dtype == torch.float32 else None,
            plain_module_grad_errs=plain_errs,
            attention_err=att_err, attention_grad_errs=att_grad_errs,
            attention_grad_tol=ATTENTION_GRAD_TOL_F32 if dtype == torch.float32 else None,
            gn_err=gn_err)
        print(f"variants ({dtype_name(dtype)}): LinearAttention(32) fwd+bwd on "
              f"{tuple(x_lin.shape)}, Attention(32, heads=4) fwd+bwd on "
              f"{tuple(x_att.shape)}, groupnorm_silu x {len(K5_SHAPES)}: "
              f"{wall:.3f} s; launches K3 {launched[0]}, K4 {launched[1]}, K4 backward "
              f"{launched[2]}, K5 {launched[3]}; vs plain modules: LinearAttention out "
              f"{lin_err:.3g}, gradients (max-norm rel"
              f"{'' if dtype == torch.float32 else ' to the f32 plain module'}) "
              f"{[round(e, 6) for e in grad_errs]} {grad_note}, "
              f"Attention out {att_err:.3g}, gradients {[round(e, 6) for e in att_grad_errs]} "
              f"{att_note}, groupnorm_silu {gn_err:.3g}", flush=True)
    return dict(zip((name for name, _, _ in counters), totals)), results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    t_start = time.perf_counter()
    try:
        from calodiffusion_tpu_torch.models import nn_modules
        from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
        from calodiffusion_tpu_torch.ops import attention as att
        from calodiffusion_tpu_torch.ops import cuda_build
        from calodiffusion_tpu_torch.ops import groupnorm as gn
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
    builds = attn.BUILDS + att.KERNEL.builds + att.BACKWARD_KERNEL.builds + gn.KERNEL.builds
    cuda_build.build_all(builds)
    print(f"build: {len(builds)} kernel variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, defines in builds:
        log = cuda_build.library_path(name, defines).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"build: {name}.cu {' '.join(defines)}: {line.strip()}", flush=True)
    k4b_lib = cuda_build.library_path(*att.BACKWARD_KERNEL.builds[0])  # bf16
    hgmma = cuda_build.sass_count(k4b_lib, "HGMMA")
    print(f"build: {k4b_lib.name}: {hgmma} HGMMA (wgmma) instructions", flush=True)
    if hgmma == 0:
        fail("K4's bf16 backward holds no wgmma (HGMMA) instruction")

    # 3. kernels
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    k1_cases = check_attention_kernel(attn)
    k2_cases = check_backward_kernel(attn)

    # 4. main path: generation
    cfg = load_config(str(CONFIG))
    model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(args.seed))
    n_layers = cfg["SHAPE_FINAL"][2] + 1
    loader = list(synthetic_loader(args.batches, n_layers, args.seed))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = 0
    attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    showers, energies = model.generate(loader, args.steps, generator=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen_launches = (attn.fused_attention_block.launches, attn.attention_block_backward.launches)
    n = args.batches * BATCH
    if showers.shape != (n, 6480) or energies.shape != (n, 1):
        fail(f"showers {showers.shape}, energies {energies.shape}; expected ({n}, 6480), ({n}, 1)")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail("showers are not finite and >= 0")
    want = len(DS2_ATTENTION_BLOCKS) * args.steps * args.batches
    if gen_launches != (want, 0):
        fail(f"generation launched K1 {gen_launches[0]} times (expected {want}) and K2 "
             f"{gen_launches[1]} (expected 0)")
    print(f"main: {n} ds2 showers, {args.steps}-step DDim, bf16, batch {BATCH}: {wall:.2f} s, "
          f"{n / wall:.3f} showers/s on {card}; fused_attention_block launches "
          f"{gen_launches[0]}", flush=True)
    check_card_vs_cpu(cfg, model.state_dict(), args.seed + 1)

    # 5. train path
    train = run_training(cfg, args, attn, card)
    step_check = check_train_step_card_vs_cpu(cfg, train.pop("state_dict"), args.seed + 5, attn)

    # 6. variants
    t0 = time.perf_counter()
    k3_cases = check_linear_kernel(attn)
    k4_cases = check_blockwise_kernel(att)
    k4b_cases = check_blockwise_backward(att)
    k5_cases = check_groupnorm_kernel(gn)
    var_launches, var_results = run_variants_path(args.seed + 6, attn, att, gn, nn_modules)
    print(f"variants: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. result
    launches = {"fused_attention_block": (gen_launches[0], train["k1"]),
                "attention_block_backward": (gen_launches[1], train["k2"])}
    kernels = []
    for name, cases in (("fused_attention_block", k1_cases),
                        ("attention_block_backward", k2_cases)):
        bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            # launches on this slice's path, TrainDiffusion.train
            launches=launches[name][1],
            launches_by_path={"generate": launches[name][0], "train": launches[name][1],
                              "variants": var_launches[name]},
            max_abs_err=max(c["max_abs_err"] for c in bf16),
            # times of the 7 launches of one ds2 U-Net call, B=128, bf16
            ms=per_call(cases, "kernel_ms"), plain_ms=per_call(cases, "plain_ms"),
            device_ms=per_call(cases, "device_ms"),
            bound_ms=per_call(cases, "bound_ms"),
            bound_by="bytes" if all(c["bound_by"] == "bytes" for c in bf16) else "operations",
            library_ms=None, launches_per_call=len(DS2_ATTENTION_BLOCKS),
            launches_per_train_step=len(DS2_ATTENTION_BLOCKS), cases=cases,
        ))
    # K3-K5 and K4's backward: the times of their launches in one bf16 run
    # of the variants path
    path_shapes = {"fused_linear_attention": [[DS3_BATCH, DS3_N, 32]],
                   "blockwise_attention": [[ATTENTION_BATCH, 4, DS3_N, D]],
                   "blockwise_attention_backward": [[ATTENTION_BATCH, 4, DS3_N, D]],
                   "groupnorm_silu": [list(sh) for sh in K5_SHAPES]}
    for name, cases in (("fused_linear_attention", k3_cases), ("blockwise_attention", k4_cases),
                        ("blockwise_attention_backward", k4b_cases),
                        ("groupnorm_silu", k5_cases)):
        bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
        on_path = [c for c in bf16 if c["shape"] in path_shapes[name] and c.get("q_gain", 1) == 1]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=var_launches[name],
            launches_by_path={"generate": 0, "train": 0, "variants": var_launches[name]},
            max_abs_err=max(c["max_abs_err"] for c in bf16),
            ms=sum(c["kernel_ms"] for c in on_path), plain_ms=sum(c["plain_ms"] for c in on_path),
            device_ms=sum(c["device_ms"] for c in on_path),
            bound_ms=sum(c["bound_ms"] for c in on_path),
            bound_by="bytes" if all(c["bound_by"] == "bytes" for c in on_path) else "operations",
            library_ms=(sum(c["library_ms"] for c in on_path)
                        if name.startswith("blockwise_attention") else None),
            path_shapes=path_shapes[name], cases=cases,
        ))
        if name == "groupnorm_silu":  # two PyTorch calls, so not a library time
            kernels[-1]["two_call_ms"] = sum(c["two_call_ms"] for c in on_path)
        if name == "blockwise_attention_backward":
            kernels[-1]["hgmma_instructions"] = hgmma
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "steps"},
                      "train_step_losses": [s["loss"] for s in train["steps"]],
                      "train_step_s": [s["s"] for s in train["steps"]],
                      "card_vs_cpu_step": step_check, "variants": var_results,
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
