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
            shapes of the ds2 paths (batch 128) and of the ds3 paths (K1 at
            batch 128, K2 at batch 64), in bf16 and f32, with their
            times (CUDA events around a call, and the device time with the
            card kept busy while the host launches), the plain versions'
            times and the card's bound: K1 (forward) against
            attention_block_reference_f32 (the plain version in f32 from
            the same values, rounded to bf16; the plain version run in bf16
            printed beside it), K2 (backward) against
            attention_block_backward_reference, each with the cluster size it
            chose and which of its tensors it kept on chip; then K1 and K2 at
            every (C, N) of the two dataset-1 U-Nets (C = 16, 32, 64, 96;
            batch 128) and K3 (LinearAttention alone) at (1610, 16) and
            (28, 96); then K1 and K2 at every (C, N) of the three HGCal
            U-Nets (HGCAL_ATTENTION_BLOCKS; batch 128)
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
6. cli      the data loader and the train and sample CLIs on ds2 and ds3, in a
            temporary directory, with no h5py, click, yaml or matplotlib
            needed: the npz caches _preprocess_one would write (synthetic
            raw showers through preprocessing.preprocess_shower), copies of
            configs/config_dataset{2,3}.json at full width and depth cut to
            one epoch; training.main (ds2: 4 steps of 128 and a val batch;
            ds3: 4 steps of 64), its losses finite, final.ckpt, best_val.ckpt
            and config.json written, K1 and K2 launched 7 times a step
            (counts reset just before), train samples/s from the steps after
            the first; then the sample CLI's parsing, loading and generation
            (inference.parse_flags + generate_showers) of 128 showers with
            400-step DDim, finite, >= 0, (128, 6480) or (128, 40500), K1
            launched 7 times a step and K2 never, showers/s with the first
            (cold) denoise apart; on ds2 once more with --sample-algo DPMPP2M
            --sample-steps 20 (K1 7 times each of its 19 evaluations);
            write_out and a read back where h5py is installed, else a line
            saying it did not run
7. samplers the rest of the sampler zoo on the card: the 13 samplers that
            need no trained theta, in registry order, through
            CaloDiffusion.generate at ds2's full width (bf16, one batch of
            128, the phase-4 weights; 10 steps, Consistency 4; ETA 1 for the
            three SDE samplers, so their noise paths run): showers finite,
            >= 0, (128, 6480); network evaluations counted (the counts
            tests/test_torch_port_samplers.py pins on the CPU; DPMAdaptive's
            three a try, its accepted and rejected steps printed, and more
            than 1000 evaluations fail the phase as a hang guard); K1 7 times
            an evaluation and K2 never (counts reset before each sampler);
            wall and showers/s printed.  Heun, LMS, DPMPP3MSDE (ETA 1) and
            Consistency in f32 at batch 2, 4 steps, from the same weights,
            start and noise table on the card and on the CPU (plain
            versions): within evaluations x 2e-4 (docs/DESIGN.md:32).  Then
            BespokeNonStationary at ds3's full width
            (configs/config_dataset3.json, seeded weights; its "sigma" time
            embed is defined at the negative sigmas the sampler draws, ds2's
            "log" embed is NaN there in both packages): theta trained on the
            card (4 steps, MAX_ITER 2, one batch of 8 synthetic showers),
            finite and moved from its ones, K1 7 times a denoise and K2 7
            times each denoise theta reaches (the first sees only the data);
            then 128 ds3 showers sampled with it, finite, >= 0, (128, 40500)
8. variants the entries that run the other three kernels, in bf16 and f32:
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
9. cascade  the layer-energy cascade on the cli phase's ds2 caches, at full
            width (configs/config_dataset2.json, bf16 U-Net, f32 layer net,
            batch 128): training.main layer (4 steps and a val batch),
            losses finite, K1 0 times a step and 7 times the val batch (its
            loss is the frozen base U-Net's, as in the JAX package), K2
            never; the base U-Net and the whitening statistics unchanged bit
            for bit, the statistics within 1e-6 of a numpy pass over the
            cache, final.ckpt written; then sample ... layer --layer-model
            (that checkpoint) --model-loc (the cli phase's ds2 U-Net): 128
            showers, 400-step DDim in both stages, finite, >= 0, (128,
            6480), the stage-1 layers finite, K1 7 x 400 and K2 never;
            stage 1's and stage 2's walls apart, showers/s with the cold
            first denoise apart; then the cascade in f32 at batch 2, 4 + 4
            steps, card against CPU from the same weights and starts, within
            evaluations x 2e-4 (docs/DESIGN.md:32)
10. distill consistency distillation of the cli phase's ds2 U-Net on the
            same caches, bf16, batch 128: training.main distill
            --teacher-loc (4 steps and a val batch), losses finite, K1 28
            times a step (teacher twice, target, student) and K2 7 times (the
            student's backward), K1 28 and K2 0 times the val batch, the
            student moved from the teacher and the target from the initial
            weights, ms a step and samples/s from the steps after the first;
            sample ... diffusion --sample-algo Consistency on the distilled
            checkpoint, 4 steps of CONSIS_NSTEPS 100, 128 showers finite and
            >= 0, K1 7 x 4; then one f32 distillation loss and every student
            gradient at batch 2, card against CPU, within phase 5's step
            tolerances
11. ds1     dataset 1 through the in-model NN geometry embed
            (SHOWER_EMBED "orig-NN", PHI_INPUT), photons and pions, in the
            cli phase's directory: synthetic binning XMLs (DS1_BINNING; their
            grid must be each config's SHAPE_FINAL and their voxel count its
            SHAPE_ORIG), npz caches of synthetic showers in the flat orig
            layout, copies of configs/config_dataset1_{photon,pion}.json at
            full width and depth cut to one epoch; training.main (4 steps of
            128 and a val batch) and the sample CLI (128 showers, 400-step
            DDim), as the cli phase checks them: showers finite, >= 0,
            (128, 368) and (128, 533), K1 7 times a step and a denoise, K2 7
            times a train step; then, from the trained weights, one f32
            denoise and one f32 train step (the embed's gradients among
            them) card against CPU, within phase 4's and phase 5's
            tolerances, and generate(roundtrip=True) on the sampling batch:
            (128, 368) and (128, 533), finite, >= 0
12. hgcal   CMS HGCal through the GLaM pre-embed, photons and pions, in the
            cli phase's directory: synthetic geometries (HGCAL_DATA: SHAPE_
            FINAL's layers, exactly MAX_CELLS cells a layer, 2076 and
            22,268, every ring inside the R bins), the pre-embed converter
            (its pseudo-inverses on the card), npz caches of synthetic raw
            showers (n, L, MAX_CELLS) and gen_info through the GLaM encode on
            the card and preprocess_hgcal_shower, as _preprocess_one would
            write them; copies of configs/config_HGCal_{photons,pions}.json
            at full width and depth cut to one epoch; training.main (4 steps
            at the config's BATCH, 256 and 128, and a val batch) and the
            sample CLI (one batch of BATCH, 400-step DDim, microbatches of
            128): showers finite, >= 0, (256, 47, 2076) and (128, 47,
            22,268), K1 7 times a step and a denoise, K2 7 times a train
            step; the GLaM walls apart (converter init, cache encode, the
            decode in reverse_norm_hgcal).  On photons the sample CLI once
            more with --sparse-decoding: each layer's energy at its target
            in both runs and the same in both within 1e-4 where the layer
            rescale applies (check_sparse_decoding), every lit cell one a
            decode weight reaches; then the in-model trainable GLaM
            (SHOWER_EMBED "NN") on the photon geometry: 2 bf16 train steps
            (K1, K2 7 a step), embeder.mat moved only where its mask is set,
            the card's pseudo-inverses within 1e-5 of numpy's, one f32
            denoise and one f32 train step card against CPU (the GLaM
            matrices' gradients among them, their masked entries 0)
13. evaluate the evaluation and optimisation paths on the cli phase's ds2
            caches and U-Net, in its directory: a synthetic ds2 binning XML
            (DS2_BINNING: 6480 voxels, the config's SHAPE_FINAL grid);
            fidelity_metrics on the card (its DNN classifier trains there)
            for every raw synthetic ds2 shower of the caches against the 128
            the cli phase's sample CLI generated: AUC in [0, 1], JSD >= 0,
            FPD and its error finite; one f32 train_classifier card against
            CPU (probabilities within 1e-4); CNNCompare with
            RETRAIN_EVAL_NETWORK (cut: one epoch over 2 batches of 128 of
            the eval caches, NSTEPS 400 -> 10): K1 7 a denoise, K2 never,
            the score finite and <= 0, its .pt weights file written, a fresh
            CNNCompare that loads it scoring alike (1e-6) with the same
            seed, the ComparisonNetwork's f32 logits card against CPU (1e-4,
            TF32 off); then one random-search trial of the optimize CLI
            (-o COUNT FPD CNN, --model diffusion) on a full-width copy of
            the ds2 config with OPTIMIZE {LR, SAMPLER_SETTINGS}, SAMPLER
            DDim and the synthetic binning (cut: MAXEPOCH 1, the cli
            phase's caches, NSTEPS 400 -> 10): the report's params the
            random study's draw, every value finite, not None and not its
            objective's failure(), K1 and K2 7 a train step, K1 7 a denoise
            and K2 none in sampling; the walls of the classifier, the CNN
            and the trial (its training and each objective apart)
14. result  {"kernels": [...]} (each kernel's launches by path: generate,
            train, the cli paths, samplers, bns, variants, cascade_train,
            cascade_sample, distill_train, distill_val, distill_sample,
            ds1_photon_train, ds1_photon_sample, ds1_pion_train,
            ds1_pion_sample, hgcal_photons_train, hgcal_photons_sample,
            hgcal_photons_sparse_sample, hgcal_glam_train, hgcal_pions_train,
            hgcal_pions_sample, evaluate_cnn_sample, optimize_train,
            optimize_sample; K1's and K2's "launches" sum the last three,
            this slice's paths; their "ds1" and "hgcal" hold one U-Net
            call's times of each config) and, last, {"ok": true, "device":
            {...}}
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
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
# and of one ds3 U-Net call (configs/config_dataset3.json: 45 x 50 x 18,
# widths [32, 32, 32, 32])
DS3_ATTENTION_BLOCKS = [(32, 40500), (32, 5175), (32, 576), (32, 576), (32, 576), (32, 5175),
                        (32, 40500)]
# and of dataset 1's (configs/config_dataset1_{photon,pion}.json through the
# embed: photons (5, 10, 30), widths [32, 32, 64, 96]; pions (7, 10, 23),
# widths [16, 16, 16, 32]; compress Z halves Z rounding up)
DS1_ATTENTION_BLOCKS = {
    "photon": [(32, 1500), (64, 225), (96, 28), (96, 28), (64, 28), (32, 225), (32, 1500)],
    "pion": [(16, 1610), (16, 220), (32, 20), (32, 20), (16, 20), (16, 220), (16, 1610)],
}
# and of HGCal's (configs/config_HGCal{,_photons,_pions}.json: grids (28, 12,
# 21), (47, 12, 21), (47, 12, 48), widths [32, 32, 64, 96]; the (3, 4, 4)
# stride-2 downsampling with compress Z halves each dimension rounding up)
HGCAL_ATTENTION_BLOCKS = {
    "hgcal": [(32, 7056), (64, 840), (96, 105), (96, 105), (64, 105), (32, 840), (32, 7056)],
    "hgcal_photons": [(32, 11844), (64, 1440), (96, 180), (96, 180), (64, 180), (32, 1440),
                      (32, 11844)],
    "hgcal_pions": [(32, 27072), (64, 3456), (96, 432), (96, 432), (64, 432), (32, 3456),
                    (32, 27072)],
}
# the 7 blocks of each U-Net the cli, ds1 and hgcal phases drive, by name
ATTENTION_BLOCKS = {"ds2": DS2_ATTENTION_BLOCKS, "ds3": DS3_ATTENTION_BLOCKS,
                    **{f"ds1_{part}": b for part, b in DS1_ATTENTION_BLOCKS.items()},
                    **HGCAL_ATTENTION_BLOCKS}
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


# fewer timed calls where a call takes milliseconds (ds3's N = 40,500)
BIG_N_REPS = dict(warmup=2, reps=7)


def check_attention_kernel(attn, blocks=DS2_ATTENTION_BLOCKS, B=BATCH, dataset="ds2"):
    """K1 vs plain version at every (C, N) of ``blocks``, bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for C, N in sorted(set(blocks)):
            args = block_inputs(B, N, C, dtype, seed=C + N)
            got = attn.fused_attention_block(*args)
            torch.cuda.synchronize()
            want = attn.attention_block_reference_f32(*args)
            atol, rtol = K1_TOL[dtype]
            err = elementwise_err("fused_attention_block", got, want, K1_TOL[dtype],
                                  f"C={C}, N={N}, {dtype}")
            # for the record: the plain version run in the kernel's dtype
            plain = attn.attention_block_reference(*args).float()
            err_plain = (got.float() - plain).abs().max().item()
            plain_off = (plain - want.float()).abs().max().item()
            reps = BIG_N_REPS if N > 8192 else {}
            k_ms = time_ms(lambda: attn.fused_attention_block(*args), **reps)
            d_ms = device_ms(lambda: attn.fused_attention_block(*args), reps=5 if reps else 10)
            p_ms = time_ms(lambda: attn.attention_block_reference(*args), **reps)
            b_ms, b_by, _ = attention_bound(B, N, C, dtype)
            plan = attn.cluster_plan(args[0])
            cases.append(dict(
                name="fused_attention_block", dataset=dataset, shape=[B, N, C],
                dtype=dtype_name(dtype), max_abs_err=err, tol={"atol": atol, "rtol": rtol},
                kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                launches_per_call=blocks.count((C, N)), cluster_plan=plan,
                max_abs_err_vs_plain_in_dtype=err_plain, plain_in_dtype_vs_f32=plain_off,
            ))
            print(f"kernel fused_attention_block B={B} N={N} C={C} {cases[-1]['dtype']}: "
                  f"max_abs_err {err:.3g} (tol {atol} + {rtol} * |plain|; against the plain "
                  f"version run in {cases[-1]['dtype']} {err_plain:.3g}, which lies "
                  f"{plain_off:.3g} from it), kernel {k_ms:.4f} ms "
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


def check_backward_kernel(attn, blocks=DS2_ATTENTION_BLOCKS, B=BATCH, dataset="ds2"):
    """K2 vs plain backward at every (C, N) of ``blocks``, bf16 and f32."""
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for C, N in sorted(set(blocks)):
            args = block_inputs(B, N, C, dtype, seed=C + N + 1)
            g = torch.randn(B, N, C, generator=torch.Generator().manual_seed(N - C))
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
            reps = BIG_N_REPS if N > 8192 else {}
            k_ms = time_ms(lambda: attn.attention_block_backward(*args, g), **reps)
            d_ms = device_ms(lambda: attn.attention_block_backward(*args, g),
                             reps=5 if reps else 10)
            p_ms = time_ms(lambda: attn.attention_block_backward_reference(*args, g), **reps)
            b_ms, b_by, _ = backward_bound(B, N, C, dtype)
            plan = attn.cluster_plan(args[0], name=attn.BACKWARD_KERNEL)
            cases.append(dict(
                name="attention_block_backward", dataset=dataset, shape=[B, N, C],
                dtype=dtype_name(dtype), max_abs_err=abs_dx, max_norm_rel_err=rel,
                tol_max_norm_rel=K2_TOL[dtype], kernel_ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by, launches_per_call=blocks.count((C, N)),
                cluster_plan=plan,
            ))
            print(f"kernel attention_block_backward B={B} N={N} C={C} {cases[-1]['dtype']}: "
                  f"max-norm rel err {rel[worst]:.3g} ({worst}; tol {K2_TOL[dtype]}), dx "
                  f"max_abs_err {abs_dx:.3g}, kernel {k_ms:.4f} ms (device {d_ms:.4f}), plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); {plan_text(plan)}", flush=True)
    return cases


def per_call(cases, key, dtype="bfloat16", dataset="ds2"):
    """Sum of a per-launch number over the 7 attention blocks of one U-Net call."""
    return sum(c[key] * c["launches_per_call"] for c in cases
               if c["dtype"] == dtype and c["dataset"] == dataset)


def synthetic_loader(batches, n_layers, seed):
    """(E, layers, None) batches as the data loader yields them: normalized
    log-energies in [0, 1) and standardized layer energies."""
    rng = np.random.default_rng(seed)
    for _ in range(batches):
        yield (rng.uniform(0.0, 1.0, (BATCH, 1)).astype(np.float32),
               rng.standard_normal((BATCH, n_layers)).astype(np.float32), None)


def synthetic_batch(batch, n_layers, seed, shape=(1, 45, 16, 9), n_cond=1):
    """(E, layers, showers) as the training loader yields them: showers in
    the preprocessed layout ``shape`` (ds2's (1, 45, 16, 9); dataset 1's
    flat voxels; HGCal's cells), roughly unit scale; E of ``n_cond``
    columns (HGCal's three gen-info ones)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (batch, n_cond)).astype(np.float32),
            rng.standard_normal((batch, n_layers)).astype(np.float32),
            rng.standard_normal((batch, *shape)).astype(np.float32))


def n_cond(cfg) -> int:
    """The columns of E: HGCal's three gen-info ones, else the energy."""
    return 3 if cfg.get("HGCAL", False) else 1


def data_shape(cfg) -> tuple:
    """A shower's shape as the model takes it: SHAPE_PAD's, or SHAPE_ORIG's
    flat voxels through dataset 1's embed."""
    return tuple(cfg["SHAPE_ORIG" if "orig" in cfg.get("SHOWER_EMBED", "") else "SHAPE_PAD"][1:])


def check_card_vs_cpu(cfg, state_dict, seed, phase="main"):
    """One full-width denoise in f32 on the card (kernels) and on the CPU
    (plain versions) from the same weights and inputs."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    cfg = dict(cfg, PRECISION="f32")
    shape = data_shape(cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, *shape)).astype(np.float32))
    E = torch.from_numpy(rng.uniform(0, 1, (2, n_cond(cfg))).astype(np.float32))
    lay = torch.from_numpy(rng.standard_normal((2, cfg["SHAPE_FINAL"][2] + 1))
                           .astype(np.float32))
    sigma = torch.full((2,) + (1,) * len(shape), 0.7)
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
        fail(f"{phase}: f32 denoise on the card differs from the CPU by {err:.3g} > 2e-4")
    print(f"{phase}: f32 denoise card vs CPU max_abs_err {err:.3g} (tol 2e-4)", flush=True)
    return err


def check_train_step_card_vs_cpu(cfg, state_dict, seed, attn, phase="train"):
    """One f32 train step's loss and parameter gradients (dataset 1's
    embed's or a trainable GLaM's among them), card against CPU; a GLaM
    matrix's gradient must be exactly 0 wherever its mask is."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    cfg = dict(cfg, PRECISION="f32")
    E, layers, data = synthetic_batch(2, cfg["SHAPE_FINAL"][2] + 1, seed, data_shape(cfg),
                                      n_cond(cfg))
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
        for k in ("embeder", "decoder"):  # a trainable GLaM: masked entries get no gradient
            mat = getattr(getattr(m.net, "NN_embed", None), k, None)
            if mat is not None and (mat.mat.grad[mat.mask == 0] != 0).any():
                fail(f"{phase}: NN_embed.{k}.mat has a gradient where its mask is 0 on {dev}")
        results.append((loss.item(), {k: p.grad.detach().cpu().double()
                                      for k, p in m.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = results
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    if not np.isfinite(l_card) or loss_rel > STEP_LOSS_RTOL:
        fail(f"{phase}: f32 train-step loss card {l_card} vs CPU {l_cpu}: {loss_rel:.3g} "
             f"relative > {STEP_LOSS_RTOL}")
    G = max(g.abs().max().item() for g in g_cpu.values())
    errs = {k: ((g_card[k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
            for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    if not all(np.isfinite(v) for v in errs.values()) or errs[worst] > STEP_GRAD_TOL:
        fail(f"{phase}: f32 train-step gradient {worst} card vs CPU: {errs[worst]:.3g} > "
             f"{STEP_GRAD_TOL}")
    embed = {k: v for k, v in errs.items() if k.startswith("NN_embed.")}
    worst_embed = max(embed, key=embed.get) if embed else None
    print(f"{phase}: f32 step card vs CPU: loss {l_card:.6g} vs {l_cpu:.6g} ({loss_rel:.3g} "
          f"relative, tol {STEP_LOSS_RTOL}); {len(errs)} parameter gradients, worst "
          f"{worst} {errs[worst]:.3g}, init_conv.weight {errs['init_conv.weight']:.3g}"
          + (f", the embed's {len(embed)} worst {worst_embed} {embed[worst_embed]:.3g}"
             if embed else "") + f" (tol {STEP_GRAD_TOL})", flush=True)
    return dict(loss_rel=loss_rel, worst_grad=worst, worst_grad_err=errs[worst],
                init_conv_weight_err=errs["init_conv.weight"], n_grads=len(errs),
                worst_embed_grad=worst_embed,
                worst_embed_grad_err=embed[worst_embed] if embed else None)


def run_training(cfg, args, attn, card):
    """TrainDiffusion.train on the card at full ds2 width: one epoch of
    --train-steps steps on one repeated batch, one val batch."""
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    n_layers = cfg["SHAPE_FINAL"][2] + 1
    batch = synthetic_batch(BATCH, n_layers, args.seed + 2)
    val = [synthetic_batch(BATCH, n_layers, args.seed + 3)]

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

    recorder = Recorder(TrainDiffusion.train_step, attn)

    class Recorded(TrainDiffusion):
        """Records each step's loss, wall time and kernel launches."""

        train_step = recorder.bind()

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
    recorder.check("train step", args.train_steps, (n, n))
    steps = recorder.calls
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
# 6. cli: the data loader and the train and sample CLIs, ds2 and ds3
# ---------------------------------------------------------------------------

# Events of each npz cache the cli phase writes: a few train steps at each
# config's BATCH (128 for ds2, 64 for ds3), one val batch for ds2, and one
# sampling batch of 128 (ds3's EVAL is two files of 64: the batcher carries
# the first file's events over into the second's batch)
CLI_DATA = {
    "ds2": dict(config="config_dataset2.json", voxels=6480, batch=128,
                files={"dataset_2_1.hdf5": 512, "dataset_2_val.hdf5": 128,
                       "dataset_2_2.hdf5": 128},
                overrides=dict(VAL_FILES=["dataset_2_val.hdf5"])),
    "ds3": dict(config="config_dataset3.json", voxels=40500, batch=64,
                files={"dataset_3_1.hdf5": 128, "dataset_3_2.hdf5": 128,
                       "dataset_3_3.hdf5": 64, "dataset_3_4.hdf5": 64},
                overrides={}),
}
CLI_SAMPLE_BATCH = 128

# The ds1 phase's caches, as the cli phase's: 4 train steps of 128, a val
# batch and a sampling batch, in the flat SHAPE_ORIG layout of dataset 1's
# in-model embed ("orig-NN"), under the names the configs give
DS1_DATA = {
    f"ds1_{part}": dict(config=f"config_dataset1_{part}.json", voxels=voxels, batch=128,
                        files={f"dataset_1_{part}s_1.hdf5": 512,
                               f"dataset_1_{part}s_val.hdf5": 128,
                               f"dataset_1_{part}s_2.hdf5": 128},
                        overrides=dict(VAL_FILES=[f"dataset_1_{part}s_val.hdf5"]))
    for part, voxels in (("photon", 368), ("pion", 533))
}


def cli_spec(name: str) -> dict:
    """The caches' spec of one dataset of the cli, ds1 or hgcal phase."""
    return {**CLI_DATA, **DS1_DATA, **HGCAL_DATA}[name]


def raw_showers(rng, n, voxels):
    """Showers as a CaloChallenge h5 file holds them (MeV): exponential
    deposits, 80 % of the voxels zero; incident energies 1 GeV - 1 TeV."""
    showers = rng.exponential(1.0, (n, voxels)).astype(np.float32)
    showers[rng.uniform(size=showers.shape) < 0.8] = 0
    return showers, rng.uniform(1e3, 1e6, (n, 1)).astype(np.float32)


def write_cache(path, showers, energies, cfg):
    """The npz cache data/loader._preprocess_one writes for an h5 file of
    these showers and incident energies: load_calochallenge_h5's scaling,
    preprocessing.preprocess_shower and its logE normalisation, then the
    loader's layers and SHAPE_PAD layout."""
    from calodiffusion_tpu_torch.utils import preprocessing

    scale = cfg.get("SHOWERSCALE", 200.0)  # the loader's default, as it reads it
    orig = "orig" in cfg.get("SHOWER_EMBED", "")  # dataset 1: flat showers
    e = np.reshape(energies.astype(np.float32) * scale, (-1, 1))
    shower, layers = preprocessing.preprocess_shower(
        showers.astype(np.float32) * scale, e, cfg.get("SHAPE_PAD") or cfg.get("SHAPE_FINAL"),
        cfg.get("BIN_FILE", ""), cfg["SHOWERMAP"], dataset_num=cfg.get("DATASET_NUM", 2),
        orig_shape=orig, ecut=0, max_deposit=cfg["MAXDEP"])
    emin, emax = cfg["EMIN"], cfg["EMAX"]
    E = (np.log10(e / emin) / np.log10(emax / emin) if cfg["logE"]
         else (e - emin) / (emax - emin))
    layers = (np.reshape(layers, (layers.shape[0], -1)) if layers is not None
              else np.zeros((shower.shape[0], 1), np.float32))
    np.savez_compressed(path, E=E, layers=layers,
                        showers=np.reshape(shower, cfg["SHAPE_ORIG" if orig else "SHAPE_PAD"]))


def make_cli_data(root: Path, name: str, seed: int, raw=None, **overrides):
    """The caches and the config of one dataset under ``root``: the
    shipped config at full width and depth, its training cut to one epoch
    (and ``overrides``: dataset 1's BIN_FILE).  Each file's raw showers and
    incident energies go into ``raw`` where it is a dict."""
    spec = cli_spec(name)
    cfg = json.loads((ROOT / "configs" / spec["config"]).read_text())
    cfg.update(spec["overrides"], MAXEPOCH=1, **overrides)
    data = root / name / "data"
    data.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for fname, n in spec["files"].items():
        showers, energies = raw_showers(rng, n, spec["voxels"])
        write_cache(data / f"{fname}.npz", showers, energies, cfg)
        if raw is not None:
            raw[fname] = (showers, energies)
    cfg_path = root / name / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return cfg, str(cfg_path), str(data) + "/"


class Recorder:
    """Wraps a trainer method (``train_step`` or ``val_step``): records each
    call's loss, wall time and K1 and K2 launches; ``before`` runs ahead of
    the first call with the trainer."""

    def __init__(self, method, attn, before=None):
        self.method, self.attn, self.before, self.calls = method, attn, before, []

    def bind(self):
        """The function to patch in for the method."""
        def method(trainer, *a, **kw):
            if self.before is not None and not self.calls:
                self.before(trainer)
            k1 = self.attn.fused_attention_block.launches
            k2 = self.attn.attention_block_backward.launches
            t0 = time.perf_counter()
            loss = self.method(trainer, *a, **kw)
            torch.cuda.synchronize()
            self.calls.append(dict(loss=loss.item(), s=time.perf_counter() - t0,
                                   k1=self.attn.fused_attention_block.launches - k1,
                                   k2=self.attn.attention_block_backward.launches - k2))
            return loss

        return method

    def check(self, what, n, launches):
        """n calls, every loss finite, each call's (K1, K2) launches as given."""
        if len(self.calls) != n:
            fail(f"{what}: {len(self.calls)} calls, expected {n}")
        if not all(np.isfinite(c["loss"]) for c in self.calls):
            fail(f"{what}: losses not finite: {[c['loss'] for c in self.calls]}")
        bad = [c for c in self.calls if (c["k1"], c["k2"]) != launches]
        if bad:
            fail(f"{what}: a call launched K1 {bad[0]['k1']} and K2 {bad[0]['k2']} times, "
                 f"expected {launches}")


def synced(fn, walls, first_only=False, outputs=None):
    """``fn`` wrapped so that each call (only the first, with ``first_only``)
    runs between two synchronisations and appends its wall to ``walls``
    (and its result to ``outputs``)."""
    def wrapper(*a, **kw):
        if first_only and walls:
            return fn(*a, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        if outputs is not None:
            outputs.append(out)
        return out

    return wrapper


def run_cli(name, cfg, cfg_path, data, ckpt, seed, attn, card, phase="cli", showers_out=None):
    """training.main, then the sample CLI's parsing, loading and generation
    (inference.parse_flags + generate_showers: all but the h5 write), on one
    dataset; K1 and K2 counts reset just before each and read just after.
    The sample batch is the spec's ``sample_batch`` (CLI_SAMPLE_BATCH), run
    in microbatches of 128 (sample_cli).  The showers and their energies
    are appended to ``showers_out`` where it is a list."""
    from unittest import mock

    from calodiffusion_tpu_torch import training
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    n_blocks = len(ATTENTION_BLOCKS[name])
    spec = cli_spec(name)
    recorder = Recorder(TrainDiffusion.train_step, attn)
    common = ["-c", cfg_path, "-d", data, "--seed", str(seed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(TrainDiffusion, "train_step", recorder.bind()):
        trainer = training.main(common + ["--checkpoint", ckpt, "diffusion"])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    train_mem = torch.cuda.max_memory_allocated() / 2**30
    folder = Path(trainer.checkpoint_folder)

    n_train = sum(n for f, n in spec["files"].items() if f in cfg["FILES"])
    n_val = sum(n for f, n in spec["files"].items() if f in cfg.get("VAL_FILES", []))
    want_steps, val_batches = n_train // spec["batch"], -(-n_val // spec["batch"])
    recorder.check(f"{phase} {name} train step", want_steps, (n_blocks, n_blocks))
    steps = recorder.calls
    if (k1, k2) != (n_blocks * (want_steps + val_batches), n_blocks * want_steps):
        fail(f"{phase} {name}: train launched K1 {k1} and K2 {k2} times")
    for fname in ("final.ckpt", "best_val.ckpt", "config.json"):
        if not (folder / fname).exists():
            fail(f"{phase} {name}: train wrote no {folder / fname}")
    steady = statistics.mean(s["s"] for s in steps[1:])
    train = dict(steps=len(steps), losses=[s["loss"] for s in steps], cold_step_s=steps[0]["s"],
                 steady_step_s=steady, samples_per_s=spec["batch"] / steady, wall_s=train_wall,
                 k1=k1, k2=k2, max_memory_gib=train_mem)
    print(f"{phase} {name} train: training.main, {len(steps)} steps of {spec['batch']}, bf16, full "
          f"width: first (cold) step {steps[0]['s']:.3f} s, steady {1e3 * steady:.2f} ms/step, "
          f"{train['samples_per_s']:.1f} train samples/s on {card}; training.main {train_wall:.2f} "
          f"s; K1 {k1}, K2 {k2} launches ({n_blocks} each a step, K1 {n_blocks} a val batch); "
          f"peak memory {train_mem:.2f} GiB; losses {[round(s['loss'], 4) for s in steps]}",
          flush=True)

    sample, showers, energies = sample_cli(name, cfg, common, folder, attn, card, phase)
    results = dict(train=train, sample=sample, checkpoint=str(folder / "final.ckpt"))
    if name == "ds2":
        results["sample_dpmpp2m"] = run_cli_sampler(common, folder, attn, card, n_blocks,
                                                    "DPMPP2M", 20, 19)
    if showers_out is not None:
        showers_out.append((showers, energies))
    return results


def sample_cli(name, cfg, common, folder, attn, card, phase, sample_args=(), path="sample"):
    """The sample CLI's parsing, loading and generation of ``name``'s EVAL
    cache (400-step DDim) from ``folder``'s final.ckpt, ``sample_args``
    given to ``sample`` (HGCal's ``--sparse-decoding``), its checks, HGCal's
    GLaM decode timed apart, and its h5 write where h5py is installed;
    returns (results, showers, energies)."""
    from unittest import mock

    from calodiffusion_tpu_torch import inference
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.utils import hgcal_utils

    n_blocks = len(ATTENTION_BLOCKS[name])
    n = cli_spec(name).get("sample_batch", CLI_SAMPLE_BATCH)
    flags = inference.parse_flags(common + ["-n", "-1", "sample", "--batch-size", str(n),
                                            "--sample-steps", "400", "--model-loc",
                                            str(folder / "final.ckpt"), *sample_args,
                                            "diffusion"])
    first, gen_s, dec_s = [], [], []
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    # the first denoise synchronised apart: the cold start; HGCal's decode apart
    with mock.patch.object(CaloDiffusion, "denoise",
                           synced(CaloDiffusion.denoise, first, first_only=True)), \
            mock.patch.object(CaloDiffusion, "generate", synced(CaloDiffusion.generate, gen_s)), \
            mock.patch.object(hgcal_utils.HGCalConverter, "dec_batches",
                              synced(hgcal_utils.HGCalConverter.dec_batches, dec_s)):
        showers, energies, fout = inference.generate_showers(flags, flags.config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1s, k2s = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    shape, n_e = (n, *cfg["SHAPE_ORIG"][1:]), 3 if cfg.get("HGCAL") else 1
    if showers.shape != shape or energies.shape != (n, n_e):
        fail(f"{phase} {name}: showers {showers.shape}, energies {energies.shape}; expected "
             f"{shape}, ({n}, {n_e})")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"{phase} {name}: showers are not finite and >= 0")
    denoises = 400 * -(-n // CLI_SAMPLE_BATCH)  # 400 steps a microbatch of 128
    if (k1s, k2s) != (n_blocks * denoises, 0):
        fail(f"{phase} {name}: sampling launched K1 {k1s} times (expected "
             f"{n_blocks * denoises}) and K2 {k2s} (expected 0)")
    steady_gen = (gen_s[0] - first[0]) * denoises / (denoises - 1)
    sample = dict(wall_s=wall, setup_s=wall - gen_s[0], generate_s=gen_s[0],
                  first_denoise_s=first[0], showers_per_s=n / gen_s[0],
                  showers_per_s_after_first_step=n / steady_gen, k1=k1s, k2=k2s,
                  glam_decode_s=sum(dec_s) if dec_s else None, args=list(sample_args))
    decode = f"; GLaM decode {sum(dec_s):.3f} s" if dec_s else ""
    print(f"{phase} {name} {path}: inference CLI {' '.join(sample_args)}, {n} showers, 400-step "
          f"DDim, bf16, batch {n}: generate {gen_s[0]:.2f} s, {sample['showers_per_s']:.3f} "
          f"showers/s on {card} (first, cold denoise {first[0]:.3f} s; the other "
          f"{denoises - 1} denoises at {sample['showers_per_s_after_first_step']:.3f} "
          f"showers/s{decode}); loading data and weights {sample['setup_s']:.2f} s; K1 launches "
          f"{k1s} ({n_blocks} a denoise), K2 {k2s}", flush=True)

    if importlib.util.find_spec("h5py") is None:
        tests = "_hgcal_cli" if cfg.get("HGCAL") else "_cli"
        print(f"{phase} {name} {path}: write_out (the h5 file) not run: this machine has no "
              f"h5py; the CPU tests cover it (tests/test_torch_port{tests}.py)", flush=True)
    else:
        import h5py

        out = str(folder.parent / f"generated_{name}_{path}.h5")
        inference.write_out(out, flags, flags.config, showers, energies)
        key = "gen_info" if cfg.get("HGCAL") else "incident_energies"
        with h5py.File(out, "r") as f:
            shapes = (f["showers"].shape, f[key].shape)
        if shapes != (shape, (n, n_e)):
            fail(f"{phase} {name}: the h5 file holds {shapes}")
        print(f"{phase} {name} {path}: write_out wrote {out}: {shapes}", flush=True)
    return sample, showers, energies


def run_cli_sampler(common, folder, attn, card, n_blocks, algo, steps, evals):
    """The ds2 sample CLI's parsing, loading and generation once more with
    ``--sample-algo algo --sample-steps steps``; ``evals`` network
    evaluations, K1 7 times each, K2 never."""
    from calodiffusion_tpu_torch import inference

    flags = inference.parse_flags(common + ["-n", "-1", "sample", "--batch-size",
                                            str(CLI_SAMPLE_BATCH), "--sample-steps", str(steps),
                                            "--sample-algo", algo, "--model-loc",
                                            str(folder / "final.ckpt"), "diffusion"])
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    showers, energies, _ = inference.generate_showers(flags, flags.config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    n = CLI_SAMPLE_BATCH
    if showers.shape != (n, 6480) or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"cli ds2 --sample-algo {algo}: showers {showers.shape}, not all finite and >= 0")
    if (k1, k2) != (n_blocks * evals, 0):
        fail(f"cli ds2 --sample-algo {algo}: K1 {k1} launches (expected {n_blocks * evals}), "
             f"K2 {k2} (expected 0)")
    print(f"cli ds2 sample --sample-algo {algo} --sample-steps {steps}: {n} showers, "
          f"{evals} evaluations, bf16: {wall:.2f} s with loading, {n / wall:.3f} showers/s on "
          f"{card}; K1 launches {k1}, K2 {k2}", flush=True)
    return dict(algo=algo, steps=steps, wall_s=wall, showers_per_s=n / wall, k1=k1, k2=k2)


def run_cli_phase(root: Path, seed, attn, card):
    """The cli phase on ds2 and ds3 under ``root`` (a temporary directory
    that phases 9-13 reuse); returns the results, by dataset its (config,
    config path, data folder), and ds2's raw showers by file and generated
    (showers, energies), which phase 13 compares."""
    results, ds2 = {}, {"raw": {}, "generated": []}
    t0 = time.perf_counter()
    made = {name: make_cli_data(root, name, seed + i, raw=ds2["raw"] if name == "ds2" else None)
            for i, name in enumerate(CLI_DATA)}
    print(f"cli: npz caches of {sum(sum(s['files'].values()) for s in CLI_DATA.values())} "
          f"synthetic showers written in {time.perf_counter() - t0:.1f} s", flush=True)
    for i, (name, (cfg, cfg_path, data)) in enumerate(made.items()):
        results[name] = run_cli(name, cfg, cfg_path, data, str(root / name / "ckpt"),
                                seed + 10 + i, attn, card,
                                showers_out=ds2["generated"] if name == "ds2" else None)
    return results, made, ds2


# ---------------------------------------------------------------------------
# 7. samplers: the zoo at ds2's full width, Bespoke at ds3's
# ---------------------------------------------------------------------------

# The zoo run: (sampler, steps, SAMPLER_OPTIONS, network evaluations), in
# registry order.  tests/test_torch_port_samplers.py pins these counts on
# the CPU against the JAX package's; DPMAdaptive's depends on the data
# (three a try, accepted or rejected).
ZOO = [
    ("DPM", 10, {}, 10),
    ("DPMAdaptive", 10, {}, None),
    ("DPMPP2S", 10, {}, 18),
    ("DPMPPSDE", 10, {"ETA": 1.0}, 18),
    ("DPMPP2M", 10, {}, 9),
    ("DPMPP2MSDE", 10, {"ETA": 1.0}, 9),
    ("DPMPP3MSDE", 10, {"ETA": 1.0}, 9),
    ("LMS", 10, {}, 10),
    ("Euler", 10, {}, 10),
    ("Heun", 10, {}, 19),
    ("DPM2", 10, {}, 19),
    ("Restart", 10, {}, 76),
    ("Consistency", 4, {}, 4),
]
# more network evaluations than this in one sampler's run fail the phase
# (DPMAdaptive's loop ends only when its steps reach the last sigma)
HANG_GUARD_EVALS = 1000
# card (kernels) against CPU (plain versions), f32, batch 2, 4 steps
SAMPLER_CARD_VS_CPU = [("Heun", {}, 7), ("LMS", {}, 4), ("DPMPP3MSDE", {"ETA": 1.0}, 3),
                       ("Consistency", {}, 4)]
# the Bespoke theta trainer on ds3: steps, Adam iterations, batch
BNS_STEPS, BNS_ITERS, BNS_BATCH = 4, 2, 8


class CountedDenoise:
    """Counts a model's network evaluations (its ``denoise`` calls) while
    installed; fails past HANG_GUARD_EVALS."""

    def __init__(self, model):
        self.model, self.evals, self.denoise = model, 0, model.denoise

    def __call__(self, *a, **kw):
        self.evals += 1
        if self.evals > HANG_GUARD_EVALS:
            fail(f"hang guard: more than {HANG_GUARD_EVALS} network evaluations in one "
                 "sampler's run")
        return self.denoise(*a, **kw)

    def __enter__(self):
        self.model.denoise = self
        return self

    def __exit__(self, *exc):
        del self.model.denoise


def run_sampler_zoo(model, cfg, seed, attn, card):
    """The 13 samplers of ZOO through generate on one batch of 128."""
    from calodiffusion_tpu_torch.samplers import get_sampler

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    loader = list(synthetic_loader(1, cfg["SHAPE_FINAL"][2] + 1, seed))
    results, totals = {}, [0, 0]
    for name, steps, options, want_evals in ZOO:
        sampler = get_sampler(name)(dict(cfg, SAMPLER_OPTIONS=options))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
        with CountedDenoise(model) as counted:
            t0 = time.perf_counter()
            showers, energies = model.generate(loader, steps, generator=gen, sampler=sampler)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
        evals = counted.evals
        if showers.shape != (BATCH, 6480) or energies.shape != (BATCH, 1):
            fail(f"samplers {name}: showers {showers.shape}, energies {energies.shape}")
        if not np.isfinite(showers).all() or (showers < 0).any():
            fail(f"samplers {name}: showers are not finite and >= 0")
        extra = ""
        if name == "DPMAdaptive":
            accepted, rejected = sampler.last_steps
            want_evals = 3 * (accepted + rejected)
            extra = f" ({accepted} steps accepted, {rejected} rejected)"
        if evals != want_evals:
            fail(f"samplers {name}: {evals} network evaluations, expected {want_evals}")
        if (k1, k2) != (n_blocks * evals, 0):
            fail(f"samplers {name}: K1 {k1} launches (expected {n_blocks * evals}), K2 {k2} "
                 "(expected 0)")
        totals = [totals[0] + k1, totals[1] + k2]
        results[name] = dict(steps=steps, options=options, evals=evals, wall_s=wall,
                             showers_per_s=BATCH / wall, k1=k1, k2=k2)
        if name == "DPMAdaptive":
            results[name].update(accepted=accepted, rejected=rejected)
        print(f"samplers {name}: {steps} steps, {evals} evaluations{extra}, {BATCH} ds2 "
              f"showers, bf16, full width: {wall:.3f} s, {BATCH / wall:.3f} showers/s on {card} "
              f"({1e3 * wall / evals:.2f} ms an evaluation with reverse_norm); K1 {k1}, "
              f"K2 {k2}", flush=True)
    return results, totals


def check_samplers_card_vs_cpu(cfg, state_dict, seed):
    """SAMPLER_CARD_VS_CPU in f32: the same weights, start, energies,
    layers and injected noise table on the card and on the CPU."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.samplers import get_sampler

    cfg = dict(cfg, PRECISION="f32")
    rng = np.random.default_rng(seed)
    start = rng.standard_normal((2, 1, 45, 16, 9)).astype(np.float32)
    E = rng.uniform(0, 1, (2, 1)).astype(np.float32)
    lay = rng.standard_normal((2, cfg["SHAPE_FINAL"][2] + 1)).astype(np.float32)
    table = rng.standard_normal((16, *start.shape)).astype(np.float32)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = CaloDiffusion(cfg, device=dev)
        models[dev].load_state_dict(state_dict)
    errs = {}
    for name, options, evals in SAMPLER_CARD_VS_CPU:
        outs, draws = [], []
        for dev, m in models.items():
            sampler = get_sampler(name)(dict(cfg, SAMPLER_OPTIONS=options))
            sampler.set_noise_table(table)
            with torch.inference_mode(), CountedDenoise(m) as counted:
                out = sampler(m, *(torch.from_numpy(a).to(m.device) for a in (start, E, lay)),
                              4, 0, None)
            if counted.evals != evals:
                fail(f"samplers card vs CPU {name} ({dev}): {counted.evals} evaluations, "
                     f"expected {evals}")
            outs.append(out.cpu())
            draws.append(sampler.noise_draws)
        err = (outs[0] - outs[1]).abs().max().item()
        tol = evals * 2e-4  # the weight-transfer bound of docs/DESIGN.md:32, per evaluation
        if not np.isfinite(err) or err > tol or draws[0] != draws[1]:
            fail(f"samplers card vs CPU {name}: max_abs_err {err:.3g} > {tol:.3g} or noise "
                 f"rows {draws}")
        errs[name] = dict(max_abs_err=err, tol=tol, evals=evals, noise_rows=draws[0])
        print(f"samplers card vs CPU {name} (f32, batch 2, 4 steps, {evals} evaluations, "
              f"{draws[0]} injected noise rows): max_abs_err {err:.3g} (tol {tol:.3g})",
              flush=True)
    return errs


def run_bespoke(seed, attn, card):
    """BespokeNonStationary at ds3's full width: train theta on the card,
    then sample 128 showers with it."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.samplers import get_sampler
    from calodiffusion_tpu_torch.utils.config import load_config

    n_blocks = len(DS3_ATTENTION_BLOCKS)
    cfg = load_config(str(ROOT / "configs" / "config_dataset3.json"))
    shape = tuple(cfg["SHAPE_PAD"][1:])
    rng = np.random.default_rng(seed)
    batch = (rng.uniform(0.0, 1.0, (BNS_BATCH, 1)).astype(np.float32),
             np.zeros((BNS_BATCH, 1), np.float32),  # ds3 has no layer energies
             rng.standard_normal((BNS_BATCH, *shape)).astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "bns_sampler.npy"
        cfg = dict(cfg, SAMPLER_OPTIONS={"MAX_ITER": BNS_ITERS, "SAMPLER_PATH": str(path)})
        model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(seed))
        sampler = get_sampler("BespokeNonStationary")(cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
        t0 = time.perf_counter()
        theta = sampler.train(model, [batch], BNS_STEPS, generator=gen)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
        mem = torch.cuda.max_memory_allocated() / 2**30
        saved = np.load(path)
    if theta.shape != (2, BNS_STEPS) or not np.isfinite(theta).all() or np.all(theta == 1.0):
        fail(f"bns: theta {theta} is not finite or did not move from its ones")
    if not np.array_equal(saved, theta):
        fail("bns: the theta file differs from the trained theta")
    if any(p.grad is not None for p in model.parameters()):
        fail("bns: the theta trainer left gradients on the network's parameters")
    want = (n_blocks * BNS_STEPS * BNS_ITERS, n_blocks * (BNS_STEPS - 1) * BNS_ITERS)
    if (k1, k2) != want:
        fail(f"bns: the theta trainer launched K1 {k1} and K2 {k2} times, expected {want}")
    print(f"bns: theta trained on {BNS_BATCH} ds3 showers (full width, bf16), {BNS_STEPS} "
          f"steps, {BNS_ITERS} Adam iterations: {train_wall:.3f} s on {card}, peak memory "
          f"{mem:.2f} GiB; K1 {k1}, K2 {k2} launches; theta {np.round(theta, 5).tolist()}",
          flush=True)

    loader = [(rng.uniform(0.0, 1.0, (BATCH, 1)).astype(np.float32),
               np.zeros((BATCH, 1), np.float32), None)]
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    showers, energies = model.generate(loader, BNS_STEPS, generator=gen, sampler=sampler)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sk1, sk2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    if showers.shape != (BATCH, DS3_N) or energies.shape != (BATCH, 1):
        fail(f"bns: showers {showers.shape}, energies {energies.shape}; expected "
             f"({BATCH}, {DS3_N}), ({BATCH}, 1)")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail("bns: ds3 showers are not finite and >= 0")
    if (sk1, sk2) != (n_blocks * BNS_STEPS, 0):
        fail(f"bns: sampling launched K1 {sk1} and K2 {sk2} times")
    print(f"bns: {BATCH} ds3 showers with the trained theta, {BNS_STEPS} steps: {wall:.3f} s, "
          f"{BATCH / wall:.3f} showers/s on {card}; K1 {sk1}, K2 {sk2}", flush=True)
    return dict(theta=theta.tolist(), train_wall_s=train_wall, train_max_memory_gib=mem,
                k1=k1 + sk1, k2=k2 + sk2, train_k1=k1, train_k2=k2, sample_wall_s=wall,
                showers_per_s=BATCH / wall)


# ---------------------------------------------------------------------------
# 8. variants: K3, K4, K5 and the entries that run them
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


# K3 at dataset 1's new widths: pion level 0 (C = 16) and the photon mid
# block (C = 96), B = 128
K3_DS1_SHAPES = [(BATCH, 1610, 16), (BATCH, 28, 96)]


def check_linear_kernel(la, shapes=None):
    """K3 vs plain version at ``shapes`` (B, N, C); by default every ds2
    (C, N), B = 128, and ds3 level 0."""
    cases = []
    if shapes is None:
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


# ---------------------------------------------------------------------------
# 9. cascade: the layer-energy model trained and the cascade sampled, ds2
# ---------------------------------------------------------------------------

# f32 card (K1) against CPU (plain versions): the cascade at batch 2, 4 steps
# in each stage, from the same weights and starts
CASCADE_CHECK_STEPS = 4


def cache_whiten_stats(data: str):
    """The layer trainer's whitening statistics by a numpy pass over the
    ds2 train cache: float64 mean and std of the layer vectors, std floored
    at 1e-3."""
    lay = np.load(Path(data) / "dataset_2_1.hdf5.npz")["layers"].astype(np.float64)
    mean = lay.mean(0)
    return mean, np.maximum(np.sqrt(np.maximum((lay**2).mean(0) - mean**2, 0.0)), 1e-3)


def run_cascade(cfg_path, data, ckpt, base_loc, seed, attn, card):
    """training.main([... "layer"]) on the ds2 caches, then the sample
    CLI's ``sample ... layer`` on its checkpoint and the cli phase's ds2
    U-Net; K1 and K2 counted per train step and val batch, and over the
    sampling."""
    from unittest import mock

    from calodiffusion_tpu_torch import inference, training
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    first = {}

    def snapshot(trainer):  # the weights and statistics the steps start from
        first.update({k: v.clone() for k, v in trainer.model.state_dict().items()
                      if not k.startswith("layer_model.") or ".whiten." in k})

    steps = Recorder(TrainLayerModel.train_step, attn, before=snapshot)
    vals = Recorder(TrainLayerModel.val_step, attn)
    common = ["-c", cfg_path, "-d", data, "--seed", str(seed)]
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(TrainLayerModel, "train_step", steps.bind()), \
            mock.patch.object(TrainLayerModel, "val_step", vals.bind()):
        trainer = training.main(common + ["--checkpoint", ckpt, "layer"])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    folder = Path(trainer.checkpoint_folder)
    # the layer net has no attention; the inherited val loss runs the base U-Net
    steps.check("cascade train step", 512 // BATCH, (0, 0))
    vals.check("cascade val batch", 1, (n_blocks, 0))
    if (k1, k2) != (n_blocks, 0):
        fail(f"cascade train launched K1 {k1} and K2 {k2} times, expected {n_blocks} and 0")
    if not (folder / "final.ckpt").exists() or not folder.name.endswith("_LayerModel"):
        fail(f"cascade train wrote no final.ckpt in {folder}")
    model = trainer.model
    now = model.state_dict()
    moved = [k for k, v in first.items() if not torch.equal(v, now[k])]
    if moved:
        fail(f"cascade train moved {len(moved)} tensors it must leave as they are: {moved[:3]}")
    mean, std = cache_whiten_stats(data)
    stats_err = max(max_norm_rel(model.whiten["mean"], torch.from_numpy(mean).cuda()),
                    max_norm_rel(model.whiten["std"], torch.from_numpy(std).cuda()))
    if not (torch.isfinite(model.whiten["mean"]).all() and stats_err <= 1e-6):
        fail(f"cascade whitening statistics differ from the cache's by {stats_err:.3g} > 1e-6")
    if any(p.dtype != torch.float32 for p in model.layer_net.parameters()):
        fail("the layer net does not compute in f32")
    step_s = [c["s"] for c in steps.calls]
    train = dict(steps=len(step_s), losses=[c["loss"] for c in steps.calls],
                 val_loss=vals.calls[0]["loss"], cold_step_s=step_s[0],
                 steady_step_s=statistics.mean(step_s[1:]), wall_s=train_wall, k1=k1, k2=k2,
                 whiten_stats_err=stats_err)
    print(f"cascade train: training.main layer, {len(step_s)} steps of {BATCH} ds2 layer "
          f"vectors (f32 layer net) and a val batch: first (cold) step {step_s[0]:.3f} s, "
          f"steady {1e3 * train['steady_step_s']:.2f} ms/step on {card}; training.main "
          f"{train_wall:.2f} s; K1 {k1} (0 a step, {n_blocks} the val batch: its loss is the "
          f"base U-Net's), K2 {k2}; losses {[round(v, 4) for v in train['losses']]}; "
          f"whitening statistics vs the cache {stats_err:.3g}; base U-Net and statistics "
          "unchanged bit for bit", flush=True)

    # sample: stage 1 (layer energies) and stage 2 (showers) timed apart
    flags = inference.parse_flags(common + [
        "-n", "-1", "sample", "--batch-size", str(CLI_SAMPLE_BATCH), "--sample-steps", "400",
        "--model-loc", base_loc, "layer", "--layer-model", str(folder / "final.ckpt")])
    walls = {"stage1": [], "sample": [], "generate": [], "first_denoise": []}
    layers_out = []
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(LayerDiffusion, "sample_layers",
                           synced(LayerDiffusion.sample_layers, walls["stage1"],
                                  outputs=layers_out)), \
            mock.patch.object(LayerDiffusion, "sample",
                              synced(LayerDiffusion.sample, walls["sample"])), \
            mock.patch.object(LayerDiffusion, "generate",
                              synced(LayerDiffusion.generate, walls["generate"])), \
            mock.patch.object(CaloDiffusion, "denoise",
                              synced(CaloDiffusion.denoise, walls["first_denoise"],
                                     first_only=True)):
        showers, energies, _ = inference.generate_showers(flags, flags.config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sk1, sk2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    n = CLI_SAMPLE_BATCH
    if showers.shape != (n, 6480) or energies.shape != (n, 1):
        fail(f"cascade sample: showers {showers.shape}, energies {energies.shape}")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail("cascade sample: showers are not finite and >= 0")
    if len(layers_out) != 1 or layers_out[0].shape != (n, 46) or \
            not torch.isfinite(layers_out[0]).all():
        fail("cascade sample: the stage-1 layer energies are not finite (128, 46)")
    if (sk1, sk2) != (n_blocks * 400, 0):
        fail(f"cascade sample launched K1 {sk1} times (expected {n_blocks * 400}) and K2 {sk2}")
    gen_s, stage1 = walls["generate"][0], walls["stage1"][0]
    stage2 = walls["sample"][0] - stage1
    first_s = walls["first_denoise"][0]
    steady = n / ((gen_s - first_s) * 400 / 399)
    sampled = dict(wall_s=wall, setup_s=wall - gen_s, generate_s=gen_s, stage1_s=stage1,
                   stage2_s=stage2, reverse_norm_s=gen_s - walls["sample"][0],
                   first_denoise_s=first_s, showers_per_s=n / gen_s,
                   showers_per_s_after_first_step=steady, k1=sk1, k2=sk2)
    print(f"cascade sample: inference CLI sample ... layer, {n} ds2 showers, 400-step DDim in "
          f"both stages, bf16 U-Net, batch {n}: stage 1 (layer energies) {stage1:.3f} s, stage 2 "
          f"(showers) {stage2:.3f} s, reverse_norm {sampled['reverse_norm_s']:.3f} s; generate "
          f"{gen_s:.2f} s, {sampled['showers_per_s']:.3f} showers/s on {card} (first, cold "
          f"denoise {first_s:.3f} s; without it {steady:.3f} showers/s); loading "
          f"{sampled['setup_s']:.2f} s; K1 {sk1} ({n_blocks} a stage-2 step), K2 {sk2}",
          flush=True)
    check = check_cascade_card_vs_cpu(flags, seed + 1)
    return dict(train=train, sample=sampled, card_vs_cpu=check,
                checkpoint=str(folder / "final.ckpt"))


def check_cascade_card_vs_cpu(flags, seed):
    """The cascade in f32 at batch 2, CASCADE_CHECK_STEPS DDim steps in each
    stage, on the card and on the CPU from the same weights (loaded as the
    sample CLI loads them) and starts."""
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel

    steps = CASCADE_CHECK_STEPS
    cfg = dict(flags.config, PRECISION="f32", LAYER_STEPS=steps, SAMPLER="DDim")
    rng = np.random.default_rng(seed)
    E = rng.uniform(0, 1, (2, 1)).astype(np.float32)
    layer_start = rng.standard_normal((2, 46)).astype(np.float32)
    start = rng.standard_normal((2, 1, 45, 16, 9)).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        m = TrainLayerModel(flags, cfg, load_data=False, save_model=False, inference=True,
                            device=dev).load_for_inference()
        out = m.sample(torch.from_numpy(E).to(dev), num_steps=steps,
                       start=torch.from_numpy(start).to(dev),
                       layer_start=torch.from_numpy(layer_start).to(dev), return_layers=True)
        outs.append({k: v.cpu() for k, v in out.items()})
    err_x = (outs[0]["x"] - outs[1]["x"]).abs().max().item()
    err_l = (outs[0]["layers"] - outs[1]["layers"]).abs().max().item()
    tol = 2 * steps * 2e-4  # the weight-transfer bound of docs/DESIGN.md:32, per evaluation
    if not (np.isfinite([err_x, err_l]).all() and max(err_x, err_l) <= tol):
        fail(f"cascade card vs CPU: showers {err_x:.3g}, layers {err_l:.3g} > {tol:.3g}")
    print(f"cascade card vs CPU (f32, batch 2, {steps} + {steps} DDim steps): showers "
          f"max_abs_err {err_x:.3g}, stage-1 layers {err_l:.3g} (tol {tol:.3g})", flush=True)
    return dict(showers_err=err_x, layers_err=err_l, tol=tol)


# ---------------------------------------------------------------------------
# 10. distill: consistency distillation of the cli phase's ds2 U-Net
# ---------------------------------------------------------------------------

DISTILL_SAMPLE_STEPS = 4


def run_distill(cfg_path, data, ckpt, teacher_loc, seed, attn, card):
    """training.main([... "distill", "--teacher-loc", ...]) on the ds2
    caches, then ``sample ... diffusion --sample-algo Consistency`` with the
    distilled checkpoint; then one f32 distillation step card against CPU."""
    from unittest import mock

    from calodiffusion_tpu_torch import inference, training
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    steps = Recorder(TrainDistillation.train_step, attn)
    vals = Recorder(TrainDistillation.val_step, attn)
    common = ["-c", cfg_path, "-d", data, "--seed", str(seed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(TrainDistillation, "train_step", steps.bind()), \
            mock.patch.object(TrainDistillation, "val_step", vals.bind()):
        trainer = training.main(common + ["--checkpoint", ckpt, "distill", "--teacher-loc",
                                          teacher_loc])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2**30
    k1, k2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    folder = Path(trainer.checkpoint_folder)
    # teacher twice, target and student: 4 U-Nets a step; the student's backward
    steps.check("distill train step", 512 // BATCH, (4 * n_blocks, n_blocks))
    vals.check("distill val batch", 1, (4 * n_blocks, 0))
    if not (folder / "final.ckpt").exists():
        fail(f"distill wrote no {folder / 'final.ckpt'}")
    student = trainer.model.state_dict()
    moved = max((student[k] - v).abs().max().item() for k, v in trainer.teacher_params.items())
    target = max((trainer.ema_params[k] - v).abs().max().item()
                 for k, v in trainer.teacher_params.items())
    if not (moved > 0 and target > 0):
        fail(f"distill: the student moved {moved} from the teacher, the target {target} from "
             "the initial weights")
    step_s = [c["s"] for c in steps.calls]
    steady = statistics.mean(step_s[1:])
    train = dict(steps=len(step_s), losses=[c["loss"] for c in steps.calls],
                 val_loss=vals.calls[0]["loss"], cold_step_s=step_s[0], steady_step_s=steady,
                 samples_per_s=BATCH / steady, wall_s=train_wall, max_memory_gib=mem,
                 k1_train=sum(c["k1"] for c in steps.calls),
                 k2_train=sum(c["k2"] for c in steps.calls),
                 k1_val=vals.calls[0]["k1"], k2_val=vals.calls[0]["k2"],
                 student_moved=moved, target_moved=target)
    print(f"distill train: training.main distill, {len(step_s)} steps of {BATCH} ds2 showers "
          f"and a val batch, bf16, full width: first (cold) step {step_s[0]:.3f} s, steady "
          f"{1e3 * steady:.2f} ms/step, {train['samples_per_s']:.1f} samples/s on {card}; "
          f"training.main {train_wall:.2f} s, peak memory {mem:.2f} GiB; K1 {4 * n_blocks} and "
          f"K2 {n_blocks} a step, K1 {4 * n_blocks} and K2 0 the val batch; losses "
          f"{[round(v, 5) for v in train['losses']]}, val {train['val_loss']:.5g}; student "
          f"moved {moved:.3g} from the teacher, target {target:.3g}", flush=True)

    flags = inference.parse_flags(common + [
        "-n", "-1", "sample", "--batch-size", str(CLI_SAMPLE_BATCH), "--sample-steps",
        str(DISTILL_SAMPLE_STEPS), "--sample-algo", "Consistency", "--model-loc",
        str(folder / "final.ckpt"), "diffusion"])
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    showers, energies, _ = inference.generate_showers(flags, flags.config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sk1, sk2 = attn.fused_attention_block.launches, attn.attention_block_backward.launches
    n = CLI_SAMPLE_BATCH
    if showers.shape != (n, 6480) or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"distill sample: showers {showers.shape}, not all finite and >= 0")
    if (sk1, sk2) != (n_blocks * DISTILL_SAMPLE_STEPS, 0):
        fail(f"distill sample launched K1 {sk1} and K2 {sk2} times")
    sampled = dict(steps=DISTILL_SAMPLE_STEPS, wall_s=wall, showers_per_s=n / wall, k1=sk1,
                   k2=sk2)
    print(f"distill sample: sample ... diffusion --sample-algo Consistency --sample-steps "
          f"{DISTILL_SAMPLE_STEPS} (CONSIS_NSTEPS {flags.config.get('CONSIS_NSTEPS', 100)}) on "
          f"the distilled checkpoint, {n} showers: {wall:.2f} s with loading, {n / wall:.3f} "
          f"showers/s on {card}; K1 {sk1}, K2 {sk2}", flush=True)
    check = check_distill_step_card_vs_cpu(trainer, seed + 1, attn)
    return dict(train=train, sample=sampled, card_vs_cpu=check)


def check_distill_step_card_vs_cpu(trainer, seed, attn):
    """One f32 distillation loss and every student gradient at batch 2, on
    the card and on the CPU, from the trained student, target and teacher
    weights and the same indices and noise: phase 5's step tolerances."""
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
    from calodiffusion_tpu_torch.utils.config import default_flags

    cfg = dict(trainer.config, PRECISION="f32")
    E, layers, data = synthetic_batch(2, cfg["SHAPE_FINAL"][2] + 1, seed)
    rng = np.random.default_rng(seed + 1)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    idx = np.array([5, 60])
    weights = {name: {k: v.detach().cpu() for k, v in w.items()}
               for name, w in (("student", trainer.model.state_dict()),
                               ("target", trainer.ema_params),
                               ("teacher", trainer.teacher_params))}
    results = []
    for dev in ("cuda", "cpu"):
        t = TrainDistillation(default_flags(seed=seed), cfg, load_data=False, save_model=False,
                              device=dev, teacher_params=weights["teacher"])
        t.init_model()
        t.model.load_state_dict(weights["student"])
        k2 = attn.attention_block_backward.launches
        loss = t.distill_loss(*(torch.from_numpy(a).to(dev) for a in (data, E, layers)),
                              torch.from_numpy(idx), torch.from_numpy(noise).to(dev),
                              target={k: v.to(dev) for k, v in weights["target"].items()})
        loss.backward()
        launched = attn.attention_block_backward.launches - k2
        if launched != (len(DS2_ATTENTION_BLOCKS) if dev == "cuda" else 0):
            fail(f"f32 distill step on {dev} launched K2 {launched} times")
        results.append((loss.item(), {k: p.grad.detach().cpu().double()
                                      for k, p in t.model.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = results
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    G = max(g.abs().max().item() for g in g_cpu.values())
    errs = {k: ((g_card[k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
            for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    if not (np.isfinite(l_card) and loss_rel <= STEP_LOSS_RTOL) or \
            not all(np.isfinite(v) for v in errs.values()) or errs[worst] > STEP_GRAD_TOL:
        fail(f"f32 distill step card vs CPU: loss {l_card} vs {l_cpu} ({loss_rel:.3g} relative, "
             f"tol {STEP_LOSS_RTOL}); gradient {worst} {errs[worst]:.3g} (tol {STEP_GRAD_TOL})")
    print(f"distill: f32 step card vs CPU (batch 2, indices {idx.tolist()}): loss {l_card:.6g} vs "
          f"{l_cpu:.6g} ({loss_rel:.3g} relative, tol {STEP_LOSS_RTOL}); {len(errs)} student "
          f"gradients, worst {worst} {errs[worst]:.3g} (tol {STEP_GRAD_TOL})", flush=True)
    return dict(loss_rel=loss_rel, worst_grad=worst, worst_grad_err=errs[worst])


# ---------------------------------------------------------------------------
# 11. ds1: dataset 1 (photons, pions) through the in-model geometry embed
# ---------------------------------------------------------------------------

# (layer id, radial bin edges, alpha bins) of each layer of the CaloChallenge
# dataset-1 binnings (CaloChallenge/code/binning_dataset_1_{photons,pions}.xml,
# which the repository does not hold), as best known; as (r bins, alpha
# bins): photons (8, 1), (16, 10), (19, 10), (5, 1), (5, 1), 368 voxels;
# pions (8, 1), (10, 10), (10, 10), (5, 1), (15, 10), (16, 10), (10, 1), 533.
# Each particle's edges unite to its radial grid of utils/consts.R_BIN_EDGES
# (30 bins for photons, 23 for pions): the configs' SHAPE_FINAL (5, 10, 30)
# and (7, 10, 23).
DS1_BINNING = {
    "photon": [(0, "0,5,10,30,50,100,200,400,600", 1),
               (1, "0,2,4,6,8,10,12,15,20,30,40,50,70,90,120,150,200", 10),
               (2, "0,2,5,10,15,20,25,30,40,50,60,80,100,130,160,200,250,300,350,400", 10),
               (3, "0,50,100,200,400,600", 1),
               (12, "0,100,200,400,1000,2000", 1)],
    "pion": [(0, "0,5,10,30,50,100,200,400,600", 1),
             (1, "0,1,4,7,10,15,30,50,90,150,200", 10),
             (2, "0,5,10,20,30,50,80,130,200,300,400", 10),
             (3, "0,50,100,200,400,600", 1),
             (12, "0,10,20,30,50,80,100,130,160,200,250,300,350,400,1000,2000", 10),
             (13, "0,10,20,30,50,80,100,130,160,200,250,300,350,400,600,1000,2000", 10),
             (14, "0,50,100,150,200,250,300,400,600,1000,2000", 1)],
}




# and of the dataset-2 binning (CaloChallenge/code/binning_dataset_2.xml,
# not in the repository either): 45 layers of 9 radial and 16 alpha bins,
# 6480 voxels, the grid of config_dataset2.json's SHAPE_FINAL (45, 16, 9);
# the radial edges are synthetic
DS2_PARTICLE = "electron"
DS2_BINNING = [(i, "0,4.65,9.3,13.95,18.6,27.9,37.2,46.5,55.8,74.4", 16) for i in range(45)]


def binning_xml(part: str, rows) -> str:
    """The binning XML of (layer id, radial edges, alpha bins) ``rows``, as
    XMLHandler reads it."""
    layers = "\n".join(f'  <Layer id="{i}" r_edges="{edges}" n_bin_alpha="{alphas}"/>'
                        for i, edges, alphas in rows)
    return f'<Bins>\n<Particle name="{part}">\n{layers}\n</Particle>\n</Bins>\n'


def ds1_binning_xml(part: str) -> str:
    """The binning XML of ``DS1_BINNING[part]``."""
    return binning_xml(part, DS1_BINNING[part])


def ds2_binning_xml() -> str:
    """The binning XML of ``DS2_BINNING``."""
    return binning_xml(DS2_PARTICLE, DS2_BINNING)


def check_ds1_binning(part: str, xml: str, cfg: dict) -> None:
    """The binning's regular grid (GeomConverter) is the config's
    SHAPE_FINAL and its voxel count the config's SHAPE_ORIG."""
    from calodiffusion_tpu_torch.utils.geom import GeomConverter
    from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

    bins = XMLHandler(part, xml)
    g = GeomConverter(bins)
    grid = [g.num_layers, g.alpha_out, g.dim_r_out]
    if grid != cfg["SHAPE_FINAL"][2:] or bins.GetTotalNumberOfBins() != cfg["SHAPE_ORIG"][1]:
        fail(f"ds1 {part}: the binning gives grid {grid} and {bins.GetTotalNumberOfBins()} "
             f"voxels; the config says {cfg['SHAPE_FINAL'][2:]} and {cfg['SHAPE_ORIG'][1]}")


def run_roundtrip(cfg, state_dict, data, name, card):
    """``generate(roundtrip=True)`` on the sampling cache's batch of 128 on
    the card: its showers through the embed's encode and decode, then the
    inverse preprocessing, in the flat SHAPE_ORIG layout."""
    from calodiffusion_tpu_torch.data.loader import NpzDataset
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    model = CaloDiffusion(cfg)
    model.load_state_dict(state_dict)
    files = [f"{data}{f}.npz" for f in cfg["EVAL"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    showers, energies = model.generate(NpzDataset(files, CLI_SAMPLE_BATCH), 0, roundtrip=True)
    wall = time.perf_counter() - t0
    n, voxels = CLI_SAMPLE_BATCH, cfg["SHAPE_ORIG"][1]
    if showers.shape != (n, voxels) or energies.shape != (n, 1):
        fail(f"ds1 {name} roundtrip: showers {showers.shape}, energies {energies.shape}; "
             f"expected ({n}, {voxels}), ({n}, 1)")
    if not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"ds1 {name} roundtrip: showers are not finite and >= 0")
    print(f"ds1 {name} roundtrip: generate(roundtrip=True), {n} showers {showers.shape} in "
          f"{wall:.2f} s on {card}", flush=True)
    return dict(shape=list(showers.shape), wall_s=wall)


def run_ds1_phase(root: Path, seed, attn, card):
    """Dataset 1's photons and pions at the full width and depth of their
    shipped configs, on synthetic binnings (DS1_BINNING) and showers:
    training.main and the sample CLI (run_cli), then one f32 denoise and
    one f32 train step card against CPU from the trained weights, and the
    embed's round trip."""
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    results = {}
    for i, name in enumerate(DS1_DATA):
        part = name.removeprefix("ds1_")
        xml = root / f"{name}_binning.xml"
        xml.write_text(ds1_binning_xml(part))
        t0 = time.perf_counter()
        cfg, cfg_path, data = make_cli_data(root, name, seed + i, BIN_FILE=str(xml))
        check_ds1_binning(part, str(xml), cfg)
        print(f"ds1 {name}: binning {cfg['SHAPE_FINAL'][2:]} grid, {cfg['SHAPE_ORIG'][1]} "
              f"voxels; npz caches of {sum(DS1_DATA[name]['files'].values())} synthetic "
              f"showers written in {time.perf_counter() - t0:.1f} s", flush=True)
        res = run_cli(name, cfg, cfg_path, data, str(root / name / "ckpt"), seed + 10 + i,
                      attn, card, phase="ds1")
        weights = ckpt_io.load_inference_weights(res["checkpoint"], "cpu")
        res["card_vs_cpu_denoise"] = check_card_vs_cpu(cfg, weights, seed + 20 + i,
                                                       phase=f"ds1 {name}")
        res["card_vs_cpu_step"] = check_train_step_card_vs_cpu(cfg, weights, seed + 30 + i,
                                                               attn, phase=f"ds1 {name}")
        res["roundtrip"] = run_roundtrip(cfg, weights, data, name, card)
        results[name] = res
    return results


# ---------------------------------------------------------------------------
# 12. hgcal: CMS HGCal photons and pions through the GLaM pre-embed
# ---------------------------------------------------------------------------

# The HGCal configs the hgcal phase drives at full width and depth (cut to
# one epoch), the npz caches it writes (4 train steps at the config's BATCH,
# a val batch, one sampling batch of BATCH, in microbatches of 128) and the
# synthetic geometry of each (the detector pickles are not in the
# repository): rings of cells_per_ring * r cells around a central cell, the
# last ring filled in part so that every layer holds exactly MAX_CELLS
# cells (2076 and 22,268), and every ring inside SHAPE_FINAL's R bins under
# init_map's compression (rings past 22 merged 3:1): photons rings 0-20 of R
# bins 0-20 (21 bins), pions rings 0-86 of R bins 0-44 (48 bins)
HGCAL_DATA = {
    f"hgcal_{part}": dict(
        config=f"config_HGCal_{part}.json", batch=batch, sample_batch=batch,
        cells_per_ring=cells_per_ring, nrings=nrings,
        files={f"hgcal_{part}_1.h5": 4 * batch, f"hgcal_{part}_val.h5": batch,
               f"hgcal_{part}_2.h5": batch},
        overrides=dict(FILES=[f"hgcal_{part}_1.h5"], VAL_FILES=[f"hgcal_{part}_val.h5"],
                       EVAL=[f"hgcal_{part}_2.h5"]))
    for part, batch, cells_per_ring, nrings in (("photons", 256, 10, 20), ("pions", 128, 6, 86))
}
# the card's pseudo-inverses of the photon geometry against numpy's (init on
# the CPU), max |card - numpy| over max |numpy|: float64 Gram matrices on
# the card, float32 SVDs on the host; 6e-8 measured
# (scripts/torch_hgcal_glam.py), so 1e-5
GLAM_PINV_RTOL = 1e-5
# HGCal's layer rescale (reverse_norm_hgcal): a layer's energy becomes its
# target times prev / (prev + 1e-10), prev the decode's layer sum, wherever
# the target and prev are above eps = 1e-8
HGCAL_EPS = 1e-8
LAYER_E_RTOL = 1e-4


def hgcal_r_bin(ring):
    """init_map's ring -> R bin compression (inner 23 rings 1:1, then 3 a bin)."""
    ring = np.asarray(ring, dtype=int)
    return np.where(ring < 23, ring, (ring - 23) // 3 + 23)


def hgcal_geom_file(root: Path, name: str, cfg: dict) -> str:
    """Build, check and pickle the synthetic geometry of ``HGCAL_DATA[name]``
    for ``cfg`` (the port's make_synthetic_geom and save_geom); returns its
    path."""
    from calodiffusion_tpu_torch.utils import hgcal_utils

    spec = HGCAL_DATA[name]
    geom = hgcal_utils.make_synthetic_geom(
        nlayers=cfg["SHAPE_FINAL"][2], cells_per_ring=spec["cells_per_ring"],
        nrings=spec["nrings"], seed=0, max_cells=cfg["MAX_CELLS"])
    rings = geom.ring_map[geom.ring_map >= 0]
    if geom.nlayers != cfg["SHAPE_FINAL"][2] or geom.max_ncell != cfg["MAX_CELLS"]:
        fail(f"{name}: geometry of {geom.nlayers} layers and {geom.max_ncell} cells; the config "
             f"says {cfg['SHAPE_FINAL'][2]} and {cfg['MAX_CELLS']}")
    if not (geom.ncells == cfg["MAX_CELLS"]).all() or hgcal_r_bin(rings).max() >= \
            cfg["SHAPE_FINAL"][-1]:
        fail(f"{name}: a layer holds fewer than MAX_CELLS cells, or ring {rings.max()} falls "
             f"past the {cfg['SHAPE_FINAL'][-1]} R bins")
    path = root / f"{name}_geom.pkl"
    hgcal_utils.save_geom(geom, str(path))
    return str(path)


def raw_hgcal_showers(rng, n, cfg):
    """Showers as an HGCal h5 file holds them: (n, L, MAX_CELLS) cell
    energies, 90 % zero, summing to about the incident energy over
    SHOWERSCALE; gen_info (n, 3) inside EMIN and EMAX."""
    L, C = cfg["SHAPE_ORIG"][1:]
    emin, emax = np.asarray(cfg["EMIN"]), np.asarray(cfg["EMAX"])
    gen_info = (emin + (emax - emin) * rng.random((n, 3))).astype(np.float32)
    u = rng.random((n, L, C), dtype=np.float32)
    scale = 2 * gen_info[:, :1, None] / (cfg.get("SHOWERSCALE", 200.0) * 0.1 * L * C)
    return np.where(u > 0.9, (u - 0.9) * 10 * scale, 0).astype(np.float32), gen_info


def write_hgcal_cache(path, chunks, cfg, conv, device="cuda"):
    """The npz cache data/loader._preprocess_one writes for an HGCal h5 file
    of these (raw showers, gen_info) chunks: load_hgcal_h5's MAX_CELLS slice
    and SHOWERSCALE, the pre-embed's GLaM encode (``conv`` on ``device``),
    preprocess_hgcal_shower, the gen_info normalisation, then the loader's
    layers and SHAPE_PAD layout.  Returns the encode's wall."""
    from calodiffusion_tpu_torch.utils import hgcal_utils

    grids, infos, enc_s = [], [], 0.0
    for raw, gen_info in chunks:
        shower = raw[:, :, :cfg["MAX_CELLS"]].astype(np.float32) * cfg.get("SHOWERSCALE", 200.0)
        t0 = time.perf_counter()
        grids.append(conv.enc_batches(shower, device=device))
        enc_s += time.perf_counter() - t0
        infos.append(gen_info.astype(np.float32))
    gen_info = np.concatenate(infos)
    shower, layers = hgcal_utils.preprocess_hgcal_shower(
        np.concatenate(grids), gen_info[:, 0], cfg["SHAPE_PAD"], cfg["SHOWERMAP"],
        dataset_num=cfg["DATASET_NUM"], max_deposit=cfg["MAXDEP"])
    emin, emax = np.array(cfg["EMIN"]), np.array(cfg["EMAX"])
    np.savez_compressed(path, E=((gen_info - emin) / (emax - emin)).astype(np.float32),
                        layers=np.reshape(layers.astype(np.float32), (layers.shape[0], -1)),
                        showers=np.reshape(shower.astype(np.float32), cfg["SHAPE_PAD"]))
    return enc_s


def make_hgcal_data(root: Path, name: str, seed: int, card: str):
    """The geometry, the pre-embed converter (its pseudo-inverses on the
    card), the npz caches and the config of one HGCal config under
    ``root``; returns (config, config path, data folder, GLaM walls)."""
    from calodiffusion_tpu_torch.utils import hgcal_utils

    spec = HGCAL_DATA[name]
    cfg = json.loads((ROOT / "configs" / spec["config"]).read_text())
    cfg.update(spec["overrides"], MAXEPOCH=1)
    (root / name).mkdir()
    cfg["BIN_FILE"] = hgcal_geom_file(root / name, name, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    conv = hgcal_utils.make_pre_embed_converter(cfg, device="cuda")
    init_s = time.perf_counter() - t0
    data = root / name / "data"
    data.mkdir()
    rng = np.random.default_rng(seed)
    enc_s = 0.0
    t0 = time.perf_counter()
    for fname, n in spec["files"].items():
        chunks = (raw_hgcal_showers(rng, min(128, n - i), cfg) for i in range(0, n, 128))
        enc_s += write_hgcal_cache(data / f"{fname}.npz", chunks, cfg, conv)
    cache_s = time.perf_counter() - t0
    cfg_path = root / name / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    L, out, ncell = conv.enc_mat.shape
    walls = dict(converter_init_s=init_s, cache_encode_s=enc_s, cache_write_s=cache_s,
                 events=sum(spec["files"].values()), glam=[L, out, ncell])
    print(f"hgcal {name}: geometry ({L} layers, {out} bins, {ncell} cells); GLaM converter "
          f"init {init_s:.2f} s (pseudo-inverses on the card); npz caches of {walls['events']} "
          f"synthetic showers in {cache_s:.1f} s, of it the GLaM encode {enc_s:.2f} s on "
          f"{card}", flush=True)
    return cfg, str(cfg_path), str(data) + "/", walls


def check_sparse_decoding(cfg, data, dense, sparse, dense_dec, sparse_dec):
    """The --sparse-decoding showers against the dense ones of the same
    EVAL cache: each layer's energy is its target (from the cache's layer
    energies) times prev / (prev + 1e-10) in both, prev the decode's layer
    sum, within LAYER_E_RTOL wherever the target and both prevs are above
    HGCAL_EPS, so the two runs' layers agree where the guard moves neither
    by 1e-4 (prev >= 1e-6); every lit cell is one a decode weight above
    1e-6 reaches in its layer."""
    from calodiffusion_tpu_torch.utils import hgcal_utils

    c = hgcal_utils.consts.dataset_params[cfg["DATASET_NUM"]]
    with np.load(f"{data}{cfg['EVAL'][0]}.npz") as f:
        layerE, E = f["layers"].astype(np.float64), f["E"].astype(np.float64)
    total = layerE[:, :1] * c["totalE_std"] + c["totalE_mean"]
    layers = hgcal_utils.reverse_logit(layerE[:, 1:] * c["layers_std"] + c["layers_mean"])
    target = layers / layers.sum(1, keepdims=True) * total  # (n, L)
    energy = (cfg["EMIN"][0] + (cfg["EMAX"][0] - cfg["EMIN"][0]) * E[:, :1]) * cfg["MAXDEP"]
    sums = {k: v.astype(np.float64).sum(-1) / energy for k, v in (("dense", dense),
                                                                  ("sparse", sparse))}
    prev = {k: np.maximum(v, 0).astype(np.float64).reshape(target.shape + (-1,)).sum(-1)
            for k, v in (("dense", dense_dec), ("sparse", sparse_dec))}  # (n, [1,] L, ncell)
    mask = (target >= HGCAL_EPS) & (prev["dense"] >= HGCAL_EPS) & (prev["sparse"] >= HGCAL_EPS)
    worst = {}
    for k in ("dense", "sparse"):
        want = target * prev[k] / (prev[k] + 1e-10)
        worst[k] = float((np.abs(sums[k] - want) / want)[mask].max())
    both = mask & (prev["dense"] >= 1e-6) & (prev["sparse"] >= 1e-6)
    worst["sparse_vs_dense"] = float((np.abs(sums["sparse"] - sums["dense"])
                                      / sums["dense"])[both].max())
    if not all(v <= LAYER_E_RTOL for v in worst.values()):
        fail(f"hgcal sparse decoding: layer energies off by {worst} > {LAYER_E_RTOL}")
    conv = hgcal_utils.make_pre_embed_converter(cfg, device="cuda")
    reach = (conv.dec_mat > 1e-6).any(-1)  # (L, ncell)
    stray = int((sparse > 0)[:, ~reach].sum())
    lit = {k: float((v > 0).mean()) for k, v in (("dense", dense), ("sparse", sparse))}
    if stray or not lit["sparse"] < lit["dense"]:
        fail(f"hgcal sparse decoding: {stray} lit cells no decode weight reaches; lit share "
             f"{lit}")
    print(f"hgcal sparse decoding: layer energies at their targets within {worst['dense']:.3g} "
          f"(dense) and {worst['sparse']:.3g} (sparse), sparse vs dense "
          f"{worst['sparse_vs_dense']:.3g} (tol {LAYER_E_RTOL}) over {int(mask.sum())} and {int(both.sum())} of {mask.size} "
          f"layers; lit cells {lit['dense']:.4f} dense, {lit['sparse']:.4f} sparse, each one a "
          f"decode weight reaches", flush=True)
    return dict(worst=worst, compared=int(mask.sum()), compared_both=int(both.sum()),
                layers=int(mask.size), lit=lit)


def run_glam_in_model(cfg, seed, attn, card):
    """The in-model GLaM on the photon geometry (SHOWER_EMBED "NN",
    TRAINABLE_EMBED): 2 bf16 train steps at the config's BATCH (K1 and K2 7
    a step), embeder.mat moved only where its mask is set; then its pseudo-
    inverses taken on the card against numpy's, and one f32 denoise and one
    f32 train step card against CPU from the trained weights."""
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils import hgcal_utils
    from calodiffusion_tpu_torch.utils.config import default_flags

    L, C = cfg["SHAPE_ORIG"][1:]
    cfg = dict(cfg, SHOWER_EMBED="NN", TRAINABLE_EMBED=True, SHAPE_PAD=[-1, L, C])
    B = cfg["BATCH"]
    batches = [synthetic_batch(B, L + 1, seed + i, (L, C), 3) for i in range(3)]
    recorder = Recorder(TrainDiffusion.train_step, attn)

    class Recorded(TrainDiffusion):
        train_step = recorder.bind()

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Recorded(default_flags(checkpoint_folder=ckpt_dir, seed=seed), cfg,
                           loader_train=batches[:2], loader_val=batches[2:])
        trainer.init_model()
        embed = trainer.model.net.NN_embed
        before = embed.embeder.mat.detach().clone()
        trainer.train()
        torch.cuda.synchronize()
    n = len(HGCAL_ATTENTION_BLOCKS["hgcal_photons"])
    recorder.check("hgcal glam train step", 2, (n, n))
    moved = (embed.embeder.mat.detach() - before) != 0
    mask = embed.embeder.mask != 0
    if (moved & ~mask).any() or not moved.any():
        fail(f"hgcal glam: embeder.mat moved at {int((moved & ~mask).sum())} masked entries, "
             f"{int(moved.sum())} in all")
    steady = recorder.calls[1]["s"]
    print(f"hgcal glam: in-model trainable GLaM, 2 bf16 train steps of {B} photon showers: "
          f"losses {[round(c['loss'], 4) for c in recorder.calls]}, second step "
          f"{1e3 * steady:.1f} ms ({B / steady:.1f} samples/s) on {card}; embeder.mat moved at "
          f"{int(moved.sum())} of {int(mask.sum())} unmasked entries and no masked one",
          flush=True)
    state = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}

    card_dec = hgcal_utils.cached_converter(cfg, norm=False, device="cuda").dec_mat
    cpu_dec = hgcal_utils.cached_converter(cfg, norm=False, device="cpu").dec_mat
    pinv_err = float(np.abs(card_dec - cpu_dec).max() / np.abs(cpu_dec).max())
    if not pinv_err <= GLAM_PINV_RTOL:
        fail(f"hgcal glam: the card's pseudo-inverses differ from numpy's by {pinv_err:.3g} "
             f"> {GLAM_PINV_RTOL}")
    print(f"hgcal glam: pseudo-inverses of the photon geometry, card vs numpy {pinv_err:.3g} "
          f"of max |numpy| (tol {GLAM_PINV_RTOL})", flush=True)
    return dict(losses=[c["loss"] for c in recorder.calls],
                step_s=[c["s"] for c in recorder.calls],
                k1=sum(c["k1"] for c in recorder.calls), k2=sum(c["k2"] for c in recorder.calls),
                moved=int(moved.sum()), unmasked=int(mask.sum()), pinv_rel_err=pinv_err,
                card_vs_cpu_denoise=check_card_vs_cpu(cfg, state, seed + 5, phase="hgcal glam"),
                card_vs_cpu_step=check_train_step_card_vs_cpu(cfg, state, seed + 6, attn,
                                                              phase="hgcal glam"))


def run_hgcal_phase(root: Path, seed, attn, card):
    """CMS HGCal photons and pions at the full width and depth of their
    shipped configs through the GLaM pre-embed, on synthetic geometries and
    showers: the caches, training.main and the sample CLI (run_cli); on
    photons the sample CLI once more with --sparse-decoding, and the
    in-model trainable GLaM."""
    from unittest import mock

    from calodiffusion_tpu_torch.utils import hgcal_utils

    results = {}
    for i, name in enumerate(HGCAL_DATA):
        cfg, cfg_path, data, walls = make_hgcal_data(root, name, seed + i, card)
        ckpt = str(root / name / "ckpt")
        dense, dense_dec = [], []
        with mock.patch.object(hgcal_utils.HGCalConverter, "dec_batches", synced(
                hgcal_utils.HGCalConverter.dec_batches, [], outputs=dense_dec)):
            res = run_cli(name, cfg, cfg_path, data, ckpt, seed + 10 + i, attn, card,
                          phase="hgcal", showers_out=dense)
        res["glam"] = dict(walls, decode_s=res["sample"]["glam_decode_s"])
        if name == "hgcal_photons":
            sparse, sparse_dec = [], []
            with mock.patch.object(hgcal_utils.HGCalConverter, "dec_batches", synced(
                    hgcal_utils.HGCalConverter.dec_batches, [], outputs=sparse_dec)):
                common = ["-c", cfg_path, "-d", data, "--seed", str(seed + 10 + i)]
                res["sparse_sample"], showers, _ = sample_cli(
                    name, cfg, common, Path(res["checkpoint"]).parent, attn, card, "hgcal",
                    ("--sparse-decoding",), "sparse_sample")
                sparse.append(showers)
            res["sparse_check"] = check_sparse_decoding(cfg, data, dense[0][0], sparse[0],
                                                        dense_dec[0], sparse_dec[0])
            res["glam_in_model"] = run_glam_in_model(cfg, seed + 20, attn, card)
        results[name] = res
    return results


# ---------------------------------------------------------------------------
# 13. evaluate: the fidelity metrics, CNNCompare and one optimize-CLI trial
# on the cli phase's ds2 caches and U-Net
# ---------------------------------------------------------------------------

# the paths of this slice's phase (13, evaluate), in the kernels line's
# launches_by_path
SLICE_PATHS = ("evaluate_cnn_sample", "optimize_train", "optimize_sample")
# CNNCompare and the optimize trial sample with 10 DDim steps (NSTEPS), not
# the config's 400
EVAL_NSTEPS = 10
# CNNCompare retrains its CNN for one epoch (not TRAIN_HP's 48) over the cli
# phase's two ds2 caches of 128 that the U-Net did not train on
EVAL_FILES = ["dataset_2_2.hdf5", "dataset_2_val.hdf5"]
# the optimize trial's search space: one learning rate, the config's sampler
OPTIMIZE_SPACE = {"LR": [1e-4, 1e-3], "SAMPLER_SETTINGS": {}}
# Card against CPU, f32, TF32 off, same inputs and weights.  The classifier's
# probabilities after 3 epochs of Adam: the products sum 256-wide rows in
# other orders (1e-7 relative a product), which a few dozen Adam steps carry
# into the weights; 1e-4.  The ComparisonNetwork's logits: four convolutions
# and GroupNorms of sums over up to 864 terms, then two dense layers; 1e-4.
CLASSIFIER_PROB_TOL = 1e-4
CNN_LOGIT_TOL = 1e-4
# two CNNCompare scores from the same weights file and generator seed (the
# same draws, the same deterministic kernels)
CNN_SCORE_TOL = 1e-6


class tf32_off:
    """TF32 off for cuBLAS and cuDNN inside the block; the state before
    restored after."""

    def __enter__(self):
        self.prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev


def check_ds2_binning(xml: str, cfg: dict) -> None:
    """The synthetic binning's voxel count is the config's SHAPE_ORIG and
    its grid (layers, alpha bins, radial bins) the config's SHAPE_FINAL."""
    from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

    bins = XMLHandler(DS2_PARTICLE, xml)
    grids = {(len(bins.GetRelevantLayers()), a, r) for a, r in zip(bins.a_bins, bins.r_bins)}
    if grids != {tuple(cfg["SHAPE_FINAL"][2:])} or \
            bins.GetTotalNumberOfBins() != cfg["SHAPE_ORIG"][1]:
        fail(f"evaluate: the ds2 binning gives grids {grids} and {bins.GetTotalNumberOfBins()} "
             f"voxels; the config says {cfg['SHAPE_FINAL'][2:]} and {cfg['SHAPE_ORIG'][1]}")


def run_fidelity(cfg, ds2_showers, seed, card):
    """``fidelity_metrics`` on the card (the DNN classifier trains there):
    the raw synthetic ds2 showers of the cli phase's caches, in the loader's
    units (SHOWERSCALE), against the 128 showers its sample CLI generated;
    then one f32 ``train_classifier`` (3 epochs) on the card against the
    CPU from the same weights and batches."""
    from calodiffusion_tpu_torch.evaluation import classifier, evaluate

    scale = cfg.get("SHOWERSCALE", 200.0)  # the loader's default, as write_cache
    ref = np.concatenate([s for s, _ in ds2_showers["raw"].values()]) * scale
    ref_e = np.concatenate([e for _, e in ds2_showers["raw"].values()])[:, 0] * scale
    gen, gen_e = ds2_showers["generated"][0]
    nlayers = cfg["SHAPE_FINAL"][2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = evaluate.fidelity_metrics(ref, ref_e, gen, gen_e[:, 0], nlayers=nlayers,
                                        generator=torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    auc, jsd, fpd, fpd_err = (metrics[k] for k in ("classifier_auc", "classifier_jsd", "fpd",
                                                    "fpd_err"))
    if not (0.0 <= auc <= 1.0 and jsd >= 0.0 and np.isfinite([fpd, fpd_err]).all()):
        fail(f"evaluate fidelity_metrics: {metrics}")
    print(f"evaluate fidelity_metrics: {len(ref)} raw synthetic ds2 showers against the "
          f"{len(gen)} the cli phase generated: classifier AUC {auc:.4f}, JSD {jsd:.4f}, FPD "
          f"{fpd:.4f} +- {fpd_err:.4f}; {wall:.2f} s on {card} (the DNN trains there, 20 "
          f"epochs)", flush=True)

    f_ref = evaluate.shower_feature_matrix(ref, ref_e, nlayers)
    f_gen = evaluate.shower_feature_matrix(gen, gen_e, nlayers)
    init = classifier.flax_init_(classifier.DNN(f_ref.shape[1]),
                                 torch.Generator().manual_seed(seed + 1)).state_dict()
    probs = {}
    with tf32_off():
        for dev in ("cuda", "cpu"):
            apply_fn, _, (X_val, _, _, mu, sd) = classifier.train_classifier(
                f_ref, f_gen, epochs=3, device=dev, init_state=init)
            probs[dev] = apply_fn(X_val * sd + mu)
    err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    if not err <= CLASSIFIER_PROB_TOL:
        fail(f"evaluate: the classifier's f32 probabilities on the card differ from the CPU's "
             f"by {err:.3g} > {CLASSIFIER_PROB_TOL}")
    print(f"evaluate: f32 train_classifier (3 epochs) card vs CPU: probabilities max_abs_err "
          f"{err:.3g} (tol {CLASSIFIER_PROB_TOL})", flush=True)
    return dict(metrics, wall_s=wall, n_ref=len(ref), n_gen=len(gen),
                classifier_card_vs_cpu=err)


def launch_counts(attn) -> tuple[int, int]:
    """K1's and K2's launch counters."""
    return attn.fused_attention_block.launches, attn.attention_block_backward.launches


def run_cnn_compare(cfg, data, checkpoint, root, seed, attn, card):
    """CNNCompare with RETRAIN_EVAL_NETWORK on the cli phase's ds2 U-Net
    (bf16): its CNN retrained on the EVAL_FILES caches (cut: one epoch, 2
    batches of 128; NSTEPS 400 -> 10), the weights file written, the score
    of those batches' generated showers; then a fresh CNNCompare that loads
    the file scores them alike with the same seed, and the trained CNN's
    f32 forward on the card against the CPU."""
    from unittest import mock

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.evaluation import evaluate
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
    from calodiffusion_tpu_torch.utils.config import default_flags

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    model = CaloDiffusion(cfg)
    model.load_state_dict(ckpt_io.load_inference_weights(checkpoint, "cuda"))
    flags = default_flags(data_folder=data, results_folder=str(root / "evaluate"))
    ecfg = dict(cfg, EVAL=EVAL_FILES, NSTEPS=EVAL_NSTEPS, RETRAIN_EVAL_NETWORK=True,
                flags=flags)
    eval_data, _ = load_data(flags, ecfg, eval=True)
    n_batches = len(eval_data)
    want = (n_blocks * EVAL_NSTEPS * n_batches, 0)

    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with mock.patch.dict(evaluate.TRAIN_HP, {2: dict(evaluate.TRAIN_HP[2], epochs=1)}):
        cnn = evaluate.CNNCompare(model, ecfg, flags, seed=seed)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    k_train = launch_counts(attn)
    weights = Path(cnn._weights_path())
    if not weights.exists():
        fail(f"evaluate CNNCompare: train_network wrote no {weights}")
    cnn.generator.manual_seed(seed)
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    score = cnn(eval_data)
    torch.cuda.synchronize()
    score_wall = time.perf_counter() - t0
    k_score = launch_counts(attn)
    for what, got in (("train_network", k_train), ("score", k_score)):
        if got != want:
            fail(f"evaluate CNNCompare {what}: K1 {got[0]}, K2 {got[1]} launches; expected "
                 f"{want} ({n_blocks} a denoise, {EVAL_NSTEPS} denoises a batch, {n_batches} "
                 "batches)")
    if not (np.isfinite(score) and score <= 0):
        fail(f"evaluate CNNCompare: score {score} (a mean log posterior: finite, <= 0)")

    fresh = evaluate.CNNCompare(model, dict(ecfg, RETRAIN_EVAL_NETWORK=False), flags, seed=seed)
    again = fresh(eval_data)
    if not abs(again - score) <= CNN_SCORE_TOL:
        fail(f"evaluate CNNCompare: a fresh instance from {weights.name} scores {again}, the "
             f"trained one {score}")

    state = {k: v.detach().cpu() for k, v in cnn.cnn.state_dict().items()}
    E, _, showers = next(iter(eval_data))
    x = torch.from_numpy(np.asarray(showers, np.float32)[:16]).reshape(-1, *cnn.data_shape)
    E = torch.from_numpy(np.asarray(E, np.float32)[:16])
    logits = {}
    with tf32_off(), torch.no_grad():
        for dev in ("cuda", "cpu"):
            net = evaluate.ComparisonNetwork(cnn.data_shape)
            net.load_state_dict(state)
            logits[dev] = net.to(dev)(x.to(dev), E.to(dev)).cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not err <= CNN_LOGIT_TOL:
        fail(f"evaluate: ComparisonNetwork f32 logits card vs CPU {err:.3g} > {CNN_LOGIT_TOL}")
    tf32 = torch.backends.cudnn.allow_tf32
    print(f"evaluate CNNCompare: RETRAIN_EVAL_NETWORK, 1 epoch over {n_batches} batches of "
          f"{cfg['BATCH']}, {EVAL_NSTEPS}-step DDim, bf16 U-Net: train_network {train_wall:.2f} s "
          f"(K1 {k_train[0]}, K2 {k_train[1]}), score {score:.5f} in {score_wall:.2f} s (K1 "
          f"{k_score[0]}, K2 {k_score[1]}) on {card}; {weights.name} written, a fresh instance "
          f"scores {again:.5f}; f32 logits card vs CPU max_abs_err {err:.3g} (tol "
          f"{CNN_LOGIT_TOL}, TF32 off); the path ran with cuDNN TF32 "
          f"{'on' if tf32 else 'off'}", flush=True)
    return dict(score=score, fresh_score=again, train_s=train_wall, score_s=score_wall,
                k1=k_train[0] + k_score[0], k2=k_train[1] + k_score[1], batches=n_batches,
                logits_card_vs_cpu=err, cudnn_tf32=tf32)


def run_optimize_trial(cfg, data, xml, root, seed, attn, card):
    """One random-search trial of the optimize CLI (``--model diffusion -o
    COUNT FPD CNN``) on a copy of the ds2 config at full width with
    OPTIMIZE_SPACE, SAMPLER DDim and the synthetic binning (cuts: MAXEPOCH
    1, the cli phase's caches, NSTEPS 400 -> 10): the report's params are
    the random study's draw, every value finite, not None and not its
    objective's failure(); K1 and K2 7 a train step, K1 7 a denoise and K2
    none in sampling."""
    from unittest import mock

    from calodiffusion_tpu_torch import optimize as optimize_cli
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.train import optimize as topt
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import dotdict

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    folder = root / "optimize"
    folder.mkdir()
    ocfg = dict(cfg, NSTEPS=EVAL_NSTEPS, OPTIMIZE=OPTIMIZE_SPACE, SAMPLER="DDim", BIN_FILE=xml,
                PART_TYPE=DS2_PARTICLE)
    (folder / "config.json").write_text(json.dumps(ocfg))
    recorder = Recorder(TrainDiffusion.train_step, attn)
    sampled, sample = [], CaloDiffusion.sample

    def counted_sample(model, *a, **kw):
        before = launch_counts(attn)
        out = sample(model, *a, **kw)
        torch.cuda.synchronize()
        after = launch_counts(attn)
        sampled.append(dict(steps=kw.get("num_steps"), k1=after[0] - before[0],
                            k2=after[1] - before[1]))
        return out

    walls = {name: [] for name in ("train", "COUNT", "FPD", "CNN")}
    patches = [mock.patch.object(TrainDiffusion, "train_step", recorder.bind()),
               mock.patch.object(CaloDiffusion, "sample", counted_sample),
               mock.patch.object(topt.Optimize, "train", synced(topt.Optimize.train,
                                                                 walls["train"]))]
    for name, cls in (("COUNT", topt.Count), ("FPD", topt.FPD), ("CNN", topt.CNNMetric)):
        patches.append(mock.patch.object(cls, "__call__", synced(cls.__call__, walls[name])))
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        study = optimize_cli.optimize(["-c", str(folder / "config.json"), "-d", data, "-o",
                                       "COUNT", "FPD", "CNN", "--model", "diffusion",
                                       "--n-trials", "1", "--study-name", "smoke",
                                       "--results-folder", str(folder / "results")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = launch_counts(attn)

    report = json.loads((folder / "results" / "smoke_report.json").read_text())
    trial = topt._RandomTrial(np.random.default_rng(0), 0)
    topt.Optimize(dotdict(config=ocfg), None, ["COUNT"]).suggest_config(trial)
    if report.get("number") != [0] or report.get("params") != [trial.params]:
        fail(f"optimize: report {report}; expected one trial with params {trial.params}")
    values = report["values"][0]
    objectives = (topt.Count, topt.FPD, topt.CNNMetric)
    if values is None or len(values) != 3 or not all(
            v is not None and np.isfinite(v) and v != obj.failure()
            for v, obj in zip(values, objectives)):
        fail(f"optimize: the trial's values {values} (each finite, not None, not its "
             f"objective's failure {[obj.failure() for obj in objectives]})")
    n_train = CLI_DATA["ds2"]["files"]["dataset_2_1.hdf5"] // cfg["BATCH"]
    recorder.check("optimize train step", n_train, (n_blocks, n_blocks))
    bad = [s for s in sampled if (s["k1"], s["k2"]) != (n_blocks * s["steps"], 0)]
    if len(sampled) != 3 or bad or any(s["steps"] != EVAL_NSTEPS for s in sampled):
        fail(f"optimize: sampling calls {sampled}: expected 3 (COUNT, FPD, CNN) of "
             f"{EVAL_NSTEPS} steps, K1 {n_blocks} a denoise, K2 none")
    k1_sample = sum(s["k1"] for s in sampled)
    k1_train, k2_train = k1 - k1_sample, k2
    if (k1_train, k2_train) != (n_blocks * (n_train + 1), n_blocks * n_train):
        fail(f"optimize: training launched K1 {k1_train} and K2 {k2_train} times; expected "
             f"{n_blocks} each a step and K1 {n_blocks} the val batch")
    split = {k: v[0] for k, v in walls.items()}
    print(f"optimize: one random-search trial (-o COUNT FPD CNN, --model diffusion), ds2 full "
          f"width, bf16, {n_train} train steps of {cfg['BATCH']} and a val batch, then "
          f"{EVAL_NSTEPS}-step DDim on the val batch for each objective: {wall:.2f} s on {card} "
          f"(train {split['train']:.2f} s, COUNT {split['COUNT']:.2f} s, FPD {split['FPD']:.2f} "
          f"s, CNN {split['CNN']:.2f} s); params {trial.params}, values {values}; K1 "
          f"{k1_train} + {k1_sample}, K2 {k2_train} + 0 (train + sampling)", flush=True)
    return dict(wall_s=wall, walls_s=split, params=trial.params, values=values,
                train=dict(k1=k1_train, k2=k2_train, steps=n_train),
                sample=dict(k1=k1_sample, k2=0, calls=len(sampled)),
                study_trials=len(study.trials))


def run_evaluate_phase(root: Path, made, ds2_showers, cli, seed, attn, card):
    """Phase 13 on the cli phase's ds2 caches and U-Net, in its directory:
    the synthetic ds2 binning, fidelity_metrics, CNNCompare and one optimize
    trial."""
    cfg, _, data = made["ds2"]
    xml = root / "ds2_binning.xml"
    xml.write_text(ds2_binning_xml())
    check_ds2_binning(str(xml), cfg)
    print(f"evaluate: synthetic ds2 binning: {cfg['SHAPE_ORIG'][1]} voxels, grid "
          f"{cfg['SHAPE_FINAL'][2:]}", flush=True)
    return dict(
        fidelity=run_fidelity(cfg, ds2_showers, seed, card),
        cnn=run_cnn_compare(cfg, data, cli["ds2"]["checkpoint"], root, seed + 1, attn, card),
        optimize=run_optimize_trial(cfg, data, str(xml), root, seed + 2, attn, card),
    )


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
    # dataset 3's shapes: K1 at the sampling batch, K2 at the train batch
    k1_cases += check_attention_kernel(attn, DS3_ATTENTION_BLOCKS, CLI_SAMPLE_BATCH, "ds3")
    k2_cases += check_backward_kernel(attn, DS3_ATTENTION_BLOCKS, DS3_BATCH, "ds3")
    # dataset 1's, C = 16 and 96 among them, and K3 at one shape of each new width
    for part, blocks in DS1_ATTENTION_BLOCKS.items():
        k1_cases += check_attention_kernel(attn, blocks, BATCH, f"ds1_{part}")
        k2_cases += check_backward_kernel(attn, blocks, BATCH, f"ds1_{part}")
    k3_cases = check_linear_kernel(attn, K3_DS1_SHAPES)
    # HGCal's: its three configs' (C, N), C = 32, 64 and 96
    for name, blocks in HGCAL_ATTENTION_BLOCKS.items():
        k1_cases += check_attention_kernel(attn, blocks, BATCH, name)
        k2_cases += check_backward_kernel(attn, blocks, BATCH, name)

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

    # 6. cli, in a directory that phases 9 and 10 reuse
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    t0 = time.perf_counter()
    cli, made, ds2_showers = run_cli_phase(root, args.seed + 20, attn, card)
    print(f"cli: {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. samplers
    t0 = time.perf_counter()
    zoo, zoo_launches = run_sampler_zoo(model, cfg, args.seed + 30, attn, card)
    zoo_cpu = check_samplers_card_vs_cpu(cfg, model.state_dict(), args.seed + 31)
    bns = run_bespoke(args.seed + 32, attn, card)
    print(f"samplers: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8. variants
    t0 = time.perf_counter()
    k3_cases += check_linear_kernel(attn)
    k4_cases = check_blockwise_kernel(att)
    k4b_cases = check_blockwise_backward(att)
    k5_cases = check_groupnorm_kernel(gn)
    var_launches, var_results = run_variants_path(args.seed + 6, attn, att, gn, nn_modules)
    print(f"variants: {time.perf_counter() - t0:.1f} s", flush=True)

    # 9. cascade and 10. distill, on the cli phase's ds2 caches and U-Net
    _, ds2_cfg_path, ds2_data = made["ds2"]
    t0 = time.perf_counter()
    cascade = run_cascade(ds2_cfg_path, ds2_data, str(root / "ds2" / "ckpt"),
                          cli["ds2"]["checkpoint"], args.seed + 40, attn, card)
    print(f"cascade: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    distill = run_distill(ds2_cfg_path, ds2_data, str(root / "ds2" / "ckpt"),
                          cli["ds2"]["checkpoint"], args.seed + 50, attn, card)
    print(f"distill: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. ds1
    t0 = time.perf_counter()
    ds1 = run_ds1_phase(root, args.seed + 60, attn, card)
    print(f"ds1: {time.perf_counter() - t0:.1f} s", flush=True)

    # 12. hgcal
    t0 = time.perf_counter()
    hgcal = run_hgcal_phase(root, args.seed + 70, attn, card)
    print(f"hgcal: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. evaluate, on the cli phase's ds2 caches and U-Net
    t0 = time.perf_counter()
    evaluation = run_evaluate_phase(root, made, ds2_showers, cli, args.seed + 80, attn, card)
    print(f"evaluate: {time.perf_counter() - t0:.1f} s", flush=True)
    tmp.cleanup()

    # 14. result
    launches = {"fused_attention_block": (gen_launches[0], train["k1"]),
                "attention_block_backward": (gen_launches[1], train["k2"])}
    kernels = []
    for name, cases, key in (("fused_attention_block", k1_cases, "k1"),
                             ("attention_block_backward", k2_cases, "k2")):
        bf16 = [c for c in cases if c["dtype"] == "bfloat16"]
        by_path = {"generate": launches[name][0], "train": launches[name][1]}
        for ds, res in cli.items():
            by_path.update({f"cli_{ds}_train": res["train"][key],
                            f"cli_{ds}_sample": res["sample"][key]})
        by_path["cli_ds2_sample_dpmpp2m"] = cli["ds2"]["sample_dpmpp2m"][key]
        by_path["samplers"] = zoo_launches[0 if key == "k1" else 1]
        by_path["bns"] = bns[key]
        by_path["variants"] = var_launches[name]
        by_path.update({
            "cascade_train": cascade["train"][key],
            "cascade_sample": cascade["sample"][key],
            "distill_train": distill["train"][f"{key}_train"],
            "distill_val": distill["train"][f"{key}_val"],
            "distill_sample": distill["sample"][key],
        })
        for ds, res in ds1.items():
            by_path.update({f"{ds}_train": res["train"][key], f"{ds}_sample": res["sample"][key]})
        for ds, res in hgcal.items():
            by_path.update({f"{ds}_train": res["train"][key], f"{ds}_sample": res["sample"][key]})
        by_path["hgcal_photons_sparse_sample"] = hgcal["hgcal_photons"]["sparse_sample"][key]
        by_path["hgcal_glam_train"] = hgcal["hgcal_photons"]["glam_in_model"][key]
        by_path.update({
            "evaluate_cnn_sample": evaluation["cnn"][key],
            "optimize_train": evaluation["optimize"]["train"][key],
            "optimize_sample": evaluation["optimize"]["sample"][key],
        })
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            # launches on this slice's paths: CNNCompare's sampling, the
            # optimize trial's training and sampling
            launches=sum(by_path[k] for k in SLICE_PATHS),
            launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in bf16),
            # times of the 7 launches of one ds2 U-Net call, B=128, bf16
            ms=per_call(cases, "kernel_ms"), plain_ms=per_call(cases, "plain_ms"),
            device_ms=per_call(cases, "device_ms"),
            bound_ms=per_call(cases, "bound_ms"),
            bound_by="bytes" if all(c["bound_by"] == "bytes" for c in bf16) else "operations",
            library_ms=None, launches_per_call=len(DS2_ATTENTION_BLOCKS),
            launches_per_train_step=len(DS2_ATTENTION_BLOCKS),
            # and of one ds3 U-Net call: K1 at the sampling batch (128), K2 at
            # the train batch (64)
            ds3={k: per_call(cases, k, dataset="ds3")
                 for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms")}
            | {"batch": DS3_BATCH if key == "k2" else CLI_SAMPLE_BATCH},
            # and of one dataset-1 U-Net call of each particle, B = 128
            ds1={ds: {k: per_call(cases, k, dataset=ds)
                      for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms")}
                 for ds in ds1},
            # and of one U-Net call of each HGCal config, B = 128
            hgcal={ds: {k: per_call(cases, k, dataset=ds)
                        for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms")}
                   for ds in HGCAL_ATTENTION_BLOCKS},
            cases=cases,
        ))
    # K3-K5 and K4's backward: the times of their launches in one bf16 run
    # of the variants path
    path_shapes = {"fused_linear_attention": [[DS3_BATCH, DS3_N, 32]],  # ds1's are held apart
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
                      "card_vs_cpu_step": step_check, "cli": cli, "variants": var_results,
                      "samplers": zoo, "samplers_card_vs_cpu": zoo_cpu, "bns": bns,
                      "cascade": cascade, "distill": distill, "ds1": ds1, "hgcal": hgcal,
                      "evaluate": evaluation, "card": card}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
