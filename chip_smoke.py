#!/usr/bin/env python3
"""Smoke run of calodiffusion_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--batches 2] [--steps 400] [--train-steps 20] [--seed 0]

Phases, each printing its own lines; any failed check exits non-zero and
prints no result:

1. card     the card's name and power limit (nvidia-smi), torch and CUDA versions
2. build    every kernel of every path (K1-K5, K4's backward and Q1), each
            variant with its own nvcc, all at once, from this checkout; their
            register/spill lines (and ptxas's wgmma notes); the count of
            HGMMA (wgmma) instructions in K4's bf16 backward library and of
            IGMMA (s8 wgmma) instructions in Q1's (cuobjdump -sass), neither
            of which may be 0
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
            U-Nets (HGCAL_ATTENTION_BLOCKS; batch 128); then K1's and K2's
            bf16 times over the 7 launches of one U-Net call of each config
            beside their bound
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
14. int8     W8A8 int8 sampling (QUANT_INT8) at ds2's full width, bf16:
            phase 4's U-Net calibrated on the first batch's E and layers (36
            scales, its wall apart), then generate of --batches x 128 showers
            of --steps-step DDim, finite, >= 0, Q1 (csrc/int8_conv3d.cu) 36
            and K1 7 times a denoise and the plain version never, showers/s
            beside phase 4's; with CALODIFF_INT8_TRANSPOSE=1 a table of 38
            and one denoise of 38 Q1 launches, whose geometries (36 convs and
            2 transpose cores) Q1 is then held to its plain version at, bit
            for bit, bf16 and f32, batch 128, with its time (and device
            time), the plain version's, cuDNN's conv3d at the same shape and
            the bound; one f32 int8 denoise card against CPU (each quantized
            conv equal bit for bit to the plain version on its card input,
            the whole call within INT8_NOISE_RMS of the CPU's int8-vs-float
            RMS gap); the sample CLI's `sample --int8 ... layer` on the
            cascade phase's checkpoints with QUANT_INT8_EXCLUDE the JAX
            down-path fence (INT8_FENCE): 128 showers, 400 + 400 steps, Q1 20
            and K1 7 a stage-2 denoise, the calibration and the stages' walls
            apart.  Then the sub-phases int8_ds3_generate (configs/
            config_dataset3.json, batch 64), int8_hgcal_generate
            (config_HGCal_photons.json on the hgcal phase's caches, batch
            256) and int8_ds1_generate (config_dataset1_photon.json on the
            synthetic binning, batch 128), each at full width, bf16, from
            seeded weights (cut: DDim 400 -> INT8_FAMILY_STEPS = 50): the
            calibration on the batch's E and layers timed apart, one batch
            generated (finite, >= 0, of SHAPE_ORIG; Q1 once a table conv and
            K1 7 a denoise, the plain version never; Q1's launches by plan,
            the stream plan among them on HGCal and dataset-1 photons), Q1
            bit for bit at every geometry of the denoise, bf16 and f32, with
            its plan, time, device time, the plain version's (timed once,
            in slices of Q1_REFERENCE_BYTES of im2col), cuDNN's conv3d and
            the bound (and Q1's times over one denoise, summed over its
            launches, beside the bound so summed), and one f32 int8 denoise
            card against CPU; and the
            sample CLI's `sample --int8 ... diffusion` on the hgcal phase's
            HGCal photons checkpoint (256 showers, 50 steps, the stream plan
            among Q1's launches)
15. networks the network variants at ds2's full width (configs/
            config_dataset2.json, bf16, batch 128, seeded weights): cold
            diffusion (COLD_DIFFU: 512 synthetic ds2 showers preprocessed as
            the loader caches them at SHOWERSCALE 0.001, the scale of
            create_average_showers, their prior through its average_showers
            and set_cold_prior; COLD_NOISE 0 starts at the binned average, two
            energies in different bins start apart; 20 train steps and 128
            showers of --steps-step DDim from the prior, K1 7 a step and a
            denoise, K2 7 a step; one f32 denoise and one f32 cold train step
            card against CPU within phase 4's and phase 5's tolerances); the
            dense FCN model (SHOWER_EMBED "FCN-orig", NUM_LAYERS_LINEAR 3,
            SHOWERMAP "logit-norm": 20 steps, 128 showers, no kernel launched,
            the same card-vs-CPU checks); REMAT (phase 5's step with and
            without it from phase 4's weights, the same noise and sigmas:
            loss and gradients within phase 5's tolerances, peak allocated
            memory below the plain step's, ms a step, K1 and K2 7 a step);
            ConvNext (CondUnet(use_convnext=True): a denoise and a train
            step timed, K1 7 and K2 7, f32 card vs CPU within 2e-4; under
            QUANT_INT8 one int8 denoise, Q1 once a quantized conv, and Q1
            bit for bit at each of its geometries with the plan it takes,
            kernel_plan); ControlNet (ControlledUnet: a forward, K1 11, and a
            train step with the base frozen, K2 7, timed; the f32 forward
            card vs CPU within 2e-4)
16. scale-out the trainer and sampling on torch.distributed at ds2's full
            width, on the cli phase's ds2 caches and phase 4's weights:
            (a) training.main in this process under an NCCL group of one
            rank (the U-Net in DDP), 4 steps of 128, bf16: K1 and K2 7 a
            step, the losses those of the cli phase's run without a group
            (the largest difference printed; bit for bit expected, held to
            phase 5's STEP_LOSS_RTOL); then 2 epochs with TRACE_DIR: one
            trace of the second epoch, naming K1's and K2's kernels.  Then
            two ranks on the one card over gloo (NCCL refuses two ranks on
            one device), processes of this script (--scale-out-rank), f32,
            TF32 off: (b) DDP, 64 rows a rank: one step's loss, every
            gradient and every parameter after Adam against one process's
            step at batch 128 (phase 5's tolerances; a parameter within 2
            lr, the tree within STEP_LOSS_RTOL in norm), K1 and K2 7 on each
            rank; a sharded 20-step DDim sample of 128 against one
            process's (evaluations x 2e-4); (c) data 1 x model 2 through
            FSDP2 (each rank all 128 rows, the weights' dim 0 sharded): the
            same step checks; (d) hsdp_distill on the same ranks:
            consistency distillation with phase 4's weights as the teacher,
            the student FSDP2's, the teacher and the target networks of
            their own sharded on the mesh: one f32 step with injected grid
            indices and noise against one process's on the card ((c)'s
            checks, the target after its EMA update too), both ranks the
            same, then DISTILL_TIMED_STEPS bf16 steps timed; K1 28 (student,
            teacher twice, target) and K2 7 in every step of each rank; the
            checkpoint written by rank 0 with every shard gathered and
            restored whole into a fresh pair of ranks; a 4-step Consistency
            sample of 128 from it (finite, >= 0, of SHAPE_ORIG; K1 28).
            Each sub-phase's ms a step, peak memory and the card's name and
            power limit printed
17. jobs    the job-launch scripts: scripts/torch_submit_training.py writes
            the training job for the cli phase's ds2 caches (full width,
            MAXEPOCH 2, cut like the cli phase) and its train.sh runs under
            the real torchrun (--nproc-per-node gpu); once the first
            attempt has checkpointed epoch 0 and begun epoch 1 its rank gets
            SIGTERM, as a scheduler preempts a job; the script's loop runs
            again with --load, which resumes at epoch 1 and ends at MAXEPOCH
            (final_state.json: epoch 1, both epochs' losses); the second
            attempt's rank launches K1 7 a step and the val batch and K2 7 a
            step (counted by a sitecustomize hook on the job's PYTHONPATH);
            attempts, epochs and walls printed.  The inference and plotting
            jobs write h5 (no h5py here): tests/test_torch_port_jobs.py runs
            them on the CPU
18. fidelity the fidelity harnesses of scripts/, cut, in the cli phase's
            directory: each family of torch_fidelity_families.py (hgcal, ds1,
            ds1pion, ds3, layer) through its main with --int8 (--roundtrip
            on ds1 and hgcal, --oracle on the cascade), then
            torch_fewstep_check.py --int8 --distill 1 on one candidate of
            each sampler family (FEWSTEP_CANDIDATES: DDim, DPMPP2M, Restart,
            Heun with churn; the baseline too) with one showers/s measurement
            (FEWSTEP_SPEED, bf16 and int8), then torch_cascade_seeds.py at
            two seeds (cut: MAXEPOCH 1, the cascade's stage 1 too; 256 train
            and 128 eval events; DDim 400 -> 10 steps, the few-step
            candidates at their own): every separation key the JAX harness
            writes for the family and its flags present and finite (a
            missing classifier/FPD key only where the harness printed its
            failure), the gates computed, and K1, K2 and Q1 launched as each
            path's U-Net calls imply (UnetCalls: K1 an attention block a
            call, K2 one a call under autograd, Q1 one an int8-scaled conv)
19. scripts the last five JAX scripts' counterparts of scripts/, cut:
            torch_train_smoke.py (its seed-0 ds2 showers at 256 a file, the
            full-size U-Net, 2 epochs, no loss check at the cut), then on
            phase 18's few-step workdir torch_int8_fence_regate.py,
            torch_distill_extend.py (the student to epoch 2, Consistency@1,
            2 and 4) and torch_distill_variant.py (one epoch), and on its
            cascade workdir torch_int8_cascade_ablation.py (every coarse
            group), DDim 400 -> 10 steps: every report key the JAX script
            writes, every number finite; K1, K2 and Q1 as each path's U-Net
            calls imply (UnetCalls; the fence and the ablation sample only),
            no conv of the fence int8 on any call, each ablation row's int8
            calls running its table's convs alone (an excluded group
            launches no Q1); then every K1/K2 shape and Q1 geometry the five
            paths launched that no earlier phase checked, against the plain
            versions
20. probes  the four TPU probe scripts' counterparts of scripts/, cut at
            full width and batch 128 (K 60 -> 5, 200 -> 5 and 30 -> 3,
            DDim 400 -> 10 steps), through their main:
            torch_level_profile.py (the five U-Net ablations at ds2),
            torch_l0_elementwise_ablation.py, torch_im2col_microbench.py
            (the eight geometries) and torch_ds3_roofline.py --which ds2 and
            ds3 (ten conv pairs in NCDHW and channels-last, the three
            attention settings' sampling): every key the JAX script prints
            or writes present and finite (its TPU-only fields replaced by
            the card's bound), graph_ms (K iterations in one CUDA graph,
            replayed) and eager_ms printed for each case, the full U-Net's
            graphed output within K1's bf16 tolerance of its eager output,
            im2col within 1e-5 of cuDNN (f32, TF32 off), K1 launched as
            each case's attention blocks (7, 0, 4, 2, 0; roofline 7, 1, 0)
            and Python calls imply (a replay launches nothing from Python)
            and as each path's U-Net calls imply (UnetCalls with the
            TruncatedUnet), none on the ablation and im2col paths; then any
            K1 shape the paths launched that no earlier phase checked
21. result  {"kernels": [...]} (each kernel's launches by path: generate,
            train, the cli paths, samplers, bns, variants, cascade_train,
            cascade_sample, distill_train, distill_val, distill_sample,
            ds1_photon_train, ds1_photon_sample, ds1_pion_train,
            ds1_pion_sample, hgcal_photons_train, hgcal_photons_sample,
            hgcal_photons_sparse_sample, hgcal_glam_train, hgcal_pions_train,
            hgcal_pions_sample, evaluate_cnn_sample, optimize_train,
            optimize_sample, int8_generate, int8_cascade_sample,
            int8_transpose, int8_ds3_generate, int8_hgcal_generate,
            int8_hgcal_cli_sample, int8_ds1_generate, cold_train,
            cold_sample, fcn_train, fcn_sample, remat_train,
            convnext_forward, convnext_train, convnext_int8,
            controlnet_forward, controlnet_train, ddp_train, ddp_sample,
            hsdp_train, hsdp_distill (rank 0's), jobs_train, fidelity_hgcal,
            fidelity_ds1, fidelity_ds1pion, fidelity_ds3, fidelity_layer,
            fewstep, cascade_seeds, train_smoke, fence_regate,
            cascade_ablation, distill_extend, distill_variant, level_profile,
            roofline_ds2, roofline_ds3; K1's and K2's "launches" sum the
            last forty, the last nine slices' paths, Q1's its twenty;
            their "ds1" and "hgcal" hold one U-Net call's times of each
            config; Q1's times are one ds2 int8 denoise's 36 launches,
            its ConvNext geometries and plans apart, its launches by plan
            and one denoise's times of each int8 sub-phase in
            "launches_by_plan" and "families") and, last, {"ok": true,
            "device": {...}}
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import weakref
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

try:
    from calodiffusion_tpu_torch.ops.tolerances import (INT8_NOISE_RMS, K1_TOL, K2_TOL,
                                                        K3_TOL, K4_TOL, K4B_TOL, K5_TOL)
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
    "int8_conv3d": (
        "calodiffusion_tpu/ops/quant.py:173 (int8_conv3d, not a Pallas kernel: an XLA s8 x s8 "
        "-> s32 conv; and the stride-1 core of int8_conv3d_transpose, :205)"),
}
SOURCES = {
    "fused_attention_block": "calodiffusion_tpu_torch/csrc/linear_attention_block.cu",
    "attention_block_backward": "calodiffusion_tpu_torch/csrc/linear_attention_block_bwd.cu",
    "fused_linear_attention": "calodiffusion_tpu_torch/csrc/linear_attention.cu",
    "blockwise_attention": "calodiffusion_tpu_torch/csrc/blockwise_attention.cu",
    "blockwise_attention_backward": "calodiffusion_tpu_torch/csrc/blockwise_attention_bwd.cu",
    "groupnorm_silu": "calodiffusion_tpu_torch/csrc/groupnorm_silu.cu",
    "int8_conv3d": "calodiffusion_tpu_torch/csrc/int8_conv3d.cu",
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


def print_per_call(k1_cases, k2_cases):
    """K1's and K2's bf16 times over the 7 launches of one U-Net call of
    each config, beside their bound."""
    for name, cases in (("K1", k1_cases), ("K2", k2_cases)):
        for ds in dict.fromkeys(c["dataset"] for c in cases):
            B = next(c["shape"][0] for c in cases if c["dataset"] == ds)
            t = {k: per_call(cases, k, dataset=ds)
                 for k in ("kernel_ms", "device_ms", "plain_ms", "bound_ms")}
            print(f"kernel {name} per U-Net call, {ds} (B = {B}, bf16, "
                  f"{len(ATTENTION_BLOCKS[ds])} launches): kernel {t['kernel_ms']:.4f} ms, device "
                  f"{t['device_ms']:.4f}, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
                  f"(device {t['device_ms'] / t['bound_ms']:.1f}x the bound)", flush=True)


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


def check_card_vs_cpu(cfg, state_dict, seed, phase="main", unet_options=None):
    """One full-width denoise in f32 on the card (kernels) and on the CPU
    (plain versions) from the same weights and inputs; ``unet_options`` as
    CaloDiffusion takes them."""
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
        m = CaloDiffusion(cfg, device=dev, unet_options=unet_options)
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


def check_train_step_card_vs_cpu(cfg, state_dict, seed, attn, phase="train",
                                 blocks=len(DS2_ATTENTION_BLOCKS), prior=None):
    """One f32 train step's loss and parameter gradients (dataset 1's
    embed's or a trainable GLaM's among them), card against CPU, K2
    launched ``blocks`` times on the card; a GLaM matrix's gradient must be
    exactly 0 wherever its mask is.  With a cold prior (``prior``: the
    arguments of ``set_cold_prior``; ``COLD_DIFFU`` set) the noise is
    ``gen_cold_image`` of the unit noise, as the trainer makes it."""
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
        noise_d, E_d = torch.from_numpy(noise).to(dev), torch.from_numpy(E).to(dev)
        if prior is not None:
            noise_d = m.set_cold_prior(*prior).gen_cold_image(E_d[:, :1], cfg["COLD_NOISE"],
                                                              noise_d)
        loss = m.compute_loss(torch.from_numpy(data).to(dev), E_d, noise=noise_d,
                              layers=torch.from_numpy(layers).to(dev),
                              rnd_normal=torch.from_numpy(rnd).to(dev))
        loss.backward()
        launched = attn.attention_block_backward.launches - k2
        if launched != (blocks if dev == "cuda" else 0):
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
    first = "init_conv.weight" if "init_conv.weight" in errs else "in_lay.weight"  # FCN's
    print(f"{phase}: f32 step card vs CPU: loss {l_card:.6g} vs {l_cpu:.6g} ({loss_rel:.3g} "
          f"relative, tol {STEP_LOSS_RTOL}); {len(errs)} parameter gradients, worst "
          f"{worst} {errs[worst]:.3g}, {first} {errs[first]:.3g}"
          + (f", the embed's {len(embed)} worst {worst_embed} {embed[worst_embed]:.3g}"
             if embed else "") + f" (tol {STEP_GRAD_TOL})", flush=True)
    return dict(loss_rel=loss_rel, worst_grad=worst, worst_grad_err=errs[worst],
                init_conv_weight_err=errs.get("init_conv.weight"), n_grads=len(errs),
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
    E, layers, shower = preprocessed(showers, energies, cfg)
    np.savez_compressed(path, E=E, layers=layers, showers=shower)


def preprocessed(showers, energies, cfg):
    """(E, layers, showers) as data/loader._preprocess_one caches them."""
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
    return E, layers, np.reshape(shower, cfg["SHAPE_ORIG" if orig else "SHAPE_PAD"])


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
    train = dict(steps=len(steps), losses=[s["loss"] for s in steps], seed=seed,
                 cold_step_s=steps[0]["s"],
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

# the paths of the evaluate phase (13), in the kernels line's launches_by_path
EVALUATE_PATHS = ("evaluate_cnn_sample", "optimize_train", "optimize_sample")
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


# ---------------------------------------------------------------------------
# 14. int8: W8A8 int8 sampling (M12) through Q1 at ds2's full width
# ---------------------------------------------------------------------------

# the paths of this slice's phase (14, int8), in the kernels line's
# launches_by_path
INT8_PATHS = ("int8_generate", "int8_cascade_sample", "int8_transpose")
# the JAX package's down-path fence of the ds2 cascade (docs/INT8_CASCADE.md;
# scripts/tpu_fewstep_check.py:95-103): ResnetBlock_0..5 and the two
# downsampling convs stay float
INT8_FENCE = [f"ResnetBlock_{i}/" for i in range(6)] + ["CondUnet_0/Conv3d_0",
                                                       "CondUnet_0/Conv3d_1"]
# Q1 launches in one ds2 U-Net call: its 36 quantized convs (30 Block convs,
# the residuals of ResnetBlock_{2,4,10,12}, 2 downsampling), 20 under the
# fence, 38 with the upsampling transposes opted in
INT8_CONVS, INT8_CONVS_FENCED, INT8_CONVS_TRANSPOSE = 36, 20, 38
INT8_OPS_PER_S = 1979e12  # dense int8 tensor cores (the card's data sheet)


def rms_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


class Int8Counts:
    """Q1's launches (its counter), the plain version's calls (counted by a
    patch that is in place while the block runs) and K1's and K2's, all
    reset on entry."""

    def __init__(self, q1, attn):
        self.q1, self.attn, self.plain = q1, attn, 0

    def __enter__(self):
        from unittest import mock

        ref = self.q1.int8_conv3d_reference

        def counted(*a, **kw):
            self.plain += 1
            return ref(*a, **kw)

        torch.cuda.synchronize()
        self.patch = mock.patch.object(self.q1, "int8_conv3d_reference", counted)
        self.patch.start()
        self.q1.int8_conv3d.launches = 0
        self.attn.fused_attention_block.launches = self.attn.attention_block_backward.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.patch.stop()

    def read(self) -> dict:
        return dict(q1=self.q1.int8_conv3d.launches, plain=self.plain,
                    k1=self.attn.fused_attention_block.launches,
                    k2=self.attn.attention_block_backward.launches)


class Q1Launches:
    """While entered, each Q1 launch's geometry in ``calls``: (x shape, wq
    shape, stride, padding, cylindrical, kind), ``q1.launch`` patched; kind
    "transpose core" inside an upsampling transpose (``nn_modules``'
    ``int8_conv3d_transpose`` patched too, where given), else "conv"; the
    mode ``kernel_plan`` names for each geometry in ``plans`` and its
    activations' dtype in ``dtypes``."""

    def __init__(self, q1, nn_modules=None):
        self.q1, self.nn_modules, self.calls, self.plans = q1, nn_modules, [], {}
        self.dtypes = {}

    def __enter__(self):
        from unittest import mock

        from calodiffusion_tpu_torch.ops.conv import triple

        launch, inside = self.q1.launch, []

        def recorded(lib, x, wq, scale, bias, inv, stride=1, padding=0, cylindrical=False):
            key = (tuple(x.shape), tuple(self.q1.Int8Weights.of(wq).wq.shape), triple(stride),
                   triple(padding), bool(cylindrical), "transpose core" if inside else "conv")
            if key not in self.plans:
                self.plans[key] = self.q1.kernel_plan(lib, *key[:5])["mode"]
                self.dtypes[key] = dtype_name(x.dtype)
            self.calls.append(key)
            return launch(lib, x, wq, scale, bias, inv, stride, padding, cylindrical)

        self.patches = [mock.patch.object(self.q1, "launch", recorded)]
        if self.nn_modules is not None:
            transpose = self.nn_modules.int8_conv3d_transpose

            def marked(*a, **kw):
                inside.append(1)
                try:
                    return transpose(*a, **kw)
                finally:
                    inside.pop()

            self.patches.append(mock.patch.object(self.nn_modules, "int8_conv3d_transpose",
                                                  marked))
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()

    def by_plan(self) -> dict:
        out = {"window": 0, "gather": 0, "stream": 0}
        for call in self.calls:
            out[self.plans[call]] += 1
        return out


def q1_calls_of_a_denoise(model, E, layers, q1, nn_modules):
    """One bf16 int8 denoise of ``model`` (its table with the transposes)
    at batch 128, each Q1 call's geometry recorded (``Q1Launches.calls``)."""
    sigma = torch.full((E.shape[0], 1, 1, 1, 1), 0.7, device="cuda")
    x = torch.randn((E.shape[0], *model._data_shape), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    with Q1Launches(q1, nn_modules) as launches, torch.inference_mode(), model.int8_scope():
        y = model.denoise(x, E=E, sigma=sigma, layers=layers)
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        fail("int8: the transposes' int8 denoise is not finite")
    return launches.calls


def q1_bound(x_shape, w_shape, out_shape, dtype):
    """x read once, y written once, wq, scale and bias read once; 2 int8
    operations a product term."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = (math.prod(x_shape) + math.prod(out_shape)) * elt + math.prod(w_shape) + \
        8 * w_shape[0]
    ops = 2 * math.prod(out_shape) * math.prod(w_shape[1:])
    return bound_ms(nbytes, ops, dtype, flop_rate=INT8_OPS_PER_S)


# the plain version's im2col, at most this many int8 bytes a call: a larger
# batch runs in slices of whole samples (dataset 3's level-0 3x3x3 convs at
# B = 64 would copy 2.2 GB, HGCal photons' at B = 128 1.3 GB)
Q1_REFERENCE_BYTES = 1 << 30


def q1_reference(q1, x, *args):
    """int8_conv3d_reference over slices of x's batch, at most
    Q1_REFERENCE_BYTES of im2col each: the same function (each sample's
    output depends on that sample alone), bit for bit."""
    wq, stride, pad = args[0], args[4], args[5]
    rows = math.prod(q1.output_spatial(x.shape, wq.shape[2:], stride, pad))
    per = max(1, Q1_REFERENCE_BYTES // (rows * math.prod(wq.shape[1:])))
    return torch.cat([q1.int8_conv3d_reference(x[i:i + per], *args)
                      for i in range(0, x.shape[0], per)])


def check_q1(q1, geometries, plain_reps=(1, 3)):
    """Q1 against its plain version on the card at each distinct geometry of
    a denoise, bf16 and f32 activations: equal bit for bit (the s32 sums
    exact, the dequantization alike; Q1_ULPS allows none between Q1 and the
    plain version); the plan Q1 takes there (``kernel_plan``); Q1's time
    (CUDA events, and the device time), the plain version's (``plain_reps``:
    warm-up and timed calls), cuDNN's float conv3d at the same shape (the
    conv Q1 replaces; the library time) and the bound."""
    from calodiffusion_tpu_torch.ops.conv import wrap_pad_phi

    cases = []
    g = torch.Generator().manual_seed(11)
    for x_shape, w_shape, stride, pad, cyl, kind in geometries:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(x_shape, generator=g).to(dtype).cuda()
            wq = torch.randint(-127, 128, w_shape, generator=g, dtype=torch.int8).cuda()
            scale = (1e-4 * (1 + torch.rand(w_shape[0], generator=g))).cuda()
            bias = (0.1 * torch.randn(w_shape[0], generator=g)).cuda()
            bias = None if kind == "transpose core" else bias
            inv = 127 / 3.0
            args = (x, wq, scale, bias, inv, stride, pad, cyl)
            # reordered once and kept, as the model keeps them a weight version
            kept = (x, q1.Int8Weights(wq), *args[2:])
            got = q1.int8_conv3d(*kept)
            torch.cuda.synchronize()
            want = q1_reference(q1, *args)
            if got.dtype != dtype or not torch.equal(got, want):
                err = (got.float() - want.float()).abs().max().item()
                fail(f"int8 Q1 {kind} x {x_shape} w {w_shape} stride {stride} pad {pad}, "
                     f"{dtype_name(dtype)}: differs from its plain version by {err:.3g}")
            del want
            plan = q1.kernel_plan(q1.KERNEL.library(x), x_shape, w_shape, stride, pad, cyl)
            w = wq.to(dtype)
            xp = wrap_pad_phi(x, pad[1]) if cyl else x
            lib_pad = (pad[0], 0, pad[2]) if cyl else pad
            b = None if bias is None else bias.to(dtype)
            k_ms = time_ms(lambda: q1.int8_conv3d(*kept))
            d_ms = device_ms(lambda: q1.int8_conv3d(*kept))
            p_ms = time_ms(lambda: q1_reference(q1, *args), *plain_reps)
            l_ms = time_ms(lambda: F.conv3d(xp, w, b, stride, lib_pad))
            bound, by, _ = q1_bound(x_shape, w_shape, got.shape, dtype)
            cases.append(dict(kind=kind, x=list(x_shape), w=list(w_shape), stride=list(stride),
                              padding=list(pad), cylindrical=cyl, dtype=dtype_name(dtype),
                              plan=plan["mode"], max_abs_err=0.0, kernel_ms=k_ms, device_ms=d_ms,
                              plain_ms=p_ms, library_ms=l_ms, bound_ms=bound, bound_by=by))
            print(f"int8 Q1 {kind} x {x_shape} w {w_shape} stride {stride} pad {pad}"
                  f"{' phi wrap' if cyl else ''} {dtype_name(dtype)}: plan {plan['mode']}, equal "
                  f"to its plain version bit for bit; {k_ms:.4f} ms (device {d_ms:.4f}), plain "
                  f"{p_ms:.2f} ms, cuDNN {dtype_name(dtype)} conv3d {l_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({by})", flush=True)
    return cases


def per_denoise(cases, calls, key, dtype="bfloat16"):
    """The sum of ``key`` over the Q1 launches of one denoise (``calls``:
    each launch's geometry, repeats included)."""
    by_geometry = {(tuple(c["x"]), tuple(c["w"]), tuple(c["stride"]), tuple(c["padding"]),
                    c["cylindrical"], c["kind"]): c[key]
                   for c in cases if c["dtype"] == dtype}
    return sum(by_geometry[call] for call in calls)


def check_int8_card_vs_cpu(cfg, state_dict, table, seed, q1, phase="int8"):
    """One f32 int8 denoise (batch 2) on the card and on the CPU from the
    same weights, scale table and input.  Each quantized conv's card output
    equals the plain version on the CPU, from the input it met on the card,
    bit for bit; the whole call lies within INT8_NOISE_RMS of the CPU's own
    int8-vs-float RMS gap (ops/tolerances.py says why it is not held
    elementwise)."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.ops import quant

    cfg = dict(cfg, PRECISION="f32", QUANT_INT8=True)
    shape = data_shape(cfg)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, *shape)).astype(np.float32))
    E = torch.from_numpy(rng.uniform(0, 1, (2, n_cond(cfg))).astype(np.float32))
    lay = torch.from_numpy(rng.standard_normal((2, cfg["SHAPE_FINAL"][2] + 1))
                           .astype(np.float32))
    sigma = torch.full((2,) + (1,) * len(shape), 0.7)
    outs, seen = {}, {}
    for dev in ("cuda", "cpu"):
        m = CaloDiffusion(cfg, device=dev)
        m.load_state_dict(state_dict)
        m._int8_scales = dict(table)
        hooks = []
        if dev == "cuda":
            hooks = [c.register_forward_hook(
                         lambda mod, a, out, p=p: seen.__setitem__(p, (mod, a[0], out)))
                     for p, c in m.quantizable_convs().items()]
        with tf32_off(), torch.inference_mode():
            args = (x.to(dev),), dict(E=E.to(dev), sigma=sigma.to(dev), layers=lay.to(dev))
            outs[dev, "float"] = m.denoise(*args[0], **args[1]).cpu()
            with m.int8_scope():
                outs[dev, "int8"] = m.denoise(*args[0], **args[1]).cpu()
        for h in hooks:
            h.remove()
    for path, (mod, inp, out) in seen.items():
        wq, scale, bias = (t.cpu() for t in mod._int8_weights(table[path]))
        want = q1.int8_conv3d_reference(inp.cpu(), wq, scale, bias, quant.inv_scale(table[path]),
                                        mod.stride, mod.padding, mod.cylindrical)
        if not torch.equal(out.cpu(), want):
            fail(f"{phase} card vs CPU: {path}'s f32 output on the card differs from the plain "
                 f"version on its input by {(out.cpu() - want).abs().max().item():.3g}")
    gap = rms_rel(outs["cpu", "int8"], outs["cpu", "float"])
    err = rms_rel(outs["cuda", "int8"], outs["cpu", "int8"])
    float_err = (outs["cuda", "float"] - outs["cpu", "float"]).abs().max().item()
    if len(seen) != len(table) or not (0 < gap and err <= INT8_NOISE_RMS * gap) or \
            not float_err <= 2e-4:
        fail(f"{phase} card vs CPU (f32): {len(seen)} convs hooked of {len(table)}; RMS "
             f"difference {err:.3g}, the CPU's int8-vs-float gap {gap:.3g} (at most "
             f"{INT8_NOISE_RMS}x); float {float_err:.3g} (tol 2e-4)")
    print(f"{phase} card vs CPU (f32, batch 2): each of the {len(seen)} quantized convs equal to "
          f"the plain version on the CPU from its card input, bit for bit; the int8 denoise "
          f"RMS difference {err:.4g} against the CPU's own int8-vs-float gap {gap:.4g} "
          f"(at most {INT8_NOISE_RMS}x: the card's and the CPU's float activations differ by "
          f"{float_err:.3g}, which flips int8 steps)", flush=True)
    return dict(convs_equal=len(seen), rms_err=err, int8_gap=gap, float_err=float_err)


def run_int8_generate(model, loader, args, q1, attn, nn_modules, card, bf16_sps):
    """ds2 generate with QUANT_INT8 from phase 4's weights (bf16): the
    calibration on the first batch's E and layers timed apart, then
    ``--batches`` x 128 showers of ``--steps``-step DDim with Q1 36 and K1 7
    a denoise and the plain version never; then one denoise with the
    upsampling transposes opted in (38 Q1 launches).  Returns the results,
    the Q1 geometries of that denoise and the table."""
    from unittest import mock

    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    model.config["QUANT_INT8"] = True
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 90)
    E0, lay0 = (torch.from_numpy(a).cuda() for a in loader[0][:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = model.prepare_int8(E=E0, layers=lay0, generator=gen)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    if len(table) != INT8_CONVS or set(table) != set(model.quantizable_convs()):
        fail(f"int8 calibration: {len(table)} scales, expected the {INT8_CONVS} quantized convs")
    first, gen_s = [], []
    with Int8Counts(q1, attn) as counts, \
            mock.patch.object(CaloDiffusion, "denoise",
                              synced(CaloDiffusion.denoise, first, first_only=True)), \
            mock.patch.object(CaloDiffusion, "generate", synced(CaloDiffusion.generate, gen_s)):
        showers, energies = model.generate(loader, args.steps, generator=gen)
    got = counts.read()
    n, denoises = len(loader) * BATCH, len(loader) * args.steps
    if showers.shape != (n, 6480) or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"int8 generate: showers {showers.shape}, not all finite and >= 0")
    want = dict(q1=INT8_CONVS * denoises, plain=0, k1=n_blocks * denoises, k2=0)
    if got != want:
        fail(f"int8 generate: launches {got}, expected {want}")
    sps = n / gen_s[0]
    steady = n / ((gen_s[0] - first[0]) * denoises / (denoises - 1))
    print(f"int8 generate: ds2 full width, bf16, QUANT_INT8: calibration on the first batch's "
          f"E and layers ({len(table)} scales, 8 sigmas, batch 64) {calib_s:.3f} s; {n} "
          f"showers, {args.steps}-step DDim: {gen_s[0]:.2f} s, {sps:.3f} showers/s on {card} "
          f"(first, cold denoise {first[0]:.3f} s; without it {steady:.3f} showers/s); phase "
          f"4's bf16 generate {bf16_sps:.3f} showers/s; launches Q1 {got['q1']} ({INT8_CONVS} a "
          f"denoise), K1 {got['k1']}, K2 {got['k2']}, plain {got['plain']}", flush=True)
    result = dict(calibration_s=calib_s, scales=len(table), showers=n, generate_s=gen_s[0],
                  first_denoise_s=first[0], showers_per_s=sps,
                  showers_per_s_after_first_step=steady, bf16_showers_per_s=bf16_sps, **got)

    # the upsampling transposes opted in: a table with them, one denoise
    with mock.patch.dict("os.environ", {"CALODIFF_INT8_TRANSPOSE": "1"}):
        t_table = model.prepare_int8(E=E0, layers=lay0, generator=gen)
        with Int8Counts(q1, attn) as counts:
            calls = q1_calls_of_a_denoise(model, E0, lay0, q1, nn_modules)
    t_got = counts.read()
    if len(t_table) != INT8_CONVS_TRANSPOSE or \
            t_got != dict(q1=INT8_CONVS_TRANSPOSE, plain=0, k1=n_blocks, k2=0):
        fail(f"int8 transposes: {len(t_table)} scales, launches {t_got}; expected "
             f"{INT8_CONVS_TRANSPOSE} and Q1 {INT8_CONVS_TRANSPOSE}, K1 {n_blocks}")
    print(f"int8 transposes (CALODIFF_INT8_TRANSPOSE=1): {len(t_table)} scales; one denoise "
          f"launched Q1 {t_got['q1']} times (2 transpose cores among them), K1 {t_got['k1']}",
          flush=True)
    model._int8_scales = table
    model.config["QUANT_INT8"] = False
    result["transpose"] = dict(scales=len(t_table), **t_got)
    return result, calls, table


def counted_prepare(cls, q1, attn, walls, calib):
    """``cls.prepare_int8`` wrapped: its wall appended to ``walls``, the Q1
    and K1 launches it made and its table's size put in ``calib``."""
    prepare = cls.prepare_int8

    def wrapper(model, **kw):
        before = (q1.int8_conv3d.launches, attn.fused_attention_block.launches)
        out = synced(prepare, walls)(model, **kw)
        calib.update(q1=q1.int8_conv3d.launches - before[0],
                     k1=attn.fused_attention_block.launches - before[1], scales=len(out))
        return out

    return wrapper


def run_int8_cascade(cfg_path, data, base_loc, layer_loc, seed, q1, attn, card, root):
    """The sample CLI's ``sample --int8 ... layer`` on the cascade phase's
    checkpoints and the cli phase's ds2 caches, with QUANT_INT8_EXCLUDE the
    JAX down-path fence: 128 showers, 400 + 400 DDim steps, Q1 20 and K1 7
    a stage-2 denoise (the calibration runs the U-Net in float)."""
    from unittest import mock

    from calodiffusion_tpu_torch import inference
    from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion

    n_blocks = len(DS2_ATTENTION_BLOCKS)
    fenced = root / "config_dataset2_int8_fence.json"
    fenced.write_text(json.dumps(dict(json.loads(Path(cfg_path).read_text()),
                                      QUANT_INT8_EXCLUDE=INT8_FENCE)))
    flags = inference.parse_flags(["-c", str(fenced), "-d", data, "--seed", str(seed), "-n",
                                   "-1", "sample", "--batch-size", str(CLI_SAMPLE_BATCH),
                                   "--sample-steps", "400", "--model-loc", base_loc, "--int8",
                                   "layer", "--layer-model", layer_loc])
    walls = {"stage1": [], "sample": [], "generate": [], "calibration": []}
    calib = {}
    with Int8Counts(q1, attn) as counts, \
            mock.patch.object(LayerDiffusion, "prepare_int8", counted_prepare(
                LayerDiffusion, q1, attn, walls["calibration"], calib)), \
            mock.patch.object(LayerDiffusion, "sample_layers",
                              synced(LayerDiffusion.sample_layers, walls["stage1"])), \
            mock.patch.object(LayerDiffusion, "sample",
                              synced(LayerDiffusion.sample, walls["sample"])), \
            mock.patch.object(LayerDiffusion, "generate",
                              synced(LayerDiffusion.generate, walls["generate"])):
        showers, energies, _ = inference.generate_showers(flags, flags.config)
    got = counts.read()
    n = CLI_SAMPLE_BATCH
    if showers.shape != (n, 6480) or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"int8 cascade: showers {showers.shape}, not all finite and >= 0")
    sampling = dict(q1=got["q1"] - calib["q1"], k1=got["k1"] - calib["k1"], k2=got["k2"],
                    plain=got["plain"])
    want = dict(q1=INT8_CONVS_FENCED * 400, k1=n_blocks * 400, k2=0, plain=0)
    if calib.get("scales") != INT8_CONVS_FENCED or calib["q1"] != 0 or sampling != want:
        fail(f"int8 cascade: calibration {calib}, sampling launches {sampling}; expected "
             f"{INT8_CONVS_FENCED} scales, no Q1 in the calibration, and {want}")
    stage1, stage2 = walls["stage1"][-1], walls["sample"][0] - walls["stage1"][-1]
    gen_s = walls["generate"][0]
    print(f"int8 cascade: inference CLI sample --int8 ... layer, QUANT_INT8_EXCLUDE the down "
          f"path ({calib['scales']} convs int8), {n} ds2 showers, 400-step DDim in both stages, "
          f"bf16 U-Net: calibration {walls['calibration'][0]:.3f} s on the true layers and a "
          f"stage-1 sample of 32 (that sample {walls['stage1'][0]:.3f} s), stage 1 "
          f"{stage1:.3f} s, stage 2 {stage2:.3f} s; generate {gen_s:.2f} s, {n / gen_s:.3f} "
          f"showers/s on {card}; stage 2 launched Q1 {sampling['q1']} ({INT8_CONVS_FENCED} a "
          f"denoise), K1 {sampling['k1']}, K2 {sampling['k2']}, plain {sampling['plain']}",
          flush=True)
    return dict(calibration_s=walls["calibration"][0], stage1_s=stage1, stage2_s=stage2,
                generate_s=gen_s, showers_per_s=n / gen_s, scales=calib["scales"], **sampling)


# Phase 14's int8 sub-phases beyond ds2 (PR 18): each config at its full
# width and depth, bf16, from seeded random weights, on one sampling batch
# of its phase's caches (the cli phase's ds3, the hgcal and ds1 phases'
# synthetic HGCal photons and dataset-1 photons), DDim cut from 400 to
# INT8_FAMILY_STEPS steps; ``stream``: Q1's stream plan (the (64 <- 192,
# 3x3x3) up-path conv of widths [32, 32, 64, 96]) must run
INT8_FAMILY_STEPS = 50
INT8_FAMILIES = {
    "int8_ds3_generate": dict(data="ds3", cache="dataset_3_2.hdf5.npz", batch=DS3_BATCH,
                              stream=False),
    "int8_hgcal_generate": dict(data="hgcal_photons", cache="hgcal_photons_2.h5.npz",
                                batch=256, stream=True),
    "int8_ds1_generate": dict(data="ds1_photon", cache="dataset_1_photons_2.hdf5.npz",
                              batch=BATCH, stream=True),
}
# and the sample CLI's sample --int8 ... diffusion on HGCal photons
INT8_FAMILY_PATHS = tuple(INT8_FAMILIES) + ("int8_hgcal_cli_sample",)


def run_int8_family(name, root, seed, q1, attn, card):
    """One int8 sub-phase: its phase's config (``root``/data/config.json)
    with QUANT_INT8, the model from seeded weights, one batch of E and
    layers from its cache; the calibration on them timed apart, ``generate``
    of that batch with INT8_FAMILY_STEPS-step DDim (Q1
    once a table conv and K1 once an attention block a denoise, the plain
    version and K2 never; Q1's launches by plan, stream > 0 where the spec
    says), showers finite, >= 0, of SHAPE_ORIG; then Q1 at every geometry
    of its denoise against the plain version (check_q1, the plain version
    timed once) and one f32 int8 denoise card against CPU."""
    from unittest import mock

    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    spec = INT8_FAMILIES[name]
    folder, n = root / spec["data"], spec["batch"]
    cfg = dict(json.loads((folder / "config.json").read_text()), QUANT_INT8=True)
    model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(seed))
    cache = np.load(folder / "data" / spec["cache"])
    loader = [(cache["E"][:n].astype(np.float32), cache["layers"][:n].astype(np.float32), None)]
    if len(loader[0][0]) != n:
        fail(f"{name}: the cache {spec['cache']} holds fewer than {n} rows")
    n_blocks = len(ATTENTION_BLOCKS[spec["data"]])
    steps = INT8_FAMILY_STEPS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E0, lay0 = (torch.from_numpy(a).cuda() for a in loader[0][:2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = model.prepare_int8(E=E0, layers=lay0, generator=gen)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    if not table or set(table) != set(model.quantizable_convs()):
        fail(f"{name}: calibration gave {len(table)} scales for "
             f"{len(model.quantizable_convs())} quantizable convs")
    first, gen_s = [], []
    with Int8Counts(q1, attn) as counts, Q1Launches(q1) as q1_launches, \
            mock.patch.object(CaloDiffusion, "denoise",
                              synced(CaloDiffusion.denoise, first, first_only=True)), \
            mock.patch.object(CaloDiffusion, "generate", synced(CaloDiffusion.generate, gen_s)):
        showers, _ = model.generate(loader, steps, generator=gen)
    got, by_plan = counts.read(), q1_launches.by_plan()
    denoises = steps * -(-n // CLI_SAMPLE_BATCH)  # microbatches of 128
    shape = (n, *cfg["SHAPE_ORIG"][1:])
    if showers.shape != shape or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"{name}: showers {showers.shape} (expected {shape}), not all finite and >= 0")
    want = dict(q1=len(table) * denoises, plain=0, k1=n_blocks * denoises, k2=0)
    if got != want or (spec["stream"] and by_plan["stream"] == 0):
        fail(f"{name}: launches {got}, expected {want}; Q1 by plan {by_plan}")
    sps = n / gen_s[0]
    steady = n / ((gen_s[0] - first[0]) * denoises / (denoises - 1))
    print(f"{name}: {spec['data']} full width, bf16, QUANT_INT8: calibration on the batch's E "
          f"and layers ({len(table)} scales, 8 sigmas, batch {min(n, 64)}) {calib_s:.3f} s; {n} "
          f"showers, {steps}-step DDim: {gen_s[0]:.2f} s, {sps:.3f} showers/s on {card} (first, "
          f"cold denoise {first[0]:.3f} s; without it {steady:.3f} showers/s); launches Q1 "
          f"{got['q1']} ({len(table)} a denoise; by plan {by_plan}), K1 {got['k1']}, K2 "
          f"{got['k2']}, plain {got['plain']}", flush=True)
    calls = q1_launches.calls[:len(table)]  # the first denoise's
    cases = check_q1(q1, list(dict.fromkeys(calls)), plain_reps=(0, 1))
    for c in cases:
        if c["plan"] != q1_launches.plans[(tuple(c["x"]), tuple(c["w"]), tuple(c["stride"]),
                                           tuple(c["padding"]), c["cylindrical"], c["kind"])]:
            fail(f"{name}: Q1 x {c['x']} w {c['w']} {c['dtype']}: plan {c['plan']} in the check, "
                 f"another in the generate")
    card_vs_cpu = check_int8_card_vs_cpu(cfg, model.state_dict(), table, seed + 1, q1,
                                         phase=name)
    result = dict(calibration_s=calib_s, scales=len(table), showers=n, steps=steps,
                  generate_s=gen_s[0], first_denoise_s=first[0], showers_per_s=sps,
                  showers_per_s_after_first_step=steady, q1_by_plan=by_plan, **got,
                  card_vs_cpu=card_vs_cpu,
                  per_denoise={k: per_denoise(cases, calls, k) for k in (
                      "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
                  denoise_calls=[list(map(list, c[:4])) + list(c[4:]) for c in calls])
    t = result["per_denoise"]
    print(f"{name}: Q1 over the {len(calls)} launches of one bf16 int8 denoise (B = "
          f"{calls[0][0][0]}): {t['kernel_ms']:.3f} ms by events, device {t['device_ms']:.3f}, "
          f"cuDNN's bf16 conv3d {t['library_ms']:.3f}, bound {t['bound_ms']:.4f} (device "
          f"{t['device_ms'] / t['bound_ms']:.1f}x the bound) on {card}", flush=True)
    return result, cases


def run_int8_hgcal_cli(root, ckpt, seed, q1, attn, card):
    """The sample CLI's ``sample --int8 ... diffusion`` on the hgcal phase's
    HGCal photons checkpoint and caches: 256 showers, INT8_FAMILY_STEPS-step
    DDim in microbatches of 128; the calibration (8 float network calls, no
    Q1) inside generate counted apart; Q1 once a table conv and K1 once an
    attention block a denoise, the stream plan among Q1's."""
    from unittest import mock

    from calodiffusion_tpu_torch import inference
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    folder = root / "hgcal_photons"
    cfg = json.loads((folder / "config.json").read_text())
    n, steps, n_blocks = 256, INT8_FAMILY_STEPS, len(ATTENTION_BLOCKS["hgcal_photons"])
    flags = inference.parse_flags(["-c", str(folder / "config.json"), "-d",
                                   str(folder / "data") + "/", "--seed", str(seed), "-n", "-1",
                                   "sample", "--batch-size", str(n), "--sample-steps",
                                   str(steps), "--model-loc", ckpt, "--int8", "diffusion"])
    calib, walls = {}, {"calibration": [], "generate": []}
    with Int8Counts(q1, attn) as counts, Q1Launches(q1) as q1_launches, \
            mock.patch.object(CaloDiffusion, "prepare_int8", counted_prepare(
                CaloDiffusion, q1, attn, walls["calibration"], calib)), \
            mock.patch.object(CaloDiffusion, "generate",
                              synced(CaloDiffusion.generate, walls["generate"])):
        showers, _, _ = inference.generate_showers(flags, flags.config)
    got, by_plan = counts.read(), q1_launches.by_plan()
    shape = (n, *cfg["SHAPE_ORIG"][1:])
    if showers.shape != shape or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"int8_hgcal_cli_sample: showers {showers.shape} (expected {shape}), not all "
             f"finite and >= 0")
    denoises = steps * n // CLI_SAMPLE_BATCH
    sampling = dict(q1=got["q1"] - calib["q1"], k1=got["k1"] - calib["k1"], k2=got["k2"],
                    plain=got["plain"])
    want = dict(q1=calib["scales"] * denoises, k1=n_blocks * denoises, k2=0, plain=0)
    if calib["q1"] != 0 or sampling != want or by_plan["stream"] == 0:
        fail(f"int8_hgcal_cli_sample: calibration {calib}, sampling launches {sampling}, Q1 by "
             f"plan {by_plan}; expected no Q1 in the calibration, {want}, stream > 0")
    gen_s = walls["generate"][0]
    print(f"int8_hgcal_cli_sample: inference CLI sample --int8 ... diffusion, {n} HGCal photons "
          f"showers, {steps}-step DDim, bf16: calibration {walls['calibration'][0]:.3f} s "
          f"({calib['scales']} scales); generate {gen_s:.2f} s, {n / gen_s:.3f} showers/s on "
          f"{card}; sampling launched Q1 {sampling['q1']} (by plan {by_plan}), K1 "
          f"{sampling['k1']}, K2 {sampling['k2']}, plain {sampling['plain']}", flush=True)
    return dict(calibration_s=walls["calibration"][0], generate_s=gen_s, showers=n,
                steps=steps, showers_per_s=n / gen_s, scales=calib["scales"],
                q1_by_plan=by_plan, **sampling)


def run_int8_phase(model, loader, args, cascade_loc, made, cli, root, q1, attn, nn_modules,
                   card, bf16_sps, hgcal_ckpt):
    """Phase 14: the int8 generate and its transposes, Q1 at each geometry of
    their denoise, one f32 int8 denoise card against CPU, the fenced int8
    cascade through the sample CLI; then the sub-phases of INT8_FAMILIES
    (dataset 3, HGCal photons, dataset-1 photons) and HGCal's sample
    --int8 through the CLI (``hgcal_ckpt``)."""
    generate, calls, table = run_int8_generate(model, loader, args, q1, attn, nn_modules, card,
                                               bf16_sps)
    geometries = list(dict.fromkeys(calls))
    cases = check_q1(q1, geometries)
    card_vs_cpu = check_int8_card_vs_cpu(model.config, model.state_dict(), table,
                                         args.seed + 91, q1)
    _, cfg_path, data = made["ds2"]
    cascade = run_int8_cascade(cfg_path, data, cli["ds2"]["checkpoint"], cascade_loc,
                               args.seed + 92, q1, attn, card, root)
    families, family_cases = {}, {}
    for i, name in enumerate(INT8_FAMILIES):
        t0 = time.perf_counter()
        families[name], family_cases[name] = run_int8_family(name, root, args.seed + 93 + 2 * i,
                                                             q1, attn, card)
        if name == "int8_hgcal_generate":
            families["int8_hgcal_cli_sample"] = run_int8_hgcal_cli(
                root, hgcal_ckpt, args.seed + 99, q1, attn, card)
        print(f"int8 {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(generate=generate, card_vs_cpu=card_vs_cpu, cascade=cascade, families=families,
                denoise_calls=[list(map(list, c[:4])) + list(c[4:]) for c in calls]), cases, \
        calls, family_cases


# ---------------------------------------------------------------------------
# 15. networks: the network variants (cold diffusion, the dense FCN model,
# REMAT, ConvNext blocks, ControlNet) at ds2's full width
# ---------------------------------------------------------------------------

NETWORK_PATHS = ("cold_train", "cold_sample", "fcn_train", "fcn_sample", "remat_train",
                 "convnext_forward", "convnext_train", "convnext_int8", "controlnet_forward",
                 "controlnet_train")
NETWORK_TRAIN_STEPS = 20
REMAT_STEPS = 3  # timed, after one warm-up step each way
# ControlNet on ds2: K1 in the control U-Net's 3 down blocks and middle, and
# the base's 7; with the base frozen K2 in the control's 4 and the base's 3
# up-path blocks (the frozen base's down path and middle need no backward)
CONTROLNET_K1, CONTROLNET_K2 = 4 + 7, 4 + 3


def ds2_unet_kwargs(cfg) -> dict:
    """The CondUnet arguments CaloDiffusion builds for ds2's config."""
    return dict(cond_dim=cfg["COND_SIZE_UNET"], out_dim=1, channels=3,
                layer_sizes=tuple(cfg["LAYER_SIZE_UNET"]), block_attn=cfg["BLOCK_ATTN"],
                mid_attn=cfg["MID_ATTN"], cylindrical=cfg["CYLINDRICAL"],
                compress_Z=cfg["COMPRESS_Z"], data_shape=tuple(cfg["SHAPE_FINAL"][2:]),
                cond_embed=cfg["COND_EMBED"] == "sin", cond_size=2 + cfg["SHAPE_FINAL"][2],
                time_embed=cfg["TIME_EMBED"] == "sin")


def counts_reset(attn):
    torch.cuda.synchronize()
    attn.fused_attention_block.launches = attn.attention_block_backward.launches = 0


def counts_read(attn) -> tuple[int, int]:
    torch.cuda.synchronize()
    return attn.fused_attention_block.launches, attn.attention_block_backward.launches


def train_variant(name, cfg, batches, val, attn, card, seed, prior=None,
                  blocks=len(DS2_ATTENTION_BLOCKS)):
    """TrainDiffusion.train at full width: one epoch of the batches and one
    val batch, each step's loss finite and its K1 and K2 launches ``blocks``
    (the val batch's K1 too); with ``prior`` the cold prior is set on the
    model first (set_cold_prior: no AVG_SHOWER_LOC file on the card).
    Returns the results and the trained model."""
    from unittest import mock

    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    recorder = Recorder(TrainDiffusion.train_step, attn)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = TrainDiffusion(default_flags(checkpoint_folder=ckpt_dir, seed=seed),
                                 dict(cfg, MAXEPOCH=1, BATCH=BATCH),
                                 loader_train=batches, loader_val=val)
        trainer.init_model()
        if prior is not None:
            trainer.model.set_cold_prior(*prior)
        torch.cuda.reset_peak_memory_stats()
        counts_reset(attn)
        t0 = time.perf_counter()
        with mock.patch.object(TrainDiffusion, "train_step", recorder.bind()):
            trainer.train()
        wall = time.perf_counter() - t0
        k1, k2 = counts_read(attn)
    recorder.check(f"networks {name} train step", len(batches), (blocks, blocks))
    if (k1, k2) != (blocks * (len(batches) + len(val)), blocks * len(batches)):
        fail(f"networks {name}: train launched K1 {k1} and K2 {k2} times")
    steps = recorder.calls
    steady = statistics.mean(s["s"] for s in steps[1:])
    mem = torch.cuda.max_memory_allocated() / 2**30
    print(f"networks {name} train: {len(steps)} steps of {BATCH}, bf16, full width: first "
          f"(cold) step {steps[0]['s']:.3f} s, steady {1e3 * steady:.2f} ms/step, "
          f"{BATCH / steady:.1f} train samples/s on {card}; TrainDiffusion.train {wall:.2f} s; "
          f"K1 {k1}, K2 {k2}; peak memory {mem:.2f} GiB; losses {steps[0]['loss']:.4g} .. "
          f"{steps[-1]['loss']:.4g}", flush=True)
    return dict(steps=len(steps), cold_step_s=steps[0]["s"], steady_step_s=steady,
                samples_per_s=BATCH / steady, wall_s=wall, k1=k1, k2=k2,
                max_memory_gib=mem), trainer.model


def generate_variant(name, model, steps, attn, card, seed, blocks=len(DS2_ATTENTION_BLOCKS)):
    """generate of one batch of 128 at ``steps``-step DDim: showers finite,
    >= 0, (128, 6480); K1 ``blocks`` a denoise, K2 never."""
    from unittest import mock

    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    loader = list(synthetic_loader(1, model.config["SHAPE_FINAL"][2] + 1, seed))
    first = []
    counts_reset(attn)
    t0 = time.perf_counter()
    with mock.patch.object(CaloDiffusion, "denoise",
                           synced(CaloDiffusion.denoise, first, first_only=True)):
        showers, _ = model.generate(loader, steps,
                                    generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = counts_read(attn)
    if showers.shape != (BATCH, 6480) or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"networks {name}: generated showers {showers.shape}, not all finite and >= 0")
    if (k1, k2) != (blocks * steps, 0):
        fail(f"networks {name}: generate launched K1 {k1} and K2 {k2} times, expected "
             f"{blocks * steps} and 0")
    sps, steady = BATCH / wall, BATCH / ((wall - first[0]) * steps / (steps - 1))
    print(f"networks {name} sample: {BATCH} showers, {steps}-step DDim, bf16: {wall:.2f} s, "
          f"{sps:.3f} showers/s on {card} (first, cold denoise {first[0]:.3f} s; without it "
          f"{steady:.3f} showers/s); K1 {k1}, K2 {k2}", flush=True)
    return dict(showers=BATCH, wall_s=wall, showers_per_s=sps,
                showers_per_s_after_first_step=steady, first_denoise_s=first[0], k1=k1, k2=k2)


# the cold sub-phase's synthetic ds2 showers: 4 train batches of 128
COLD_SHOWERS = 512


def run_cold(cfg, args, attn, card):
    """Cold diffusion: synthetic raw ds2 showers preprocessed as the loader
    caches them, at SHOWERSCALE 0.001 (the scale create_average_showers
    reads, so that the log energies fill its bins over [0, 1]: the shipped
    configs spell the key SHOWER_SCALE, and the loader's default is 200);
    the prior from them (average_showers, set_cold_prior), its start
    checks, 20 train steps on them and 128 showers of --steps-step DDim from
    the prior, one f32 denoise and one f32 cold train step card against
    CPU."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.tools.create_average_showers import average_showers

    cold_cfg = dict(cfg, COLD_DIFFU=True, SHOWERSCALE=0.001)
    raw, energies = raw_showers(np.random.default_rng(args.seed + 100), COLD_SHOWERS, 6480)
    E_all, layers, showers = preprocessed(raw, energies, cold_cfg)
    prior = average_showers(showers, E_all, cfg["DATASET_NUM"])
    filled = int((prior[0].reshape(len(prior[0]), -1) != 0).any(1).sum())
    m = CaloDiffusion(cold_cfg, generator=torch.Generator().manual_seed(args.seed + 100))
    m.set_cold_prior(*prior)
    # COLD_NOISE 0: the start is the binned average; energies in different
    # bins (the showers' least and greatest) start apart
    E2 = torch.tensor([[E_all.min()], [E_all.max()]], dtype=torch.float32, device="cuda")
    noise = torch.randn((2, *m._data_shape), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    avg, _ = m.lookup_avg_std_shower(E2)
    if not torch.equal(m.gen_cold_image(E2, 0.0, noise), avg) or torch.equal(avg[0], avg[1]):
        fail("networks cold: COLD_NOISE 0 does not start from the binned average, or two "
             "energies in different bins start alike")
    batches = [(E_all[i:i + BATCH], layers[i:i + BATCH], showers[i:i + BATCH])
               for i in range(0, len(E_all) - BATCH + 1, BATCH)]
    batches = (batches * NETWORK_TRAIN_STEPS)[:NETWORK_TRAIN_STEPS]
    print(f"networks cold: prior of {len(E_all)} synthetic ds2 showers, {len(prior[2])} "
          f"energy bins ({filled} filled), log energies {E_all.min():.3f} .. "
          f"{E_all.max():.3f}; COLD_NOISE {cold_cfg['COLD_NOISE']}", flush=True)
    train, model = train_variant("cold", cold_cfg, batches, batches[:1], attn, card,
                                 args.seed + 101, prior=prior)
    sample = generate_variant("cold", model, args.steps, attn, card, args.seed + 102)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    denoise_err = check_card_vs_cpu(cold_cfg, state, args.seed + 103, phase="networks cold")
    step = check_train_step_card_vs_cpu(cold_cfg, state, args.seed + 104, attn,
                                        phase="networks cold", prior=prior)
    return dict(prior_showers=len(E_all), bins=len(prior[2]), filled_bins=filled, train=train,
                sample=sample, card_vs_cpu_denoise=denoise_err, card_vs_cpu_step=step)


def run_fcn(cfg, args, attn, card):
    """The dense FCN shower model ("FCN-orig", NUM_LAYERS_LINEAR 3, hidden
    512; SHOWERMAP "logit-norm", as the inverse preprocessing of flat ds2
    showers fails with layers in both packages): 20 train steps, 128
    showers of --steps-step DDim, no kernel launched; f32 card against CPU."""
    fcn_cfg = dict(cfg, SHOWER_EMBED="FCN-orig", NUM_LAYERS_LINEAR=3, SHOWERMAP="logit-norm")
    n_layers = cfg["SHAPE_FINAL"][2] + 1
    batches = [synthetic_batch(BATCH, n_layers, args.seed + 110 + i, (6480,))
               for i in range(NETWORK_TRAIN_STEPS)]
    train, model = train_variant("fcn", fcn_cfg, batches, batches[:1], attn, card,
                                 args.seed + 111, blocks=0)
    sample = generate_variant("fcn", model, args.steps, attn, card, args.seed + 112, blocks=0)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    denoise_err = check_card_vs_cpu(fcn_cfg, state, args.seed + 113, phase="networks fcn")
    step = check_train_step_card_vs_cpu(fcn_cfg, state, args.seed + 114, attn,
                                        phase="networks fcn", blocks=0)
    return dict(train=train, sample=sample, card_vs_cpu_denoise=denoise_err,
                card_vs_cpu_step=step)


def run_remat(cfg, state_dict, args, attn, card):
    """Phase 5's ds2 step at batch 128, bf16, with REMAT and without, from
    the same weights, batch, noise and sigmas: the loss and every gradient
    agree within phase 5's step tolerances; each way's peak allocated memory
    (reset before its first timed step) and its ms a step (forward, loss and
    backward; after one warm-up step); K1 and K2 7 a step both ways."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    n = len(DS2_ATTENTION_BLOCKS)
    E, layers, data = (torch.from_numpy(a).cuda() for a in
                       synthetic_batch(BATCH, cfg["SHAPE_FINAL"][2] + 1, args.seed + 120))
    rng = np.random.default_rng(args.seed + 121)
    noise = torch.from_numpy(rng.standard_normal(data.shape).astype(np.float32)).cuda()
    rnd = torch.from_numpy(rng.standard_normal(BATCH).astype(np.float32)).cuda()
    ways = {}
    for remat in (False, True):
        m = CaloDiffusion(dict(cfg, REMAT=remat))
        m.load_state_dict(state_dict)
        params = list(m.parameters())

        def step():
            for p in params:
                p.grad = None
            loss = m.compute_loss(data, E, noise=noise, layers=layers, rnd_normal=rnd)
            loss.backward()
            return loss

        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        counts_reset(attn)
        times = []
        for _ in range(REMAT_STEPS):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            loss = step()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        k1, k2 = counts_read(attn)
        if (k1, k2) != (n * REMAT_STEPS, n * REMAT_STEPS):
            fail(f"networks remat={remat}: {REMAT_STEPS} steps launched K1 {k1} and K2 {k2} "
                 f"times")
        ways[remat] = dict(loss=loss.item(), grads={k: p.grad.detach().double()
                                                    for k, p in m.named_parameters()},
                           peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
                           step_ms=statistics.median(times), k1=k1, k2=k2)
        del m, params
    plain, remat = ways[False], ways[True]
    loss_rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    G = max(g.abs().max().item() for g in plain["grads"].values())
    errs = {k: ((remat["grads"][k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
            for k, g in plain["grads"].items()}
    worst = max(errs, key=errs.get)
    if loss_rel > STEP_LOSS_RTOL or errs[worst] > STEP_GRAD_TOL:
        fail(f"networks remat: loss {loss_rel:.3g} relative, gradient {worst} {errs[worst]:.3g} "
             f"from the plain step's")
    if not remat["peak_gib"] < plain["peak_gib"]:
        fail(f"networks remat: peak memory {remat['peak_gib']:.3f} GiB, not below the plain "
             f"step's {plain['peak_gib']:.3f}")
    print(f"networks remat: ds2 step, batch {BATCH}, bf16: peak allocated above the weights "
          f"{remat['peak_gib']:.3f} GiB with REMAT against {plain['peak_gib']:.3f} without; "
          f"{remat['step_ms']:.2f} ms a step against {plain['step_ms']:.2f} on {card}; loss "
          f"{loss_rel:.3g} relative, worst gradient {worst} {errs[worst]:.3g} (tol "
          f"{STEP_LOSS_RTOL}, {STEP_GRAD_TOL}); K1 {remat['k1']}, K2 {remat['k2']} over "
          f"{REMAT_STEPS} steps", flush=True)
    return dict(peak_gib=remat["peak_gib"], plain_peak_gib=plain["peak_gib"],
                step_ms=remat["step_ms"], plain_step_ms=plain["step_ms"], loss_rel=loss_rel,
                worst_grad=worst, worst_grad_err=errs[worst], k1=remat["k1"], k2=remat["k2"])


def run_convnext(cfg, args, attn, q1, nn_modules, card):
    """CondUnet(use_convnext=True) at ds2's widths (CaloDiffusion's
    unet_options), bf16: a denoise of 128 (K1 7) and a train step (K2 7),
    timed; f32 card against CPU; then under QUANT_INT8 its calibration and
    one int8 denoise (Q1 once a quantized conv, the plain version never),
    and Q1 against its plain version bit for bit at each of its geometries
    with the plan it takes."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    n = len(DS2_ATTENTION_BLOCKS)
    opts = dict(use_convnext=True)
    m = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(args.seed + 130),
                      unet_options=opts)
    E, layers, data = (torch.from_numpy(a).cuda() for a in
                       synthetic_batch(BATCH, cfg["SHAPE_FINAL"][2] + 1, args.seed + 131))
    sigma = torch.full((BATCH, 1, 1, 1, 1), 0.7, device="cuda")

    def forward():
        with torch.no_grad():
            return m.denoise(data, E=E, sigma=sigma, layers=layers)

    def train_step():
        for p in m.parameters():
            p.grad = None
        loss = m.compute_loss(data, E, layers=layers)
        loss.backward()
        return loss

    counts_reset(attn)
    out = forward()
    fwd = counts_read(attn)
    counts_reset(attn)
    loss = train_step()
    stp = counts_read(attn)
    if fwd != (n, 0) or stp != (n, n) or not torch.isfinite(out).all() or \
            not np.isfinite(loss.item()):
        fail(f"networks convnext: a forward launched K1/K2 {fwd}, a step {stp}; expected "
             f"({n}, 0) and ({n}, {n}); finite {bool(torch.isfinite(out).all())}")
    fwd_ms, step_ms = time_ms(forward, reps=10), time_ms(train_step, warmup=1, reps=5)
    state = {k: v.detach().cpu() for k, v in m.state_dict().items()}
    print(f"networks convnext: ds2 widths, bf16, batch {BATCH}: a denoise {fwd_ms:.2f} ms, a "
          f"train step {step_ms:.2f} ms on {card}; K1 {fwd[0]} a denoise, K1/K2 {stp} a step",
          flush=True)
    denoise_err = check_card_vs_cpu(cfg, state, args.seed + 132, phase="networks convnext",
                                    unet_options=opts)

    # int8: the calibration, one denoise under int8_scope, its Q1 geometries
    mq = CaloDiffusion(dict(cfg, QUANT_INT8=True), unet_options=opts)
    mq.load_state_dict(state)
    table = mq.prepare_int8(E=E[:64], layers=layers[:64],
                            generator=torch.Generator(device="cuda").manual_seed(args.seed))
    if set(table) != set(mq.quantizable_convs()):
        fail(f"networks convnext int8: {len(table)} scales for "
             f"{len(mq.quantizable_convs())} quantizable convs")
    with Int8Counts(q1, attn) as counts:
        calls = q1_calls_of_a_denoise(mq, E, layers, q1, nn_modules)
    got = counts.read()
    if got != dict(q1=len(table), plain=0, k1=n, k2=0):
        fail(f"networks convnext int8: one denoise launched {got}, expected Q1 {len(table)}, "
             f"plain 0, K1 {n}")
    geometries = list(dict.fromkeys(calls))
    lib = q1.KERNEL.library(torch.empty(1, dtype=torch.bfloat16, device="cuda"))
    plans = []
    for x_shape, w_shape, stride, pad, cyl, _ in geometries:
        plan = q1.kernel_plan(lib, x_shape, w_shape, stride, pad, cyl)
        plans.append(dict(x=list(x_shape), w=list(w_shape), **plan))
        print(f"networks convnext int8: Q1 x {x_shape} w {w_shape} stride {stride}: plan "
              f"{plan['mode']}, {plan['NT']}-channel tiles, {128 * plan['MW']} rows a CTA, "
              f"{plan['smem_bytes']} B of shared memory", flush=True)
    cases = check_q1(q1, geometries)
    print(f"networks convnext int8: {len(table)} scales; one denoise launched Q1 {got['q1']} "
          f"times ({len(geometries)} geometries, {sum(p['mode'] == 'stream' for p in plans)} "
          f"streamed), K1 {got['k1']}, the plain version {got['plain']}", flush=True)
    return dict(forward_ms=fwd_ms, step_ms=step_ms, k1_forward=fwd[0], k1_train=stp[0],
                k2_train=stp[1], card_vs_cpu_denoise=denoise_err, int8_scales=len(table),
                int8=got, q1_plans=plans, q1_cases=cases)


def run_controlnet(cfg, args, attn, card):
    """ControlledUnet at ds2's widths, bf16, batch 128: a forward (K1 11)
    and a train step with the base frozen (K2 7), timed; the f32 forward
    card against CPU within 2e-4."""
    from calodiffusion_tpu_torch.models.controlnet import ControlledUnet, freeze_base

    kw = ds2_unet_kwargs(cfg)
    net = ControlledUnet(kw, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(args.seed + 140)).cuda()
    trained = freeze_base(net)
    state = {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(args.seed + 141)

    def inputs(batch, dev):
        x = rng.standard_normal((batch, 3, *kw["data_shape"])).astype(np.float32)
        xc = rng.standard_normal((batch, 3, *kw["data_shape"])).astype(np.float32)
        c = rng.uniform(0, 1, (batch, kw["cond_size"])).astype(np.float32)
        t = rng.uniform(-2, 1, (batch,)).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in (x, xc, c, t)]

    args_b = inputs(BATCH, "cuda")
    opt = torch.optim.Adam([p for p in net.parameters() if p.requires_grad], lr=1e-4)

    def forward():
        with torch.no_grad():
            return net(*args_b)

    def train_step():
        opt.zero_grad(set_to_none=True)
        loss = net(*args_b).square().mean()
        loss.backward()
        opt.step()
        return loss

    counts_reset(attn)
    out = forward()
    fwd = counts_read(attn)
    counts_reset(attn)
    loss = train_step()
    stp = counts_read(attn)
    frozen_grads = sum(p.grad is not None for k, p in net.named_parameters()
                       if k.startswith("model."))
    if fwd != (CONTROLNET_K1, 0) or stp != (CONTROLNET_K1, CONTROLNET_K2) or frozen_grads or \
            not torch.isfinite(out).all() or not np.isfinite(loss.item()):
        fail(f"networks controlnet: a forward launched K1/K2 {fwd}, a step {stp}, expected "
             f"({CONTROLNET_K1}, 0) and ({CONTROLNET_K1}, {CONTROLNET_K2}); {frozen_grads} "
             f"frozen parameters took a gradient")
    fwd_ms, step_ms = time_ms(forward, reps=10), time_ms(train_step, warmup=1, reps=5)

    outs, x2 = [], inputs(2, "cpu")
    for dev in ("cuda", "cpu"):
        m = ControlledUnet(kw).to(dev)
        m.load_state_dict(state)
        with torch.no_grad():
            outs.append(m(*(a.to(dev) for a in x2)).cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    if not err <= 2e-4:
        fail(f"networks controlnet: f32 forward card vs CPU {err:.3g} > 2e-4")
    print(f"networks controlnet: ds2 widths, bf16, batch {BATCH}: a forward {fwd_ms:.2f} ms, a "
          f"train step (base frozen, {len(trained)} trained tensors) {step_ms:.2f} ms on "
          f"{card}; K1/K2 {fwd} a forward, {stp} a step; f32 forward card vs CPU max_abs_err "
          f"{err:.3g} (tol 2e-4)", flush=True)
    return dict(forward_ms=fwd_ms, step_ms=step_ms, k1_forward=fwd[0], k1_train=stp[0],
                k2_train=stp[1], trained_tensors=len(trained), card_vs_cpu=err)


def run_networks_phase(cfg, state_dict, args, attn, q1, nn_modules, card):
    """Phase 15: cold, fcn, remat, convnext and controlnet at ds2's full
    width; returns the results and each path's launches."""
    res = {}
    for name, run in (("cold", lambda: run_cold(cfg, args, attn, card)),
                      ("fcn", lambda: run_fcn(cfg, args, attn, card)),
                      ("remat", lambda: run_remat(cfg, state_dict, args, attn, card)),
                      ("convnext", lambda: run_convnext(cfg, args, attn, q1, nn_modules, card)),
                      ("controlnet", lambda: run_controlnet(cfg, args, attn, card))):
        t0 = time.perf_counter()
        res[name] = run()
        res[name]["wall_s"] = time.perf_counter() - t0
        print(f"networks {name}: {res[name]['wall_s']:.1f} s", flush=True)
    paths = {
        "cold_train": (res["cold"]["train"]["k1"], res["cold"]["train"]["k2"]),
        "cold_sample": (res["cold"]["sample"]["k1"], res["cold"]["sample"]["k2"]),
        "fcn_train": (res["fcn"]["train"]["k1"], res["fcn"]["train"]["k2"]),
        "fcn_sample": (res["fcn"]["sample"]["k1"], res["fcn"]["sample"]["k2"]),
        "remat_train": (res["remat"]["k1"], res["remat"]["k2"]),
        "convnext_forward": (res["convnext"]["k1_forward"], 0),
        "convnext_train": (res["convnext"]["k1_train"], res["convnext"]["k2_train"]),
        "convnext_int8": (res["convnext"]["int8"]["k1"], res["convnext"]["int8"]["k2"]),
        "controlnet_forward": (res["controlnet"]["k1_forward"], 0),
        "controlnet_train": (res["controlnet"]["k1_train"], res["controlnet"]["k2_train"]),
    }
    q1_cases = res["convnext"].pop("q1_cases")
    return res, paths, q1_cases


# ---------------------------------------------------------------------------
# 16. scale-out: the trainer and sampling on torch.distributed
# ---------------------------------------------------------------------------

SCALE_OUT_PATHS = ("ddp_train", "ddp_sample", "hsdp_train", "hsdp_distill")
# (b) and (c): (name, model axis) of the 2-rank meshes on the one card
SCALE_OUT_MESHES = (("ddp", 1), ("hsdp", 2))
SCALE_OUT_TIMED_STEPS = 3  # (b) and (c): steps timed after the compared one
SCALE_OUT_SAMPLE_STEPS = 20  # (b): the sharded DDim sample's steps
RANK_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def trace_kernels(trace_dir: Path) -> tuple[list, set]:
    """The trace files under ``trace_dir`` and the names of the CUDA kernels
    their events hold."""
    files = sorted(trace_dir.rglob("*.pt.trace.json"))
    names = set()
    for f in files:
        for e in json.loads(f.read_text()).get("traceEvents", []):
            if e.get("cat") == "kernel":
                names.add(e.get("name", ""))
    return files, names


def run_nccl_one_rank(cfg, cfg_path, data, root, cli_train, attn, card):
    """(a): training.main in this process under an NCCL group of one rank
    (the trainer's mesh 1 x 1, the U-Net in DDP) on the cli phase's ds2
    caches and seed: K1 and K2 7 a step, the losses those of the cli
    phase's run without a group; then 2 epochs with TRACE_DIR, whose trace
    of the second epoch must name K1's and K2's kernels."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel
    from unittest import mock

    from calodiffusion_tpu_torch import training
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    n = len(DS2_ATTENTION_BLOCKS)
    out = root / "scale_out"
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1)
    try:
        recorder = Recorder(TrainDiffusion.train_step, attn)
        common = ["-c", cfg_path, "-d", data, "--seed", str(cli_train["seed"])]
        torch.cuda.reset_peak_memory_stats()
        counts_reset(attn)
        t0 = time.perf_counter()
        with mock.patch.object(TrainDiffusion, "train_step", recorder.bind()):
            trainer = training.main(common + ["--checkpoint", str(out / "ckpt"), "diffusion"])
        wall = time.perf_counter() - t0
        k1, k2 = counts_read(attn)
        mem = torch.cuda.max_memory_allocated() / 2**30
        if not isinstance(trainer._wrapped, DistributedDataParallel):
            fail(f"scale-out (a): the U-Net ran in {type(trainer._wrapped).__name__}, not DDP")
        steps = recorder.calls
        recorder.check("scale-out (a) train step", cli_train["steps"], (n, n))
        if (k1, k2) != (n * (len(steps) + 1), n * len(steps)):
            fail(f"scale-out (a): train launched K1 {k1} and K2 {k2} times")
        losses, want = [s["loss"] for s in steps], cli_train["losses"]
        diff = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        if diff > STEP_LOSS_RTOL:
            fail(f"scale-out (a): losses {losses} under NCCL against {want} without a group: "
                 f"{diff:.3g} relative > {STEP_LOSS_RTOL}")
        steady = statistics.mean(s["s"] for s in steps[1:])
        print(f"scale-out (a): training.main under NCCL, 1 rank (DDP), {len(steps)} steps of "
              f"{BATCH}, bf16, full width: steady {1e3 * steady:.2f} ms/step on {card}; peak "
              f"memory {mem:.2f} GiB; K1 {k1}, K2 {k2}; losses {losses}, without a group "
              f"{want}: largest difference {diff:.3g} relative"
              f"{' (bit for bit)' if losses == want else ''}", flush=True)

        trace_dir = out / "trace"
        trace_cfg = out / "trace_config.json"
        trace_cfg.write_text(json.dumps(dict(cfg, MAXEPOCH=2, TRACE_DIR=str(trace_dir))))
        counts_reset(attn)
        t0 = time.perf_counter()
        training.main(["-c", str(trace_cfg)] + common[2:]
                      + ["--checkpoint", str(out / "trace_ckpt"), "diffusion"])
        trace_wall = time.perf_counter() - t0
        files, names = trace_kernels(trace_dir)
        k1_names = sorted(x for x in names if "attention_block_kernel" in x)
        k2_names = sorted(x for x in names if "attention_block_bwd_kernel" in x)
        if len(files) != 1 or not k1_names or not k2_names:
            fail(f"scale-out (a): TRACE_DIR wrote {len(files)} traces (expected 1) naming K1 "
                 f"{k1_names} and K2 {k2_names}")
        print(f"scale-out (a): TRACE_DIR, 2 epochs in {trace_wall:.2f} s: {files[0].name}, "
              f"{files[0].stat().st_size / 2**20:.1f} MiB, {len(names)} kernel names, K1 "
              f"{k1_names[0][:60]}, K2 {k2_names[0][:60]}", flush=True)
    finally:
        dist.destroy_process_group()
    return dict(steps=len(steps), losses=losses, losses_without_group=want,
                largest_loss_rel_diff=diff, bit_for_bit=losses == want,
                steady_step_s=steady, wall_s=wall, max_memory_gib=mem, k1=k1, k2=k2,
                trace_file_mib=files[0].stat().st_size / 2**20, trace_wall_s=trace_wall,
                trace_k1=k1_names[0], trace_k2=k2_names[0])


def scale_out_inputs(state_dict, seed) -> dict:
    """The compared step's and sample's inputs at ds2's shapes, batch 128:
    the batch, its noise and sigma draws, and the sample's conditioning."""
    from calodiffusion_tpu_torch.utils.config import load_config

    cfg = load_config(str(CONFIG))
    n_layers = cfg["SHAPE_FINAL"][2] + 1
    E, layers, data = synthetic_batch(BATCH, n_layers, seed)
    rng = np.random.default_rng(seed + 1)
    return dict(state_dict=state_dict, E=E, layers=layers, data=data,
                noise=rng.standard_normal(data.shape).astype(np.float32),
                rnd=rng.standard_normal(BATCH).astype(np.float32),
                sample_E=rng.uniform(0.0, 1.0, (BATCH, 1)).astype(np.float32),
                sample_layers=rng.standard_normal((BATCH, n_layers)).astype(np.float32),
                # (d)'s grid indices over the Consistency grid's CONSIS_NSTEPS - 1 gaps
                distill_idx=np.random.default_rng(seed + 2).integers(
                    0, cfg.get("CONSIS_NSTEPS", 100) - 1, BATCH),
                seed=seed)


def scale_out_step(inp, mesh, attn):
    """One f32 train step at ds2's full width on ``mesh`` (None: one
    process) from the inputs' weights, batch, noise and sigmas: its loss,
    gradients and parameters after Adam, whole; then SCALE_OUT_TIMED_STEPS
    more, timed; K1 and K2 launches of the compared step."""
    from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags, load_config

    cfg = dict(load_config(str(CONFIG)), PRECISION="f32")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        t = TrainDiffusion(default_flags(checkpoint_folder=ckpt_dir, seed=inp["seed"]), cfg,
                           load_data=False, save_model=False, mesh=mesh)
    t.init_model()
    t.model.load_state_dict(mesh_lib.shard_like(inp["state_dict"], t.model.state_dict()))
    t.make_optimizer(float(cfg["LR"]))
    E, layers, data = t._device_batch(inp["E"], inp["layers"], inp["data"])
    noise, rnd = (mesh_lib.shard_batch(mesh, torch.from_numpy(inp[k]).cuda())
                  for k in ("noise", "rnd"))
    torch.cuda.reset_peak_memory_stats()
    counts_reset(attn)
    loss = t._accumulate_grads(data, E, layers, noise=noise, rnd_normal=rnd)
    t._apply_update()
    k1, k2 = counts_read(attn)
    loss = float(mesh_lib.all_reduce_mean(mesh, loss))
    # copies: a state_dict's tensors are the live parameters the timed steps move
    grads = {k: v.cpu().clone() for k, v in mesh_lib.full_state(
        {k: p.grad.detach() for k, p in t.model.named_parameters()}).items()}
    params = {k: v.cpu().clone()
              for k, v in mesh_lib.full_state(t.model.state_dict()).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SCALE_OUT_TIMED_STEPS):
        t.train_step(data, E, layers)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / SCALE_OUT_TIMED_STEPS
    return dict(loss=loss, grads=grads, params=params, k1=k1, k2=k2,
                step_ms=1e3 * step_s, rows=int(data.shape[0]),
                wrapper=type(t._wrapped).__name__ if t._wrapped is not None else None,
                max_memory_gib=torch.cuda.max_memory_allocated() / 2**30, lr=float(cfg["LR"]))


def scale_out_sample(inp, mesh, attn):
    """A 2-rank-shardable f32 DDim sample of the inputs' 128 conditionings
    from the inputs' weights (SCALE_OUT_SAMPLE_STEPS steps): this rank's
    rows, K1 launches, wall."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.utils.config import load_config

    cfg = dict(load_config(str(CONFIG)), PRECISION="f32")
    model = CaloDiffusion(cfg)
    model.load_state_dict(inp["state_dict"])
    E, layers = (torch.from_numpy(inp[k]).cuda() for k in ("sample_E", "sample_layers"))
    counts_reset(attn)
    t0 = time.perf_counter()
    x = model.sample(E, layers, SCALE_OUT_SAMPLE_STEPS,
                     generator=torch.Generator(device="cuda").manual_seed(inp["seed"]),
                     mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = counts_read(attn)
    return dict(x=x.float().cpu(), k1=k1, k2=k2, wall_s=wall)


def scale_out_rank(rank: int, world: int, model_axis: int, port: int, folder: str) -> None:
    """One rank of (b), or of (c) and (d), in its own process: a gloo group
    over localhost, the card's CUDA tensors, a (world / model_axis,
    model_axis) mesh; the step, then on the data axis the sample and on the
    model axis the distillation; the results to ``<folder>/rank<rank>.pt``."""
    import torch.distributed as dist

    from calodiffusion_tpu_torch.ops import linear_attention as attn
    from calodiffusion_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    inp = torch.load(Path(folder) / "inputs.pt", weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        mesh = mesh_lib.make_mesh(data=world // model_axis, model=model_axis)
        out = scale_out_step(inp, mesh, attn)
        if model_axis == 1:
            out["sample"] = scale_out_sample(inp, mesh, attn)
        else:  # (d) on the same ranks
            out["distill"] = scale_out_distill(inp, mesh, attn, Path(folder) / "distill",
                                               checkpoint=True)
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(folder) / f"rank{rank}.pt")


def run_ranks_on_card(world: int, model_axis: int, folder: Path) -> list:
    """Start the ranks of (b) or (c) as processes of this script, wait for
    every one (each killed at RANK_TIMEOUT_S), fail on any failure; their
    results by rank."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--scale-out-rank", str(r), str(world), str(model_axis), str(port),
                               str(folder)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        fail(f"scale-out: a rank of {world // model_axis} x {model_axis} failed:\n"
             + "\n".join(f"rank {r}: {log[-3000:]}" for r, log in enumerate(logs)))
    return [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(world)]


def check_step_against_one_process(what, got, want, start, card):
    """A sharded f32 step against one process's from the weights ``start``:
    the loss within phase 5's STEP_LOSS_RTOL, every gradient within
    STEP_GRAD_TOL (max-norm, relative to max |g| + 1e-3 G), every parameter
    after Adam within 2 lr of one process's (Adam's first step moves an
    entry by lr times the sign of its gradient: an entry whose gradient is
    at roundoff may move the other way) and the update, over the whole
    tree, within 2 % of one process's in norm."""
    loss_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    G = max(g.abs().max().item() for g in want["grads"].values())
    errs = {k: ((got["grads"][k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
            for k, g in want["grads"].items()}
    worst = max(errs, key=errs.get)
    p_abs = max((got["params"][k] - p).abs().max().item() for k, p in want["params"].items())
    # distillation's target after its EMA update, where the step has one
    e_abs = max((got["ema"][k] - p).abs().max().item()
                for k, p in want["ema"].items()) if "ema" in want else 0.0
    u_norm = math.sqrt(sum(((got["params"][k] - p) ** 2).sum().item()
                           for k, p in want["params"].items())
                       / sum(((p - start[k].float()) ** 2).sum().item()
                             for k, p in want["params"].items()))
    if not (np.isfinite(got["loss"]) and loss_rel <= STEP_LOSS_RTOL
            and errs[worst] <= STEP_GRAD_TOL and p_abs <= 2 * want["lr"] * (1 + 1e-3)
            and e_abs <= 2 * want["lr"] * (1 + 1e-3) and u_norm <= 0.02):
        fail(f"scale-out {what}: against one process: loss {got['loss']} vs {want['loss']} "
             f"({loss_rel:.3g}), gradient {worst} {errs[worst]:.3g}, parameters {p_abs:.3g}, "
             f"target {e_abs:.3g} (2 lr {2 * want['lr']:.3g}), the update {u_norm:.3g} apart "
             "in norm")
    target_text = f", target after its EMA update {e_abs:.3g} (tol 2 lr)" if "ema" in want else ""
    print(f"scale-out {what}: f32 step of {BATCH} ({got['rows']} rows a rank, "
          f"{got['wrapper']}) against one process: loss {got['loss']:.6g} vs "
          f"{want['loss']:.6g} ({loss_rel:.3g} relative, tol {STEP_LOSS_RTOL}); worst "
          f"gradient {worst} {errs[worst]:.3g} (tol {STEP_GRAD_TOL}); parameters after Adam "
          f"{p_abs:.3g} (tol 2 lr){target_text}, the update {u_norm:.3g} apart in norm (tol "
          f"0.02); {got['step_ms']:.1f} ms a timed {got.get('timed', 'f32')} step (one process "
          f"{want['step_ms']:.1f}), peak memory "
          f"{got['max_memory_gib']:.2f} GiB a rank on {card}", flush=True)
    return dict(loss=got["loss"], loss_one_process=want["loss"], loss_rel=loss_rel,
                worst_grad=worst, worst_grad_err=errs[worst], param_max_abs=p_abs,
                target_max_abs=e_abs if "ema" in want else None,
                update_norm_rel=u_norm, step_ms=got["step_ms"],
                step_ms_one_process=want["step_ms"], max_memory_gib=got["max_memory_gib"],
                rows_a_rank=got["rows"], wrapper=got["wrapper"])


# (d) hsdp_distill: consistency distillation on data 1 x model 2
DISTILL_TIMED_STEPS = 3  # bf16 steps timed after one untimed


def scale_out_distill(inp, mesh, attn, folder, checkpoint=False):
    """16(d) on ``mesh`` (None: one process): consistency distillation of
    the teacher ``inp["state_dict"]`` (phase 4's weights) at ds2's full
    width, batch 128.  One f32 step with the inputs' grid indices and noise
    (its loss, the student's gradients, the student and the target after
    it, whole; K1 and K2 launches); then DISTILL_TIMED_STEPS bf16 steps with
    the trainer's own draws after an untimed one, each with its launches.
    With ``checkpoint``, the bf16 trainer's checkpoint (rank 0 writes, every
    shard gathered) restored into a fresh trainer: whether the student, the
    target (in the target network) and Adam's state come back whole."""
    from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
    from calodiffusion_tpu_torch.train.schedulers import EarlyStopper, ReduceLROnPlateau
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
    from calodiffusion_tpu_torch.utils.config import default_flags, load_config

    cfg = dict(load_config(str(CONFIG)), CHECKPOINT_NAME="hsdp_distill")
    lr = float(cfg["LR"])

    def trainer(precision):
        t = TrainDistillation(default_flags(checkpoint_folder=str(folder), seed=inp["seed"]),
                              dict(cfg, PRECISION=precision), teacher_params=inp["state_dict"],
                              load_data=False, save_model=False, mesh=mesh)
        t.init_model()
        t.make_optimizer(lr)
        return t

    def whole(tree):
        return {k: v.detach().cpu().clone() for k, v in mesh_lib.full_state(tree).items()}

    t = trainer("f32")
    E, layers, data = t._device_batch(inp["E"], inp["layers"], inp["data"])
    idx, noise = (mesh_lib.shard_batch(mesh, torch.from_numpy(inp[k]).cuda())
                  for k in ("distill_idx", "noise"))
    torch.cuda.reset_peak_memory_stats()
    counts_reset(attn)
    loss = t.train_step(data, E, layers, idx=idx, noise=noise)
    k1, k2 = counts_read(attn)
    out = dict(loss=float(mesh_lib.all_reduce_mean(mesh, loss)), k1=k1, k2=k2, lr=lr,
               grads=whole({k: p.grad for k, p in t.model.named_parameters()}),
               params=whole(t.model.state_dict()), ema=whole(t.ema_params),
               rows=int(data.shape[0]), sharded_target=t._target is not None,
               wrapper=type(t._wrapped).__name__ if t._wrapped is not None else None)
    del t
    tb = trainer("bf16")
    steps = []
    for _ in range(DISTILL_TIMED_STEPS + 1):
        counts_reset(attn)
        t0 = time.perf_counter()
        loss = tb.train_step(data, E, layers)
        torch.cuda.synchronize()
        steps.append(dict(s=time.perf_counter() - t0, loss=float(loss),
                          launches=counts_read(attn)))
    out.update(bf16_steps=steps, step_ms=1e3 * statistics.mean(s["s"] for s in steps[1:]),
               timed="bf16", max_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    if checkpoint:
        def sched():
            return ReduceLROnPlateau(lr, factor=0.1, patience=15), EarlyStopper(
                patience=cfg["EARLYSTOP"], mode="val_loss", min_delta=1e-5)

        tb.save_model = True
        t0 = time.perf_counter()
        tb._save("checkpoint", 0, {0: steps[-1]["loss"]}, {}, *sched())
        save_s = time.perf_counter() - t0
        fresh = trainer("bf16")
        fresh.pickup_checkpoint(*sched(), restart_training=False)
        target = (fresh._target_network().state_dict() if fresh._target is not None
                  else fresh.ema_params)
        pairs = [(whole(tb.model.state_dict()), whole(fresh.model.state_dict())),
                 (whole(tb.ema_params), whole(target))]
        opt = [mesh_lib.full_state(x.opt.state_dict()["state"]) for x in (tb, fresh)]
        out.update(checkpoint=str(Path(tb.checkpoint_folder) / "checkpoint.ckpt"),
                   save_s=save_s, restored_whole=all(
                       torch.equal(v, b[k]) for a, b in pairs for k, v in a.items())
                   and all(torch.equal(v.cpu(), opt[1][i][k].cpu())
                           for i, st in opt[0].items() for k, v in st.items()
                           if isinstance(v, torch.Tensor)))
    return out


def sample_distilled(path, inp, attn, card):
    """A DISTILL_SAMPLE_STEPS-step Consistency sample of the inputs' 128
    conditionings from the distilled checkpoint ``path``, loaded as a plain
    CaloDiffusion checkpoint (its EMA, the target): showers finite, >= 0,
    of SHAPE_ORIG; K1 7 an evaluation, K2 never."""
    from calodiffusion_tpu_torch.samplers import get_sampler
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags, load_config

    cfg = dict(load_config(str(CONFIG)), SAMPLER="Consistency")
    model = TrainDiffusion(default_flags(model_loc=path), cfg, load_data=False,
                           save_model=False).load_for_inference()
    n = len(DS2_ATTENTION_BLOCKS)
    loader = [(inp["sample_E"], inp["sample_layers"], None)]
    counts_reset(attn)
    t0 = time.perf_counter()
    showers, _ = model.generate(loader, DISTILL_SAMPLE_STEPS,
                                generator=torch.Generator(device="cuda").manual_seed(inp["seed"]),
                                sampler=get_sampler("Consistency")(model.config))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = counts_read(attn)
    shape = (BATCH, *cfg["SHAPE_ORIG"][1:])
    if showers.shape != shape or not np.isfinite(showers).all() or (showers < 0).any():
        fail(f"scale-out (d): Consistency showers {showers.shape} (expected {shape}), not all "
             "finite and >= 0")
    if (k1, k2) != (n * DISTILL_SAMPLE_STEPS, 0):
        fail(f"scale-out (d): the Consistency sample launched K1 {k1} and K2 {k2} times")
    print(f"scale-out (d): {DISTILL_SAMPLE_STEPS}-step Consistency sample of {BATCH} from the "
          f"gathered checkpoint (a plain CaloDiffusion checkpoint): {wall:.2f} s, "
          f"{BATCH / wall:.3f} showers/s on {card}; K1 {k1}, K2 {k2}", flush=True)
    return dict(steps=DISTILL_SAMPLE_STEPS, wall_s=wall, showers_per_s=BATCH / wall, k1=k1, k2=k2)


def check_hsdp_distill(ranks, one, inp, attn, card):
    """16(d)'s checks: the student FSDP2's and the teacher and target
    sharded on each rank; K1 4 x 7 (student, teacher twice, target) and K2
    7 in every step of every rank; both ranks the same step; rank 0's f32
    step against one process's (check_step_against_one_process, the target
    too); the checkpoint restored whole on every rank; then the Consistency
    sample from it."""
    n = len(DS2_ATTENTION_BLOCKS)
    want = (4 * n, n)
    for r, got in enumerate(ranks):
        launches = [(got["k1"], got["k2"])] + [s["launches"] for s in got["bf16_steps"]]
        if any(tuple(x) != want for x in launches):
            fail(f"scale-out (d) hsdp_distill: rank {r} launched (K1, K2) {launches} a step, "
                 f"expected {want}")
        if got["wrapper"] != "FSDPCaloDiffusionNet" or not got["sharded_target"]:
            fail(f"scale-out (d) hsdp_distill: rank {r}'s student in {got['wrapper']}, teacher "
                 f"and target sharded: {got['sharded_target']}")
        if not got["restored_whole"]:
            fail(f"scale-out (d) hsdp_distill: rank {r}'s checkpoint did not restore student, "
                 "target and Adam state whole")
    # each rank's loss is its own, which the card's reductions may round
    # apart; the weights after the step are the gathered shards, the same
    first = ranks[0]
    rank_rel = max(abs(g["loss"] - first["loss"]) / abs(first["loss"]) for g in ranks)
    same = all(torch.equal(v, first[key][k]) for g in ranks[1:] for key in ("params", "ema")
               for k, v in g[key].items())
    if not (rank_rel <= STEP_LOSS_RTOL and same):
        fail(f"scale-out (d) hsdp_distill: the ranks' losses {[g['loss'] for g in ranks]} "
             f"({rank_rel:.3g} apart), their student and target the same: {same}")
    sub = check_step_against_one_process("(d) hsdp_distill 1 x 2", first, one, inp["state_dict"],
                                         card)
    bf16 = [s["loss"] for s in first["bf16_steps"]]
    bf16_one = [s["loss"] for s in one["bf16_steps"]]
    if not np.isfinite(bf16).all():
        fail(f"scale-out (d) hsdp_distill: bf16 losses {bf16}")
    print(f"scale-out (d) hsdp_distill: {DISTILL_TIMED_STEPS} bf16 steps of {BATCH} after one "
          f"untimed: {first['step_ms']:.1f} ms/step (one process {one['step_ms']:.1f}), losses "
          f"{[round(v, 5) for v in bf16]} (one process {[round(v, 5) for v in bf16_one]}); "
          f"K1 {want[0]} and K2 {want[1]} a step on each rank; "
          f"the ranks' losses {rank_rel:.3g} apart, their student and target equal; "
          f"peak memory {first['max_memory_gib']:.2f} GiB a rank (one process "
          f"{one['max_memory_gib']:.2f}); checkpoint written by rank 0 in "
          f"{first['save_s']:.2f} s with every shard gathered, restored whole on both ranks on "
          f"{card}", flush=True)
    sub.update(bf16_step_ms=first["step_ms"], bf16_step_ms_one_process=one["step_ms"],
               ranks_loss_rel=rank_rel,
               bf16_losses=bf16, bf16_losses_one_process=bf16_one,
               launches_a_step=list(want), checkpoint_save_s=first["save_s"],
               launches_by_rank=[(g["k1"], g["k2"]) for g in ranks],
               sample=sample_distilled(first["checkpoint"], inp, attn, card))
    return sub


def run_scale_out_phase(root: Path, made, cli, state_dict, seed, attn, card):
    """Phase 16: (a) one NCCL rank through training.main, then on the one
    card over gloo (NCCL refuses two ranks on one device) (b) two data
    ranks (DDP): a step against one process's and a sharded sample against
    one process's, (c) data 1 x model 2 (FSDP2): the step, and (d) on the
    same ranks consistency distillation: a step against one process's,
    timed bf16 steps, the checkpoint and a Consistency sample from it."""
    from calodiffusion_tpu_torch.ops import linear_attention

    n = len(DS2_ATTENTION_BLOCKS)
    cfg, cfg_path, data = made["ds2"]
    res = {"nccl_one_rank": run_nccl_one_rank(cfg, cfg_path, data, root, cli["ds2"]["train"],
                                              attn, card)}
    folder = root / "scale_out" / "ranks"
    folder.mkdir(parents=True)
    inp = scale_out_inputs(state_dict, seed)
    torch.save(inp, folder / "inputs.pt")
    one = scale_out_step(inp, None, linear_attention)
    one_sample = scale_out_sample(inp, None, linear_attention)
    one_distill = scale_out_distill(inp, None, linear_attention, folder / "one_distill")
    for name, model_axis in SCALE_OUT_MESHES:
        t0 = time.perf_counter()
        ranks = run_ranks_on_card(2, model_axis, folder)
        wall = time.perf_counter() - t0
        for r, got in enumerate(ranks):
            if (got["k1"], got["k2"]) != (n, n):
                fail(f"scale-out {name}: rank {r} launched K1 {got['k1']} and K2 "
                     f"{got['k2']} times in the step, expected {n} and {n}")
        sub = check_step_against_one_process(
            f"({'b' if model_axis == 1 else 'c'}) {name} {2 // model_axis} x {model_axis}",
            ranks[0], one, inp["state_dict"], card)
        sub.update(wall_s=wall, launches_by_rank=[(g["k1"], g["k2"]) for g in ranks])
        if model_axis == 1:
            x = torch.cat([g["sample"]["x"] for g in ranks])
            err = (x - one_sample["x"]).abs().max().item()
            tol = SCALE_OUT_SAMPLE_STEPS * 2e-4  # evaluations x 2e-4 (docs/DESIGN.md:32)
            launches = [(g["sample"]["k1"], g["sample"]["k2"]) for g in ranks]
            if not err <= tol or any(s != (n * SCALE_OUT_SAMPLE_STEPS, 0) for s in launches):
                fail(f"scale-out (b): the 2-rank sample differs from one process's by {err:.3g} "
                     f"(tol {tol:.3g}); launches by rank {launches}")
            walls = [g["sample"]["wall_s"] for g in ranks]
            print(f"scale-out (b): sharded f32 DDim sample of {BATCH} ({SCALE_OUT_SAMPLE_STEPS} "
                  f"steps, {BATCH // 2} rows a rank): against one process max_abs_err {err:.3g} "
                  f"(tol {tol:.3g}); {max(walls):.2f} s (one process "
                  f"{one_sample['wall_s']:.2f} s) on {card}; K1 by rank {launches}",
                  flush=True)
            sub["sample"] = dict(max_abs_err=err, tol=tol, wall_s=max(walls),
                                 wall_s_one_process=one_sample["wall_s"],
                                 launches_by_rank=launches)
        else:
            res["hsdp_distill"] = check_hsdp_distill([g["distill"] for g in ranks], one_distill,
                                                     inp, attn, card)
        res[name] = sub
    paths = {"ddp_train": res["ddp"]["launches_by_rank"][0],
             "ddp_sample": res["ddp"]["sample"]["launches_by_rank"][0],
             "hsdp_train": res["hsdp"]["launches_by_rank"][0],
             "hsdp_distill": res["hsdp_distill"]["launches_by_rank"][0]}
    return res, paths


# ---------------------------------------------------------------------------
# 17. jobs: the training job script under torchrun, preempted and requeued
# ---------------------------------------------------------------------------

JOB_PATHS = ("jobs_train",)
JOB_MAXEPOCH = 2
JOB_MAX_RESTARTS = 2
JOB_TIMEOUT_S = 300  # the whole job, both attempts
# Written into a directory first on the job's PYTHONPATH: each process of the
# job that ran the port's attention kernels writes their launch counts at its
# exit (a rank killed by a signal writes none).  Any other sitecustomize on
# the path runs first.
LAUNCH_COUNT_HOOK = '''"""Launch counts of the port's attention kernels at a process's exit."""
import atexit
import importlib.machinery
import importlib.util
import json
import os
import sys


def _chain():
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or ".") != here]
    spec = importlib.machinery.PathFinder.find_spec("sitecustomize", rest)
    if spec is not None and spec.loader is not None:
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


def _write():
    attn = sys.modules.get("calodiffusion_tpu_torch.ops.linear_attention")
    if attn is None:
        return
    out = os.environ["CALO_LAUNCH_COUNTS"]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{os.getpid()}.json"), "w") as f:
        json.dump({"k1": attn.fused_attention_block.launches,
                   "k2": attn.attention_block_backward.launches, "argv": sys.argv}, f)


_chain()
if os.environ.get("CALO_LAUNCH_COUNTS"):
    atexit.register(_write)
'''


def job_ranks(root_pid: int) -> list:
    """The processes under ``root_pid`` that torchrun started as ranks
    (``LOCAL_RANK`` in their environment), read from /proc."""
    children = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            ppid = int(Path(f"/proc/{d}/stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        children.setdefault(ppid, []).append(int(d))
    ranks, todo = [], [root_pid]
    while todo:
        for pid in children.get(todo.pop(), []):
            todo.append(pid)
            try:
                environ = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
            except OSError:
                continue
            if any(e.startswith(b"LOCAL_RANK=") for e in environ):
                ranks.append(pid)
    return ranks


def run_jobs_phase(root: Path, made, cli, seed, card):
    """Phase 17: scripts/torch_submit_training.py writes the training job
    for the cli phase's ds2 caches (the config at full width, MAXEPOCH
    JOB_MAXEPOCH, cut like the cli phase); its train.sh runs under the real
    torchrun (every card of the node: one here).  Once the first attempt's
    first epoch is checkpointed and its second begun, its rank gets SIGTERM,
    as a scheduler preempts a job; the loop's second attempt runs with
    --load, resumes at epoch 1 and ends at MAXEPOCH.  K1 and K2 launches of
    the second attempt's rank (LAUNCH_COUNT_HOOK): 7 a step and 7 the val
    batch, 7 a step."""
    import re
    import shutil
    import signal
    import threading

    n = len(DS2_ATTENTION_BLOCKS)
    cfg, _, data = made["ds2"]
    jobs = root / "jobs"
    (jobs / "hook").mkdir(parents=True)
    (jobs / "hook" / "sitecustomize.py").write_text(LAUNCH_COUNT_HOOK)
    cfg_path = jobs / "config.json"
    cfg_path.write_text(json.dumps(dict(cfg, MAXEPOCH=JOB_MAXEPOCH, CHECKPOINT_NAME="jobs_ds2")))
    counts = jobs / "counts"
    path = os.pathsep.join([str(Path(sys.executable).parent), os.environ.get("PATH", "")])
    env = dict(os.environ, PATH=path, CALO_LAUNCH_COUNTS=str(counts),
               PYTHONPATH=os.pathsep.join(p for p in (str(jobs / "hook"), str(ROOT),
                                                      os.environ.get("PYTHONPATH")) if p))
    torchrun = shutil.which("torchrun", path=path)
    if torchrun is None:
        fail(f"jobs: no torchrun on {path}")
    made_job = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "torch_submit_training.py"), "-c", str(cfg_path),
         "-n", str(jobs / "job"), "-d", data, "--checkpoint-folder", str(jobs / "ckpt"),
         "--max-restarts", str(JOB_MAX_RESTARTS), "--extra-args", f"--seed {seed}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    script = jobs / "job" / "train.sh"
    if made_job.returncode != 0 or not script.exists():
        fail(f"jobs: torch_submit_training.py: {made_job.stderr[-2000:]}")
    folder = jobs / "ckpt" / "jobs_ds2_Diffusion"
    t0 = time.perf_counter()
    proc = subprocess.Popen(["bash", str(script)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    timer = threading.Timer(JOB_TIMEOUT_S, os.killpg, (proc.pid, signal.SIGKILL))
    timer.start()
    lines, preempted, restarted = [], None, None
    started = []  # each attempt's first "Beginning epoch", in s from the job's start
    try:
        for line in iter(proc.stdout.readline, ""):
            lines.append(line)
            if "Beginning epoch" in line and len(started) < 1 + (restarted is not None):
                started.append(time.perf_counter() - t0)
            if (preempted is None and "Beginning epoch 1" in line
                    and (folder / "checkpoint.ckpt").exists()):
                pids = job_ranks(proc.pid)
                for pid in pids:
                    os.kill(pid, signal.SIGTERM)
                preempted = dict(s=time.perf_counter() - t0, ranks=len(pids))
            if restarted is None and line.startswith("restart 1/"):
                restarted = time.perf_counter() - t0
        rc = proc.wait()
    finally:
        timer.cancel()
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)  # whatever the job left behind
    wall = time.perf_counter() - t0
    log = "".join(lines)
    (jobs / "job.log").write_text(log)
    first, _, second = log.partition(f"restart 1/{JOB_MAX_RESTARTS}")
    epochs = [[int(e) for e in re.findall(r"Beginning epoch (\d+)", part)]
              for part in (first, second)]
    attempts = 1 + log.count("resuming from checkpoint")
    state = json.loads((folder / "final_state.json").read_text()) if (
        folder / "final_state.json").exists() else {}
    written = [json.loads(p.read_text()) for p in sorted(counts.glob("*.json"))]
    steps = cli["ds2"]["train"]["steps"]  # a cut epoch's train steps; one val batch
    want = (n * (steps + 1), n * steps)
    got = (written[0]["k1"], written[0]["k2"]) if len(written) == 1 else None
    if (rc != 0 or preempted is None or not preempted["ranks"] or attempts != 2
            or epochs != [[0, 1], [1]] or "training finished cleanly" not in second
            or state.get("epoch") != JOB_MAXEPOCH - 1
            or sorted(state.get("train_loss_hist", {})) != [str(e) for e in range(JOB_MAXEPOCH)]
            or got != want):
        fail(f"jobs: exit code {rc}, preempted {preempted}, {attempts} attempts, epochs by "
             f"attempt {epochs}, final state epoch {state.get('epoch')} losses "
             f"{state.get('train_loss_hist')}, launches {written} (expected {want}):\n"
             f"{log[-4000:]}")
    second_s = wall - restarted
    # from each attempt's launch to its first epoch: torchrun, the rank's
    # imports, its process group, the caches and the model
    startup = [started[0], started[1] - restarted]
    print(f"jobs: torch_submit_training.py's train.sh under {torchrun} --nproc-per-node gpu "
          f"(1 rank), ds2 full width, MAXEPOCH {JOB_MAXEPOCH}, {steps} steps of {BATCH} and a val "
          f"batch an epoch: attempt 1 ran epochs {epochs[0]} and was preempted (SIGTERM to its "
          f"rank) at {preempted['s']:.1f} s; attempt 2 (--load) resumed at epoch {epochs[1][0]} "
          f"and ended at epoch {state['epoch']} (MAXEPOCH {JOB_MAXEPOCH}) in {second_s:.1f} s; "
          f"{attempts} attempts, job wall {wall:.1f} s on {card}; from each attempt's launch to "
          f"its first epoch {startup[0]:.1f} and {startup[1]:.1f} s; attempt 2's rank launched "
          f"K1 {got[0]} and K2 {got[1]}", flush=True)
    print("jobs: the inference and plotting jobs write h5, which this machine cannot (no "
          "h5py): they run in tests/test_torch_port_jobs.py on the CPU", flush=True)
    res = dict(attempts=attempts, epochs_by_attempt=epochs, preempted_at_s=preempted["s"],
               resumed_at_epoch=epochs[1][0], final_epoch=state["epoch"], startup_s=startup,
               train_loss_hist=state["train_loss_hist"], k1=got[0], k2=got[1],
               attempt2_s=second_s, wall_s=wall)
    return res, {"jobs_train": got}


# ---------------------------------------------------------------------------
# 18. fidelity: the fidelity harnesses of scripts/, cut
# ---------------------------------------------------------------------------

# each family of scripts/torch_fidelity_families.py, the few-step harness and
# the seeds harness, in that order
FIDELITY_FAMILIES = ("hgcal", "ds1", "ds1pion", "ds3", "layer")
FIDELITY_PATHS = tuple(f"fidelity_{f}" for f in FIDELITY_FAMILIES) + ("fewstep",
                                                                       "cascade_seeds")
# the cut: MAXEPOCH (and the cascade's stage 1) 1, the train and eval events,
# DDim 400 -> 10 steps in every stage
FIDELITY_CUT = ["--events", "256", "--eval-events", "128"]
FIDELITY_EPOCHS = 1
FIDELITY_STEPS = 10
# the flags of each family beyond --int8
FIDELITY_FLAGS = {"hgcal": ["--roundtrip"], "ds1": ["--roundtrip"], "ds1pion": [], "ds3": [],
                  "layer": ["--oracle"]}
# one candidate of each sampler family, each at its own steps; one speed
FEWSTEP_CANDIDATES = ("DDim_50", "DPMPP2M_18", "Restart_36", "Heun_36_churn")
FEWSTEP_SPEED = ("DPMPP2M", 18)
FIDELITY_SEEDS = "1,2"


class UnetCalls:
    """While entered, every ``CondUnet`` forward counted with what it
    implies: one K1 launch an attention block (a heads-1 LinearAttention
    behind PreNormResidual, the fused block), one K2 an attention block
    where the call runs under autograd (its backward follows), one Q1 a
    convolution with an int8 scale set; K1's, K2's and Q1's counters reset
    on entry, so ``check`` holds them to those sums."""

    def __init__(self, attn, q1, nn_modules, classes=None):
        self.attn, self.q1, self.nn = attn, q1, nn_modules
        # the network classes whose calls count (phase 20 adds the level
        # profile's TruncatedUnet)
        self.classes = classes or (nn_modules.CondUnet,)
        self.want = dict(k1=0, k2=0, q1=0, calls=0, grad_calls=0, int8_calls=0)
        # each int8 call's set of int8-scaled conv paths, in call order
        self.int8_paths: list = []

    def __enter__(self):
        from unittest import mock

        from calodiffusion_tpu_torch.ops import quant

        nn, want = self.nn, self.want
        # by network, not by id(): a path may free a network and build
        # another at its address (phase 20's cases)
        blocks = weakref.WeakKeyDictionary()

        def int8_scaled(m):  # a weight-only conv runs float, not Q1
            return getattr(m, "int8_scale", None) not in (None, quant.WEIGHT_ONLY)

        def counting(forward):
            def counted(unet, *a, **kw):
                if unet not in blocks:
                    blocks[unet] = sum(
                        isinstance(m, nn.PreNormResidual)
                        and isinstance(m.fn.fn, nn.LinearAttention) and m.fn.fn.heads == 1
                        for m in unet.modules())
                q = sum(int8_scaled(m) for m in unet.modules())
                if q:
                    self.int8_paths.append(frozenset(
                        p for p, m in nn.quantizable_convs(unet).items() if int8_scaled(m)))
                want["calls"] += 1
                want["k1"] += blocks[unet]
                if torch.is_grad_enabled():
                    want["grad_calls"] += 1
                    want["k2"] += blocks[unet]
                want["int8_calls"] += q > 0
                want["q1"] += q
                return forward(unet, *a, **kw)
            return counted

        torch.cuda.synchronize()
        self.patches = [mock.patch.object(cls, "forward", counting(cls.forward))
                        for cls in self.classes]
        for patch in self.patches:
            patch.start()
        self.attn.fused_attention_block.launches = 0
        self.attn.attention_block_backward.launches = 0
        self.q1.int8_conv3d.launches = 0
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        for patch in self.patches:
            patch.stop()

    def check(self, path: str, int8: bool, train: bool = True) -> dict:
        """The launches against the calls' sums; K1 launched, K2 too where
        the path ``train``s, Q1 where it samples ``int8``."""
        got = dict(k1=self.attn.fused_attention_block.launches,
                   k2=self.attn.attention_block_backward.launches,
                   q1=self.q1.int8_conv3d.launches)
        w = self.want
        if (got != {k: w[k] for k in got} or not w["k1"] or bool(w["k2"]) != train
                or bool(w["int8_calls"]) != int8):
            fail(f"{path}: launches {got}; the path's network calls imply {w} (int8 "
                 f"{'expected' if int8 else 'not expected'}, K2 "
                 f"{'expected' if train else 'not expected'})")
        return dict(got, unet_calls=w["calls"], unet_grad_calls=w["grad_calls"],
                    unet_int8_calls=w["int8_calls"])


class AttentionShapes:
    """While entered, each K1 and K2 launch's shape and the plan it took:
    ``plans`` maps ("k1" or "k2", B, N, C, dtype) to ``kernel_plan``'s plan
    (``launch_forward`` and ``launch_backward`` patched)."""

    def __init__(self, attn):
        self.attn, self.plans = attn, {}

    def __enter__(self):
        from unittest import mock

        attn, plans = self.attn, self.plans

        def recorder(kind, launch, name):
            def recorded(lib, x, *a, **kw):
                key = (kind, *x.shape, dtype_name(x.dtype))
                if key not in plans:
                    plans[key] = attn.kernel_plan(lib, name, x.shape[1], x.shape[2], x.dtype)
                return launch(lib, x, *a, **kw)
            return recorded

        self.patches = [
            mock.patch.object(attn, "launch_forward",
                              recorder("k1", attn.launch_forward, attn.FORWARD_KERNEL)),
            mock.patch.object(attn, "launch_backward",
                              recorder("k2", attn.launch_backward, attn.BACKWARD_KERNEL))]
        for patch in self.patches:
            patch.start()
        return self

    def __exit__(self, *exc):
        for patch in self.patches:
            patch.stop()


class PathRecord:
    """Phase 18's and 19's paths: each driven with its launches held to its
    U-Net calls (UnetCalls), its int8 calls' conv sets kept (``int8_paths``)
    and the K1/K2 shapes and Q1 geometries it launched kept, each with its
    plan and the first path that launched it (``shapes``,
    ``q1_geometries``, for check_path_shapes)."""

    def __init__(self, attn, q1, nn_modules, classes=None):
        self.attn, self.q1, self.nn, self.classes = attn, q1, nn_modules, classes
        self.paths, self.int8_paths, self.shapes, self.q1_geometries = {}, {}, {}, {}

    def drive(self, path, int8, fn, *args, train=True):
        """``fn(*args)`` with the path's launches counted and its shapes kept."""
        with UnetCalls(self.attn, self.q1, self.nn, self.classes) as calls, \
                AttentionShapes(self.attn) as seen, Q1Launches(self.q1, self.nn) as q1_seen:
            out = fn(*args)
        self.paths[path] = calls.check(path, int8=int8, train=train)
        self.int8_paths[path] = calls.int8_paths
        for key, plan in seen.plans.items():
            self.shapes.setdefault(key, (plan, path))
        for key, plan in q1_seen.plans.items():
            self.q1_geometries.setdefault(key, (plan, q1_seen.dtypes[key], path))
        return out

    def launches(self) -> dict:
        return {p: (v["k1"], v["k2"], v["q1"]) for p, v in self.paths.items()}


def check_fidelity_keys(path, report, family, keys, sharp, failures) -> None:
    """Every separation the harness writes (``keys``, its
    ``expected_keys``) present and finite, but the sharp instruments
    (``sharp``) of a prefix whose FPD failed: one "classifier/FPD metrics
    failed" line (``failures``, a singular covariance) for each prefix that
    lacks them, and nothing else missing."""
    missing = {k for k in keys if f"{family}_{k}" not in report}
    bad = [k for k in keys if k not in missing and not math.isfinite(report[f"{family}_{k}"])]
    prefixes = {k.removesuffix("Etot") for k in keys if k.endswith("Etot")}
    lost = {p for p in prefixes if all(p + k in missing for k in sharp)}
    if bad or missing != {p + k for p in lost for k in sharp} or len(lost) != len(failures):
        fail(f"{path}: keys not finite {bad}, missing {sorted(missing)} (metric failures "
             f"printed: {failures})")


def check_path_shapes(attn, q1, shapes, q1_geometries, k1_cases, k2_cases, q1_checked,
                      label="fidelity"):
    """Phase 18's (and 19's) paths against the plain versions: K1 and K2 at every
    (B, N, C) and Q1 at every geometry that the paths launched and no
    earlier phase checked (check_attention_kernel, check_backward_kernel,
    check_q1, each in bf16 and f32); then each shape's plan on its path
    against the plan that the check took at its shape and dtype.
    ``shapes``: {AttentionShapes key: (plan, path)}; ``q1_geometries``:
    {Q1Launches key: (plan, dtype, path)}.  Returns the new cases of K1, K2
    and Q1."""
    new = {}
    for kind, cases, check in (("k1", k1_cases, check_attention_kernel),
                               ("k2", k2_cases, check_backward_kernel)):
        seen = {(*c["shape"], c["dtype"]): c for c in cases}
        todo = {}
        for k, B, N, C, dtype in shapes:
            if k == kind and (B, N, C, dtype) not in seen:
                todo.setdefault(B, set()).add((C, N))
        new[kind] = [c for B, blocks in sorted(todo.items())
                     for c in check(attn, sorted(blocks), B, label)]
        seen.update({(*c["shape"], c["dtype"]): c for c in new[kind]})
        for (k, *shape), (plan, path) in shapes.items():
            if k == kind and seen[tuple(shape)]["cluster_plan"] != plan:
                fail(f"{path}: {kind} at {shape} took the plan {plan}; its check took "
                     f"{seen[tuple(shape)]['cluster_plan']}")

    def q1_key(c):
        return (tuple(c["x"]), tuple(c["w"]), tuple(c["stride"]), tuple(c["padding"]),
                c["cylindrical"], c["kind"], c["dtype"])

    seen = {q1_key(c): c for c in q1_checked}
    todo = sorted({g for g, (_, dtype, _) in q1_geometries.items() if (*g, dtype) not in seen})
    new["q1"] = check_q1(q1, todo, plain_reps=(0, 1))
    seen.update({q1_key(c): c for c in new["q1"]})
    for g, (plan, dtype, path) in q1_geometries.items():
        if seen[(*g, dtype)]["plan"] != plan:
            fail(f"{path}: Q1 at {g} ({dtype}) took the plan {plan}; its check took "
                 f"{seen[(*g, dtype)]['plan']}")
    print(f"{label}: the paths' shapes checked against the plain versions: K1 "
          f"{sum(k == 'k1' for k, *_ in shapes)} ({len(new['k1'])} new cases), K2 "
          f"{sum(k == 'k2' for k, *_ in shapes)} ({len(new['k2'])} new), Q1 "
          f"{len(q1_geometries)} geometries ({len(new['q1'])} new cases); every plan as on "
          f"its path", flush=True)
    return new


def run_fidelity_phase(root: Path, seed, attn, q1, nn_modules, card):
    """Phase 18: each family of scripts/torch_fidelity_families.py through
    its ``main`` (bf16 and --int8; --roundtrip on ds1 and HGCal, --oracle on
    the cascade), then scripts/torch_fewstep_check.py (--int8, one candidate
    of each sampler family) with one speed, and scripts/torch_cascade_seeds.py
    (two seeds), at the cut: 1 epoch (the cascade's stage 1 too), 256 train
    and 128 eval events, DDim 400 -> 10 steps.  Each path's K1, K2 and Q1
    launches against its U-Net calls (UnetCalls), every key the harness
    writes present and finite, the gates computed.  Returns the results,
    each path's launches, and the K1/K2 shapes and Q1 geometries the paths
    launched (for check_path_shapes)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_cascade_seeds
    import torch_fewstep_check as tfs
    import torch_fidelity_families as fam

    folder = root / "fidelity"
    report_path = folder / "torch_fidelity_report.json"
    common = ["--device", "cuda", "--out", str(report_path), "--workdir", str(folder)]
    results, record = {}, PathRecord(attn, q1, nn_modules)
    drive, paths = record.drive, record.paths

    for family in FIDELITY_FAMILIES:
        path = f"fidelity_{family}"
        flags = ["--int8"] + FIDELITY_FLAGS[family]
        argv = ([str(FIDELITY_EPOCHS), family] + flags + FIDELITY_CUT + common
                + ["--sample-steps", str(FIDELITY_STEPS), "--stage1-epochs", str(FIDELITY_EPOCHS),
                   "--seed", str(seed)])
        before = len(fam.METRIC_FAILURES)
        t0 = time.perf_counter()
        report = drive(path, True, fam.main, argv)
        wall = time.perf_counter() - t0
        check_fidelity_keys(path, report, family, fam.expected_keys(family, fam.parse(argv)),
                            fam.SHARP_KEYS, fam.METRIC_FAILURES[before:])
        if not isinstance(report.get(f"{family}_ok"), bool) or not isinstance(
                report.get(f"{family}_int8_ok"), bool):
            fail(f"{path}: the gates {family}_ok / {family}_int8_ok were not computed")
        got = {k: report.get(f"{family}_{k}") for k in ("classifier_auc", "int8_classifier_auc",
                                                        "fpd", "ok", "int8_ok")}
        results[path] = dict(paths[path], wall_s=wall, **got,
                             walls={k: report[f"{family}_{k}"] for k in (
                                 "train_s", "generate_s", "int8_generate_s")})
        print(f"{path}: {family} through torch_fidelity_families.py {' '.join(flags)}, cut "
              f"({FIDELITY_EPOCHS} epoch, 256 + 128 events, {FIDELITY_STEPS}-step DDim): "
              f"{wall:.1f} s (train {report[f'{family}_train_s']:.1f}, generate "
              f"{report[f'{family}_generate_s']:.1f}, int8 "
              f"{report[f'{family}_int8_generate_s']:.1f}) on {card}; AUC {got['classifier_auc']}"
              f", int8 {got['int8_classifier_auc']}; gates {got['ok']} / {got['int8_ok']}; "
              f"launches K1 {paths[path]['k1']}, K2 {paths[path]['k2']}, Q1 {paths[path]['q1']} "
              f"over {paths[path]['unet_calls']} U-Net calls ({paths[path]['unet_grad_calls']} "
              f"under autograd, {paths[path]['unet_int8_calls']} int8)", flush=True)

    # the few-step harness: one candidate of each sampler family, bf16 and int8
    argv = ([str(FIDELITY_EPOCHS), "--int8", "--seed", str(seed), "--distill",
             str(FIDELITY_EPOCHS), "--candidates", *FEWSTEP_CANDIDATES] + FIDELITY_CUT
            + ["--device", "cuda", "--out", str(report_path), "--workdir",
               str(folder / "fewstep")])
    t0 = time.perf_counter()
    res, _ = drive("fewstep", True, tfs.main, argv)
    wall = time.perf_counter() - t0
    report = json.loads(report_path.read_text())
    tags = {}
    for mode in ("bf16", "int8"):
        tags[mode] = [t for t in (tfs.norm_cand(c)[2] for c in tfs.mode_candidates(mode))
                      if t in FEWSTEP_CANDIDATES]
        if sorted(res[mode]) != sorted(["DDim_400", *tags[mode]]):
            fail(f"fewstep: {mode} candidates {sorted(res[mode])}, expected DDim_400 and "
                 f"{tags[mode]}")
        values, verdicts = tfs.report_keys(mode, tags[mode])
        prefix = tfs.PREFIX[mode]
        bad = [k for k in values if not math.isfinite(report.get(k, float("nan")))]
        if (bad or not all(isinstance(report.get(g), bool) for g in verdicts)
                or f"{prefix}_best" not in report or f"{prefix}_best_rel" not in report):
            fail(f"fewstep: {prefix} keys not finite {bad}, verdicts "
                 f"{[report.get(g) for g in verdicts]}")
    if report.get("fewstep_int8_fenced") is not True:
        fail("fewstep: the int8 rows are not marked as measured under the fence")
    # one speed reading of each mode, whatever the candidate's gate at the cut
    speed_tag = tfs.norm_cand(FEWSTEP_SPEED)[2]
    cfg = tfs.fewstep_config(FIDELITY_EPOCHS)
    speeds = {mode: tfs.candidate_speed(cfg, FEWSTEP_SPEED, mode, "cuda")
              for mode in ("bf16", "int8")}
    if not all(math.isfinite(v) and v > 0 for v in speeds.values()):
        fail(f"fewstep: {speed_tag} showers/s {speeds}")
    results["fewstep"] = dict(paths["fewstep"], wall_s=wall, **{
        f"{mode}_{t}": {k: r["seps"].get(k) for k in ("classifier_auc", "fpd")}
        | {"ok": r["ok"], "rel_ok": r["rel_ok"], "gen_s": r["gen_s"]}
        for mode in res for t, r in res[mode].items()},
        showers_per_s={f"{m}_{speed_tag}": v for m, v in speeds.items()})
    print(f"fewstep: torch_fewstep_check.py --int8 --distill {FIDELITY_EPOCHS}, cut "
          f"({FIDELITY_EPOCHS} epoch teacher and student, 256 + 128 events), candidates {', '.join(FEWSTEP_CANDIDATES)} (int8: "
          f"{', '.join(tags['int8'])}): {wall:.1f} s on {card}; {speed_tag} "
          f"{speeds['bf16']:.1f} showers/s, int8 {speeds['int8']:.1f} (candidate_speed: batch "
          f"128, best of 3, random weights); launches K1 {paths['fewstep']['k1']}, K2 "
          f"{paths['fewstep']['k2']}, Q1 {paths['fewstep']['q1']} over "
          f"{paths['fewstep']['unet_calls']} U-Net calls", flush=True)

    # the cascade over two seeds
    argv = ["--seeds", FIDELITY_SEEDS, "--epochs", str(FIDELITY_EPOCHS), "--stage1-epochs",
            str(FIDELITY_EPOCHS), "--sample-steps", str(FIDELITY_STEPS), *FIDELITY_CUT,
            "--device", "cuda", "--out", str(report_path), "--workdir", str(folder / "seeds")]
    t0 = time.perf_counter()
    agg = drive("cascade_seeds", False, torch_cascade_seeds.main, argv)
    wall = time.perf_counter() - t0
    rows = json.loads((folder / "torch_cascade_seeds.json").read_text())
    n = len(FIDELITY_SEEDS.split(","))
    if (sorted(rows) != [f"seed{s}" for s in FIDELITY_SEEDS.split(",")]
            or agg["layer_seed_n"] != n or not isinstance(agg["layer_seeds_ok"], bool)
            or not all(math.isfinite(agg[k]) for k in agg if k.startswith("layer_seed_"))):
        fail(f"cascade_seeds: rows {sorted(rows)}, aggregate {agg}")
    results["cascade_seeds"] = dict(paths["cascade_seeds"], wall_s=wall, **agg)
    print(f"cascade_seeds: torch_cascade_seeds.py --seeds {FIDELITY_SEEDS}, cut: {wall:.1f} s on "
          f"{card}; AUC {agg['layer_seed_auc_mean']} ± {agg['layer_seed_auc_ci95']}, FPD "
          f"{agg['layer_seed_fpd_mean']} ± {agg['layer_seed_fpd_ci95']}; launches K1 "
          f"{paths['cascade_seeds']['k1']}, K2 {paths['cascade_seeds']['k2']}", flush=True)
    return results, record.launches(), record.shapes, record.q1_geometries


SCRIPT_PATHS = ("train_smoke", "fence_regate", "cascade_ablation", "distill_extend",
                "distill_variant")
# the cut: the train smoke at 256 showers a file, 2 epochs (too few steps for
# its loss check), DDim 400 -> FIDELITY_STEPS in every script; the others on
# phase 18's few-step and cascade workdirs
SMOKE_CUT = ["--events", "256", "--epochs", "2", "--no-loss-check"]
SMOKE_KEYS = {"train_s", "epochs", "steps_per_epoch", "batch", "epoch_losses", "loss_ratio",
              "loss_ok", "showers", "sample_steps", "generate_s", "showers_per_s",
              "mean_generated_E", "showers_ok", "card"}
# the separations of compute_seps without matplotlib (as on this machine); the
# sharp ones go missing only with a "classifier/FPD metrics failed" line
SEPS_KEYS = {"Etot", "ERatio", "layer_profile_L1", "sparsity"}
SHARP_SEPS = {"classifier_auc", "classifier_jsd", "fpd", "fpd_err"}
DISTILL_STEPS = "1,2,4"


def check_rows(path, report, tags, keys, sharp=SHARP_SEPS) -> None:
    """``report``'s rows exactly ``tags`` in order, each with the separations
    ``keys`` (and ``sharp`` where they were computed; a row's "source" text
    aside), every number finite."""
    if list(report) != list(tags):
        fail(f"{path}: rows {list(report)}, expected {list(tags)}")
    for tag, row in report.items():
        have = set(row) - {"source"}
        if not keys <= have <= keys | sharp:
            fail(f"{path}: row {tag} keys {sorted(row)}; expected {sorted(keys)} (+ "
                 f"{sorted(sharp)})")
        bad = [k for k in have if not math.isfinite(row[k])]
        if bad:
            fail(f"{path}: row {tag} not finite: {bad}")


def run_scripts_phase(root: Path, attn, q1, nn_modules, card):
    """Phase 19: the last five JAX scripts' counterparts (scripts/), cut:
    torch_train_smoke.py (its own data and the full-size U-Net), then on
    phase 18's few-step workdir torch_int8_fence_regate.py,
    torch_distill_extend.py (the 1-epoch student to 2, Consistency@1,2,4) and
    torch_distill_variant.py (1 epoch), and on its cascade workdir
    torch_int8_cascade_ablation.py (every coarse group), DDim 400 ->
    FIDELITY_STEPS.  Each report's keys as the JAX script writes them, every
    number finite; each path's K1, K2 and Q1 launches against its U-Net calls
    (UnetCalls), no int8 conv of the fence on the fence's calls, and each
    ablation row's int8 convs its table's alone (an excluded group launching
    no Q1).  Returns the results, each path's launches, and the K1/K2
    shapes and Q1 geometries the paths launched."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_distill_extend as tde
    import torch_distill_variant as tdv
    import torch_int8_cascade_ablation as tca
    import torch_int8_fence_regate as tfr
    import torch_train_smoke as tsm
    from torch_fidelity_check import int8_fence

    from calodiffusion_tpu_torch.ops import quant

    folder, fid = root / "scripts", root / "fidelity"
    few, layer = fid / "fewstep", fid / "layer"
    common = ["--device", "cuda"]
    results, record = {}, PathRecord(attn, q1, nn_modules)
    int8_paths = record.int8_paths

    def drive(path, int8, train, fn, argv):
        t0 = time.perf_counter()
        out = record.drive(path, int8, fn, argv, train=train)
        got = record.paths[path]
        results[path] = dict(got, wall_s=time.perf_counter() - t0)
        print(f"{path}: {results[path]['wall_s']:.1f} s on {card}; launches K1 {got['k1']}, K2 "
              f"{got['k2']}, Q1 {got['q1']} over {got['unet_calls']} U-Net calls "
              f"({got['unet_grad_calls']} under autograd, {got['unet_int8_calls']} int8)",
              flush=True)
        return out

    steps = ["--sample-steps", str(FIDELITY_STEPS)]
    smoke = drive("train_smoke", False, True, tsm.main,
                  SMOKE_CUT + steps + common + ["--workdir", str(folder / "smoke")])
    if set(smoke) != SMOKE_KEYS or not smoke["showers_ok"] or not all(
            math.isfinite(v) for v in [*smoke["epoch_losses"], smoke["train_s"],
                                       smoke["generate_s"], smoke["mean_generated_E"]]):
        fail(f"train_smoke: report {smoke}")
    results["train_smoke"].update(
        epoch_losses=smoke["epoch_losses"], showers_per_s=smoke["showers_per_s"],
        train_s=smoke["train_s"], generate_s=smoke["generate_s"])

    # the fence: no conv it names runs int8 on any call
    fence = drive("fence_regate", True, False, tfr.main,
                  ["--workdir", str(few)] + steps + common)
    check_rows("fence_regate", fence, ["int8_fenced"], SEPS_KEYS)
    teacher_cfg = tfr.teacher(str(few))[1]
    fenced = [p for p in set().union(*int8_paths["fence_regate"])
              if any(quant.path_matches(p, e) for e in int8_fence(teacher_cfg))]
    if fenced:
        fail(f"fence_regate: fenced convs ran int8: {sorted(fenced)}")
    results["fence_regate"].update(fence["int8_fenced"])

    # the ablation: every row's int8 calls run its table's convs and no others
    tables = []
    real = tca.ablation_rows

    def recorded_rows(full_table, groups):
        rows = real(full_table, groups)
        tables.append((rows, groups))
        return rows

    tca.ablation_rows = recorded_rows
    try:
        ablation = drive("cascade_ablation", True, False, tca.main,
                         ["--workdir", str(layer)] + steps + common)
    finally:
        tca.ablation_rows = real
    rows, groups = tables[0]
    check_rows("cascade_ablation", ablation, list(rows), {"Etot", "ERatio", "layer_profile_L1"})
    want = [frozenset(p for p, v in t.items() if v != quant.WEIGHT_ONLY)
            for t in rows.values() if t and any(v != quant.WEIGHT_ONLY for v in t.values())]
    seen_sets = int8_paths["cascade_ablation"]
    per_row = len(seen_sets) // max(len(want), 1)
    if not want or per_row * len(want) != len(seen_sets) or any(
            set(seen_sets[i * per_row:(i + 1) * per_row]) != {w} for i, w in enumerate(want)):
        fail(f"cascade_ablation: the int8 calls' conv sets do not follow the rows' tables "
             f"({len(seen_sets)} int8 calls, {len(want)} int8 rows)")
    results["cascade_ablation"].update(
        groups={g: len(v) for g, v in groups.items()},
        rows={t: {k: r.get(k) for k in ("classifier_auc", "fpd")} for t, r in ablation.items()})

    out = folder / "distill_scaling.json"
    extend = drive("distill_extend", False, True, tde.main,
                   ["--workdir", str(few), "--to-epochs", str(FIDELITY_EPOCHS + 1), "--steps",
                    DISTILL_STEPS, "--out", str(out)] + common)
    ext_tags = [f"epochs{FIDELITY_EPOCHS + 1}_Consistency_{n}" for n in DISTILL_STEPS.split(",")]
    check_rows("distill_extend", extend, ext_tags, SEPS_KEYS)
    variant = drive("distill_variant", False, True, tdv.main,
                    ["--workdir", str(few), "--epochs", str(FIDELITY_EPOCHS), "--out", str(out)]
                    + common)
    tag = tdv.variant_config(teacher_cfg, FIDELITY_EPOCHS, 18, 0.999)[0]
    check_rows("distill_variant", variant,
               ext_tags + [f"{tag}_Consistency_{n}" for n in tdv.CONSISTENCY_STEPS], SEPS_KEYS)
    if not all(variant[f"{tag}_Consistency_{n}"].get("source") for n in tdv.CONSISTENCY_STEPS):
        fail("distill_variant: rows without their source")
    for path, report in (("distill_extend", extend), ("distill_variant", variant)):
        results[path].update(rows={t: {k: r.get(k) for k in ("classifier_auc", "fpd")}
                                   for t, r in report.items()})
    return results, record.launches(), record.shapes, record.q1_geometries


PROBE_PATHS = ("level_profile", "roofline_ds2", "roofline_ds3")
# the cut: the JAX defaults K 60 -> 5 (level profile, L0 ablation), 200 -> 5
# (im2col) and 30 -> 3 (roofline convs), DDim 400 -> 10 steps (roofline
# models); full width, batch 128
PROBE_ITERS = {"level_profile": 5, "l0_ablation": 5, "im2col": 5, "roofline": 3}
PROBE_STEPS = 10
# the fused attention blocks (K1 launches a call) of each case
LEVEL_PROFILE_BLOCKS = {"full": 7, "no_attn": 0, "l01_only": 4, "l0_only": 2,
                        "l0_only_no_attn": 0}
ROOFLINE_BLOCKS = {"full": 7, "no_block_attn": 1, "no_attn": 0}
# what the JAX scripts print or write, under the port's report keys
# (ds3_roofline's TPU fields padded_ideal_frac_pct and pct_of_padded_ideal
# dropped, the card's bound in their place)
IM2COL_KEYS = ("rel_err", "native_ms", "native_tflops", "im2col_ms", "im2col_tflops", "speedup")
CONV_CASE_KEYS = ("batch", "cin", "cout", "time_per_conv_ms", "achieved_tflops",
                  "useful_mfu_pct", "bound_ms", "pct_of_bound", "graph_ms", "eager_ms")
MODEL_KEYS = ("showers_per_sec", "flops_per_run", "achieved_tflops", "useful_mfu_pct",
              "graph_showers_per_sec", "graph_ms", "eager_ms")


def finite_keys(path, row, keys) -> None:
    """Every key of ``keys`` in ``row``, a finite number."""
    bad = [k for k in keys if not isinstance(row.get(k), (int, float))
           or not math.isfinite(row[k])]
    if bad:
        fail(f"{path}: keys missing or not finite: {bad} in {row}")


def check_timed_cases(path, report, blocks, card) -> None:
    """Each case of a level-profile-like report: graph_ms and eager_ms
    finite and printed, K1 launched k1_blocks times each Python call
    (warm-up, eager runs, capture; a replay launches nothing from Python),
    k1_blocks as the case implies (``blocks``)."""
    for key, case in report["cases"].items():
        finite_keys(f"{path}/{key}", case, ("graph_ms", "eager_ms", "host_ms"))
        if case["k1_blocks"] != blocks[key] or (
                case["k1_launches"] != case["k1_blocks"] * case["calls"]):
            fail(f"{path}/{key}: {case['k1_blocks']} attention blocks (expected {blocks[key]}),"
                 f" K1 launched {case['k1_launches']} times over {case['calls']} calls")
        print(f"{path}/{key}: graph {case['graph_ms']:.3f} ms, eager {case['eager_ms']:.3f} ms "
              f"a denoise (host {case['host_ms']:.3f}); graph vs eager after "
              f"{report['iters']} iterations {case['graph_vs_eager_max_abs_err']:.3g}; K1 "
              f"{case['k1_launches']} over {case['calls']} calls on {card}", flush=True)


def run_probes_phase(root: Path, attn, q1, nn_modules, card):
    """Phase 20: the four TPU probe scripts' counterparts (scripts/), cut
    (PROBE_ITERS, PROBE_STEPS) at full width and batch 128, through their
    ``main``: torch_level_profile.py, torch_l0_elementwise_ablation.py,
    torch_im2col_microbench.py, torch_ds3_roofline.py --which ds2 and
    --which ds3.  Every key the JAX script prints or writes present and
    finite, graph_ms and eager_ms printed for each case; the full U-Net's
    graphed output after K iterations within K1's bf16 tolerance of its
    eager output; im2col's rel_err at most 1e-5; K1 launched as each
    case's attention blocks and Python calls imply (a replay launches
    nothing from Python) and as the paths' U-Net calls imply (UnetCalls,
    the level profile's TruncatedUnet counted too), none on the ablation
    and the im2col paths.  Returns the results, the three K1 paths'
    launches and the K1 shapes they launched (for check_path_shapes)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_ds3_roofline as trl
    import torch_im2col_microbench as tim
    import torch_l0_elementwise_ablation as tl0
    import torch_level_profile as tlp

    folder = root / "probes"
    results = {}
    record = PathRecord(attn, q1, nn_modules, classes=(nn_modules.CondUnet, tlp.TruncatedUnet))

    def drive(path, k1, fn, argv):
        t0 = time.perf_counter()
        if k1:
            report = record.drive(path, False, fn, argv, train=False)
        else:
            torch.cuda.synchronize()
            attn.fused_attention_block.launches = 0
            report = fn(argv)
            torch.cuda.synchronize()
            if attn.fused_attention_block.launches:
                fail(f"{path}: K1 launched {attn.fused_attention_block.launches} times; its "
                     "cases hold no attention")
        wall = time.perf_counter() - t0
        results[path] = dict(record.paths.get(path, {}), wall_s=wall)
        print(f"{path}: {wall:.1f} s on {card}; K1 launches "
              f"{record.paths[path]['k1'] if k1 else 0}", flush=True)
        return report

    def argv(name, *extra):
        return ["--device", "cuda", "--out", str(folder / f"{name}.json"), *extra]

    lp = drive("level_profile", True, tlp.main,
               argv("level_profile", "--iters", str(PROBE_ITERS["level_profile"])))
    check_timed_cases("level_profile", lp, LEVEL_PROFILE_BLOCKS, card)
    finite_keys("level_profile", lp, [f"{k}_ms" for k, *_ in tlp.DERIVED]
                + [f"{k}_eager_ms" for k, *_ in tlp.DERIVED])
    full = lp["cases"]["full"]
    if full["graph_vs_eager_ok"] is not True:
        fail(f"level_profile: the full U-Net's graphed output differs from its eager output by "
             f"{full['graph_vs_eager_max_abs_err']}, past K1's bf16 tolerance")
    results["level_profile"].update(
        {k: {f: c[f] for f in ("graph_ms", "eager_ms", "host_ms", "graph_vs_eager_max_abs_err")}
         for k, c in lp["cases"].items()},
        **{f"{k}_ms": lp[f"{k}_ms"] for k, *_ in tlp.DERIVED})

    l0 = drive("l0_ablation", False, tl0.main,
               argv("l0_ablation", "--iters", str(PROBE_ITERS["l0_ablation"])))
    check_timed_cases("l0_ablation", l0, {k: 0 for k, *_ in tl0.CASES}, card)
    finite_keys("l0_ablation", l0, [f"{k}_ms" for k, *_ in tl0.DERIVED])
    if tl0.M.F is not F:
        fail("l0_ablation: models/nn_modules.F was not restored")
    results["l0_ablation"].update(
        {k: {f: c[f] for f in ("graph_ms", "eager_ms")} for k, c in l0["cases"].items()},
        **{f"{k}_ms": l0[f"{k}_ms"] for k, *_ in tl0.DERIVED})

    im = drive("im2col", False, tim.main, argv("im2col", "--iters", str(PROBE_ITERS["im2col"])))
    for row in im["cases"]:
        finite_keys(f"im2col/{row['name']}", row, IM2COL_KEYS)
        for form in ("native", "im2col"):
            finite_keys(f"im2col/{row['name']}/{form}", row[form], ("graph_ms", "eager_ms"))
        if not row["rel_err"] <= tim.REL_ERR_MAX:
            fail(f"im2col/{row['name']}: rel_err {row['rel_err']} > {tim.REL_ERR_MAX}")
    results["im2col"].update(cases={r["name"]: {k: r[k] for k in IM2COL_KEYS}
                                    for r in im["cases"]})

    for ds in ("ds2", "ds3"):
        path = f"roofline_{ds}"
        rep = drive(path, True, trl.main,
                    argv(path, "--which", ds, "--iters", str(PROBE_ITERS["roofline"]),
                         "--steps", str(PROBE_STEPS)))
        if len(rep["conv_cases"]) != 2 * len(trl.CONV_CASES[ds]):
            fail(f"{path}: {len(rep['conv_cases'])} conv cases")
        for c in rep["conv_cases"]:
            finite_keys(f"{path}/conv {c['spatial']} {c['cin']}->{c['cout']} {c['layout']}", c,
                        CONV_CASE_KEYS)
            print(f"{path}: conv {tuple(c['spatial'])} {c['cin']}->{c['cout']} {c['layout']}: "
                  f"graph {c['graph_ms']:.4f} ms, eager {c['eager_ms']:.4f} ms a pair; "
                  f"{c['pct_of_bound']:.1f} % of the bound", flush=True)
        for tag, row in rep[ds].items():
            finite_keys(f"{path}/{tag}", row, MODEL_KEYS)
            if row["k1_blocks"] != ROOFLINE_BLOCKS[tag]:
                fail(f"{path}/{tag}: {row['k1_blocks']} attention blocks, expected "
                     f"{ROOFLINE_BLOCKS[tag]}")
            print(f"{path}/{tag}: {row['showers_per_sec']:.2f} showers/s eager, "
                  f"{row['graph_showers_per_sec']:.2f} graphed ({PROBE_STEPS}-step DDim); "
                  f"graph {row['graph_ms']:.3f} ms, eager {row['eager_ms']:.3f} ms a step; "
                  f"MFU {row['useful_mfu_pct']:.2f} %", flush=True)
        results[path].update(
            conv_cases=[{k: c[k] for k in ("spatial", "cin", "cout", "layout", "graph_ms",
                                           "eager_ms", "pct_of_bound")}
                        for c in rep["conv_cases"]],
            **{tag: {k: row[k] for k in MODEL_KEYS} for tag, row in rep[ds].items()})
    return results, record.launches(), record.shapes


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--train-steps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    # phase 16 starts its ranks as processes of this script
    ap.add_argument("--scale-out-rank", nargs=5, metavar=("RANK", "WORLD", "MODEL", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device")
    if args.scale_out_rank:
        rank, world, model_axis, port, folder = args.scale_out_rank
        return scale_out_rank(int(rank), int(world), int(model_axis), int(port), folder)
    t_start = time.perf_counter()
    try:
        from calodiffusion_tpu_torch.models import nn_modules
        from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
        from calodiffusion_tpu_torch.ops import attention as att
        from calodiffusion_tpu_torch.ops import cuda_build
        from calodiffusion_tpu_torch.ops import groupnorm as gn
        from calodiffusion_tpu_torch.ops import int8_conv as q1
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
    builds = (attn.BUILDS + att.KERNEL.builds + att.BACKWARD_KERNEL.builds + gn.KERNEL.builds
              + q1.KERNEL.builds)
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
    q1_lib = cuda_build.library_path(*q1.KERNEL.builds[0])  # bf16
    igmma = cuda_build.sass_count(q1_lib, "IGMMA")
    print(f"build: {q1_lib.name}: {igmma} IGMMA (s8 wgmma) instructions", flush=True)
    if igmma == 0:
        fail("Q1's bf16 library holds no s8 wgmma (IGMMA) instruction")

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
    print_per_call(k1_cases, k2_cases)

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
    bf16_sps = n / wall
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

    # 14. int8, from phase 4's weights and the cascade phase's checkpoints
    t0 = time.perf_counter()
    int8, q1_cases, q1_calls, q1_family_cases = run_int8_phase(
        model, loader, args, cascade["checkpoint"], made, cli, root, q1, attn, nn_modules, card,
        bf16_sps, hgcal["hgcal_photons"]["checkpoint"])
    print(f"int8: {time.perf_counter() - t0:.1f} s", flush=True)

    # 15. networks, from phase 4's weights
    t0 = time.perf_counter()
    networks, network_paths, q1_net_cases = run_networks_phase(
        cfg, model.state_dict(), args, attn, q1, nn_modules, card)
    print(f"networks: {time.perf_counter() - t0:.1f} s", flush=True)

    # 16. scale-out, on the cli phase's ds2 caches and phase 4's weights
    t0 = time.perf_counter()
    scale_out, scale_out_paths = run_scale_out_phase(
        root, made, cli, {k: v.cpu() for k, v in model.state_dict().items()}, args.seed + 90,
        attn, card)
    print(f"scale-out: {time.perf_counter() - t0:.1f} s", flush=True)

    # 17. jobs, on the cli phase's ds2 caches
    t0 = time.perf_counter()
    jobs, job_paths = run_jobs_phase(root, made, cli, args.seed + 100, card)
    print(f"jobs: {time.perf_counter() - t0:.1f} s", flush=True)

    # 18. fidelity: the fidelity harnesses, cut, in the cli phase's directory;
    # then every K1/K2 shape and Q1 geometry their paths launched that no
    # earlier phase checked, against the plain versions
    t0 = time.perf_counter()
    fidelity, fidelity_paths, fid_shapes, fid_q1 = run_fidelity_phase(
        root, args.seed + 110, attn, q1, nn_modules, card)
    fid_cases = check_path_shapes(attn, q1, fid_shapes, fid_q1, k1_cases, k2_cases,
                                  q1_cases + q1_net_cases + sum(q1_family_cases.values(), []))
    k1_cases += fid_cases["k1"]
    k2_cases += fid_cases["k2"]
    print(f"fidelity: {time.perf_counter() - t0:.1f} s", flush=True)

    # 19. scripts: the last five JAX scripts' counterparts, cut, on phase 18's
    # workdirs; then the shapes and geometries no earlier phase checked
    t0 = time.perf_counter()
    scripts, script_paths, scr_shapes, scr_q1 = run_scripts_phase(root, attn, q1, nn_modules,
                                                                  card)
    scr_cases = check_path_shapes(
        attn, q1, scr_shapes, scr_q1, k1_cases, k2_cases,
        q1_cases + q1_net_cases + sum(q1_family_cases.values(), []) + fid_cases["q1"],
        label="scripts")
    k1_cases += scr_cases["k1"]
    k2_cases += scr_cases["k2"]
    print(f"scripts: {time.perf_counter() - t0:.1f} s", flush=True)

    # 20. probes: the four TPU probe scripts' counterparts, cut; then any K1
    # shape no earlier phase checked
    t0 = time.perf_counter()
    probes, probe_paths, probe_shapes = run_probes_phase(root, attn, q1, nn_modules, card)
    probe_cases = check_path_shapes(attn, q1, probe_shapes, {}, k1_cases, k2_cases, [],
                                    label="probes")
    k1_cases += probe_cases["k1"]
    print(f"probes: {time.perf_counter() - t0:.1f} s", flush=True)
    tmp.cleanup()

    # 21. result
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
            "int8_generate": int8["generate"][key],
            "int8_cascade_sample": int8["cascade"][key],
            "int8_transpose": int8["generate"]["transpose"][key],
        })
        by_path.update({p: int8["families"][p][key] for p in INT8_FAMILY_PATHS})
        by_path.update({p: network_paths[p][0 if key == "k1" else 1] for p in NETWORK_PATHS})
        # rank 0's launches on the scale-out paths (phase 16)
        by_path.update({p: scale_out_paths[p][0 if key == "k1" else 1]
                        for p in SCALE_OUT_PATHS})
        # the requeued attempt's rank in phase 17
        by_path.update({p: job_paths[p][0 if key == "k1" else 1] for p in JOB_PATHS})
        # the fidelity harnesses' paths (phase 18)
        by_path.update({p: fidelity_paths[p][0 if key == "k1" else 1] for p in FIDELITY_PATHS})
        # the last five scripts' paths (phase 19)
        by_path.update({p: script_paths[p][0 if key == "k1" else 1] for p in SCRIPT_PATHS})
        # the probes' paths (phase 20)
        by_path.update({p: probe_paths[p][0 if key == "k1" else 1] for p in PROBE_PATHS})
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            # launches on the last nine slices' paths: CNNCompare's sampling,
            # the optimize trial's training and sampling, the int8 paths (ds2's
            # and the other families'), the network variants', the scale-out
            # paths (distillation on the model axis among them), the job's,
            # the fidelity harnesses', the last five scripts', the probes'
            launches=sum(by_path[k] for k in EVALUATE_PATHS + INT8_PATHS + INT8_FAMILY_PATHS
                         + NETWORK_PATHS + SCALE_OUT_PATHS + JOB_PATHS + FIDELITY_PATHS
                         + SCRIPT_PATHS + PROBE_PATHS),
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
    # Q1: the times of the 36 launches of one ds2 int8 denoise, B = 128, bf16
    q1_bf16 = [c for c in q1_cases if c["dtype"] == "bfloat16"]
    main_calls = [c for c in q1_calls if c[5] == "conv"]
    q1_paths = {"int8_generate": int8["generate"]["q1"],
                "int8_cascade_sample": int8["cascade"]["q1"],
                "int8_transpose": int8["generate"]["transpose"]["q1"],
                "convnext_int8": networks["convnext"]["int8"]["q1"],
                **{p: int8["families"][p]["q1"] for p in INT8_FAMILY_PATHS},
                **{p: fidelity_paths[p][2] for p in FIDELITY_PATHS},
                **{p: script_paths[p][2] for p in SCRIPT_PATHS}}
    kernels.append(dict(
        name="int8_conv3d", route="cuda", source=SOURCES["int8_conv3d"],
        replaces=REPLACES["int8_conv3d"], launches=sum(q1_paths.values()),
        launches_by_path=q1_paths,
        max_abs_err=max(c["max_abs_err"] for c in q1_bf16 + q1_net_cases + fid_cases["q1"]
                        + scr_cases["q1"] + sum(q1_family_cases.values(), [])),
        **{name: per_denoise(q1_cases, main_calls, key) for name, key in (
            ("ms", "kernel_ms"), ("plain_ms", "plain_ms"), ("device_ms", "device_ms"),
            ("bound_ms", "bound_ms"), ("library_ms", "library_ms"))},
        bound_by="bytes" if all(c["bound_by"] == "bytes" for c in q1_bf16) else "operations",
        # cuDNN's conv3d in the activation dtype at the same shapes: the float
        # convolution Q1 stands in for, not the same function
        library="torch.nn.functional.conv3d (cuDNN, bf16)",
        launches_per_call=INT8_CONVS, igmma_instructions=igmma, cases=q1_cases,
        # and at the ConvNext U-Net's geometries (phase 15), with their plans
        convnext_cases=q1_net_cases, convnext_plans=networks["convnext"]["q1_plans"],
        # and on phase 14's dataset-3, HGCal-photons and dataset-1-photons
        # paths: the launches by plan, one bf16 denoise's times (Q1 at each
        # launch's geometry, B as generated) and every geometry's cases
        launches_by_plan={p: int8["families"][p]["q1_by_plan"] for p in INT8_FAMILY_PATHS},
        families={p: dict(int8["families"][p]["per_denoise"],
                          launches_per_call=int8["families"][p]["scales"],
                          cases=q1_family_cases[p])
                  for p in INT8_FAMILIES},
        # and at phase 18's and 19's geometries that no earlier phase checked
        fidelity_cases=fid_cases["q1"], scripts_cases=scr_cases["q1"],
    ))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"train": {k: v for k, v in train.items() if k != "steps"},
                      "train_step_losses": [s["loss"] for s in train["steps"]],
                      "train_step_s": [s["s"] for s in train["steps"]],
                      "card_vs_cpu_step": step_check, "cli": cli, "variants": var_results,
                      "samplers": zoo, "samplers_card_vs_cpu": zoo_cpu, "bns": bns,
                      "cascade": cascade, "distill": distill, "ds1": ds1, "hgcal": hgcal,
                      "evaluate": evaluation, "int8": int8, "networks": networks,
                      "scale_out": scale_out, "jobs": jobs, "fidelity": fidelity,
                      "scripts": scripts, "probes": probes, "card": card}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
