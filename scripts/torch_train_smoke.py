#!/usr/bin/env python3
"""End-to-end training smoke of calodiffusion_tpu_torch on one CUDA card:
synthetic dataset-2 showers, the full-size U-Net, a few epochs; the loss
falls and sampling gives physical showers.

    python3 scripts/torch_train_smoke.py [--events N] [--epochs N]
        [--sample-steps N] [--no-loss-check] [--workdir PATH] [--out FILE]
        [--device cpu]

The port's counterpart of ``scripts/tpu_train_smoke.py``, with its data (two
files of 2048 showers drawn from ``default_rng(0)``: deposits decaying in Z
and R, half the voxels zero; bit for bit), its network ([32, 32, 64, 32],
cond 128, block and mid attention, bf16, batch 128, 8 epochs) and its
checks: the last epoch's loss below 0.9 x the first's, and the eval file's
showers, generated with 400-step DDim, finite and >= 0.  The data are npz
caches as ``chip_smoke.write_cache`` writes them (the card's machine has no
h5py), the sampling noise comes from a seeded ``torch.Generator``, and what
the JAX script prints goes into the report ``--out`` (default
``<workdir>/train_smoke.json``): the train wall, the epochs and steps, each
epoch's loss, the showers generated, their wall and showers/s, the mean
generated energy, the card.  The report is written before the checks, which
then raise.

``--events``, ``--epochs`` and ``--sample-steps`` cut a run (``chip_smoke.py``
phase 19); ``--no-loss-check`` drops the loss check where a cut takes too
few steps for it.  The script runs on the card unless ``--device cpu`` is
given, and refuses where there is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402

N_EVENTS, EPOCHS, SAMPLE_STEPS = 2048, 8, 400
FILES = ("dataset_2_1.hdf5", "dataset_2_2.hdf5")
LOSS_DROP = 0.9  # the last epoch's loss under this x the first's


def smoke_showers(n, rng):
    """(n, 6480) raw showers and (n, 1) incident energies of the JAX
    script's law: a Gaussian longitudinal and exponential radial profile
    times exponential fluctuations, x 1000, half the voxels zero."""
    z = np.arange(45)[None, :, None, None]
    r = np.arange(9)[None, None, None, :]
    base = np.exp(-0.5 * ((z - 12) / 8.0) ** 2) * np.exp(-r / 2.0)
    showers = (base * rng.exponential(1.0, (n, 45, 16, 9))).astype(np.float32) * 1000
    showers[rng.uniform(size=showers.shape) < 0.5] = 0
    energies = rng.uniform(1e3, 1e6, (n, 1)).astype(np.float32)
    return showers.reshape(n, -1), energies


def smoke_files(n):
    rng = np.random.default_rng(0)
    return {fname: smoke_showers(n, rng) for fname in FILES}


def smoke_config(epochs) -> dict:
    return fam.tiny_ds2_config(
        VAL_FILES=["dataset_2_2.hdf5"], EVAL=["dataset_2_2.hdf5"],
        BATCH=128, MAXEPOCH=epochs, NSTEPS=400,
        LAYER_SIZE_UNET=[32, 32, 64, 32], COND_SIZE_UNET=128,
        BLOCK_ATTN=True, MID_ATTN=True, PRECISION="bf16",
        CHECKPOINT_NAME="train_smoke",
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--events", type=int, default=N_EVENTS, help="showers a file")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--sample-steps", type=int, default=SAMPLE_STEPS)
    ap.add_argument("--no-loss-check", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    fam.check_device(opts.device)
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags
    from chip_smoke import write_cache

    dev = opts.device
    card = fam.card_line(dev)
    print(card, flush=True)
    tmp = os.path.abspath(opts.workdir) if opts.workdir else tempfile.mkdtemp(prefix="smoke_")
    os.makedirs(tmp, exist_ok=True)
    cfg = smoke_config(opts.epochs)
    for fname, (showers, energies) in smoke_files(opts.events).items():
        write_cache(os.path.join(tmp, f"{fname}.npz"), showers, energies, cfg)

    trainer = TrainDiffusion(default_flags(data_folder=tmp + "/",
                                           checkpoint_folder=os.path.join(tmp, "ckpt")),
                             cfg, device=dev)
    t0 = time.perf_counter()
    model = trainer.train()
    fam.sync(dev)
    train_s = time.perf_counter() - t0
    with open(os.path.join(trainer.checkpoint_folder, "final_training_losses.txt")) as f:
        losses = [float(x) for x in f.read().split()]
    steps = -(-opts.events // cfg["BATCH"])
    print(f"train time: {train_s:.1f}s for {len(losses)} epochs ({steps} steps/epoch, batch "
          f"{cfg['BATCH']}) on {card}", flush=True)
    print("epoch losses:", " ".join(f"{v:.4f}" for v in losses), flush=True)

    eval_loader, _ = load_data(default_flags(data_folder=tmp + "/"), cfg, eval=True, device=dev)
    t0 = time.perf_counter()
    gen, _ = model.generate(eval_loader, opts.sample_steps,
                            generator=torch.Generator(device=dev).manual_seed(0))
    fam.sync(dev)
    generate_s = time.perf_counter() - t0
    print(f"sampled {gen.shape[0]} showers @{opts.sample_steps} steps in {generate_s:.1f}s "
          f"({gen.shape[0] / generate_s:.2f} showers/s)", flush=True)
    showers_ok = bool(np.all(np.isfinite(gen)) and np.all(gen >= 0))
    loss_ok = bool(losses[-1] < losses[0] * LOSS_DROP)
    report = dict(
        train_s=train_s, epochs=len(losses), steps_per_epoch=steps, batch=cfg["BATCH"],
        epoch_losses=losses, loss_ratio=losses[-1] / losses[0], loss_ok=loss_ok,
        showers=int(gen.shape[0]), sample_steps=opts.sample_steps, generate_s=generate_s,
        showers_per_s=gen.shape[0] / generate_s, mean_generated_E=float(gen.sum(-1).mean()),
        showers_ok=showers_ok, card=card)
    out = Path(opts.out or os.path.join(tmp, "train_smoke.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"mean generated E: {report['mean_generated_E']}; wrote {out}", flush=True)
    if not opts.no_loss_check:
        assert loss_ok, f"loss did not decrease: {losses[0]:.4f} -> {losses[-1]:.4f}"
    assert showers_ok, "generated showers not finite and >= 0"
    print("TRAIN SMOKE OK", flush=True)
    return report


if __name__ == "__main__":
    main()
