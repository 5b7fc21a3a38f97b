#!/usr/bin/env python3
"""Data-parallel training through the training CLI on N ranks, against one
process, on the ds2 U-Net at the full width of configs/config_dataset2.json.

    python3 scripts/torch_scale_out.py [--nproc 4] [--steps 8] [--epochs 2]
        [--out torch_scale_out.json]

Writes npz caches of synthetic ds2 showers (``chip_smoke.make_cli_data``'s,
with ``--steps`` x BATCH train events and one val batch), then runs
``python -m calodiffusion_tpu_torch.training ... diffusion`` in one process
and under ``torchrun --nproc-per-node N`` (one node: every rank reads the
same batches and takes its 1/N of each; NCCL on the cards, each rank on
``cuda:LOCAL_RANK``).  It prints each run's wall, its ms a step in the last
epoch (the trainer's own ``epoch phases`` line, the mean over that epoch's
steps), train samples/s from that, and rank 0's final loss histories and
weights against one process's; then the cards' names and power limits.
The CLI's steps are the same either way: the global batch is BATCH, split.

``--device cpu --widths 8 8 8 8`` rehearses it on the CPU (gloo) at tiny
widths.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def run(cmd, env=None) -> tuple[str, float]:
    """Run a command from the repository root; (its output, its wall)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"torch_scale_out FAILED: {' '.join(cmd)} exited {proc.returncode}:\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, wall


def last_epoch_step_s(out: str) -> tuple[float, int]:
    """(seconds, steps) of the last epoch's "step" phase in a training log."""
    phases = re.findall(r"epoch phases: .*?step: ([0-9.]+)s/(\d+)", out)
    if not phases:
        sys.exit(f"torch_scale_out FAILED: no epoch phases in the log:\n{out[-2000:]}")
    s, n = phases[-1]
    return float(s), int(n)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8, help="train steps an epoch")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--widths", type=int, nargs=4, default=None,
                    help="LAYER_SIZE_UNET in place of the config's (a CPU rehearsal)")
    ap.add_argument("--out", default=None, help="write the result JSON here")
    args = ap.parse_args()

    import torch

    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    card = args.device != "cpu"
    if card:
        if torch.cuda.device_count() < args.nproc:
            sys.exit(f"torch_scale_out FAILED: {args.nproc} ranks, "
                     f"{torch.cuda.device_count()} cards")
        from calodiffusion_tpu_torch.ops import cuda_build
        from calodiffusion_tpu_torch.ops import linear_attention as attn

        cuda_build.build_all(attn.BUILDS)  # once, before the ranks start
    cards = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True
                            ).stdout.strip().splitlines() if card else ["cpu"])
    batch = chip_smoke.cli_spec("ds2")["batch"]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        overrides = {"LAYER_SIZE_UNET": args.widths} if args.widths else {}
        chip_smoke.CLI_DATA["ds2"]["files"]["dataset_2_1.hdf5"] = args.steps * batch
        cfg, cfg_path, data = chip_smoke.make_cli_data(root, "ds2", args.seed, **overrides)
        Path(cfg_path).write_text(json.dumps(dict(cfg, MAXEPOCH=args.epochs)))
        common = ["-c", cfg_path, "-d", data, "--seed", str(args.seed + 1),
                  "--device", args.device]
        runs = {}
        for name, launcher in (
                ("one_process", [sys.executable, "-m"]),
                (f"{args.nproc}_ranks", [sys.executable, "-m", "torch.distributed.run",
                                         "--standalone", "--nproc-per-node", str(args.nproc),
                                         "--local-ranks-filter", "0", "-m"])):
            ckpt = root / name
            out, wall = run(launcher + ["calodiffusion_tpu_torch.training", *common,
                                        "--checkpoint", str(ckpt), "diffusion"],
                            env=dict(os.environ, PYTHONPATH=str(ROOT)))
            step_s, steps = last_epoch_step_s(out)
            folder = next(ckpt.iterdir())
            arrays, host = ckpt_io.load_checkpoint(str(folder), "final", map_location="cpu")
            runs[name] = dict(wall_s=wall, step_ms=1e3 * step_s / steps, steps=steps,
                              samples_per_s=batch * steps / step_s,
                              train_loss=host["train_loss_hist"],
                              val_loss=host["val_loss_hist"], params=arrays["params"])
    one, many = runs["one_process"], runs[f"{args.nproc}_ranks"]
    loss_rel = max(abs(many[h][e] - w) / abs(w)
                   for h in ("train_loss", "val_loss") for e, w in one[h].items())
    diff = sum(float(((many["params"][k] - w) ** 2).sum()) for k, w in one["params"].items())
    norm = sum(float((w ** 2).sum()) for w in one["params"].values())
    result = dict(nproc=args.nproc, batch=batch, steps_an_epoch=args.steps,
                  epochs=args.epochs, device=args.device, cards=cards,
                  loss_hist_max_rel_diff=loss_rel, weights_norm_rel_diff=math.sqrt(diff / norm),
                  **{name: {k: v for k, v in r.items() if k != "params"}
                     for name, r in runs.items()})
    for name, r in runs.items():
        print(f"{name}: wall {r['wall_s']:.1f} s; last epoch {r['steps']} steps of {batch}: "
              f"{r['step_ms']:.2f} ms/step, {r['samples_per_s']:.1f} train samples/s; train "
              f"losses {r['train_loss']}, val {r['val_loss']}", flush=True)
    print(f"{args.nproc} ranks against one process: loss histories {loss_rel:.3g} relative "
          f"at most; final weights {result['weights_norm_rel_diff']:.3g} apart in norm; "
          f"speed-up of a step {one['step_ms'] / many['step_ms']:.3f}", flush=True)
    if not all(math.isfinite(v) for r in runs.values() for h in ("train_loss", "val_loss")
               for v in r[h].values()):
        sys.exit("torch_scale_out FAILED: a loss is not finite")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print("\n".join(cards), flush=True)


if __name__ == "__main__":
    main()
