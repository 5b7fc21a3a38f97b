#!/usr/bin/env python3
"""One other consistency-distillation recipe from the few-step run's
teacher, on calodiffusion_tpu_torch and one CUDA card.

    python3 scripts/torch_distill_variant.py [--workdir PATH] [--epochs 50]
        [--nsteps 18] [--decay 0.999] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_distill_variant.py``: one student
distilled from the teacher of a ``torch_fewstep_check.py --workdir PATH``
run (``PATH/ckpt/*/final.ckpt``'s SWA, EMA or final weights, its config)
with a coarse sigma grid (``CONSIS_NSTEPS`` ``--nsteps``), a slower target
EMA (``DISTILL_TARGET_DECAY`` ``--decay``) and ``DISTILL_LR`` 1e-4, for
``--epochs``, its checkpoints in ``PATH/ckpt_cd_<tag>`` (resumed where
present), then Consistency@{4, 2} from its EMA target on the run's eval
set, scored with ``torch_fidelity_check.compute_seps``.  Each row,
``variant_n<nsteps>_d<decay>_e<epochs>_Consistency_<steps>`` with its
``source``, is merged into the report ``--out`` (default
``PATH/distill_scaling.json``, the JAX script's ``docs/distill_scaling.json``
keys) as soon as it is measured.  The script runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402
from torch_distill_extend import load_results, measure_consistency  # noqa: E402
from torch_int8_fence_regate import DEFAULT_WORKDIR, teacher  # noqa: E402

CONSISTENCY_STEPS = (4, 2)


def variant_config(cfg, epochs, nsteps, decay) -> tuple[str, dict]:
    tag = f"variant_n{nsteps}_d{decay}_e{epochs}"
    return tag, dict(cfg, MAXEPOCH=epochs, CHECKPOINT_NAME=f"fewstep_cd_{tag}", DISTILL_LR=1e-4,
                     CONSIS_NSTEPS=nsteps, DISTILL_TARGET_DECAY=decay)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--nsteps", type=int, default=18)
    ap.add_argument("--decay", type=float, default=0.999)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    fam.check_device(opts.device)
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
    from calodiffusion_tpu_torch.utils.config import default_flags

    dev, workdir = opts.device, os.path.abspath(opts.workdir)
    print(fam.card_line(dev), flush=True)
    ckpt, cfg = teacher(workdir)
    tag, dcfg = variant_config(cfg, opts.epochs, opts.nsteps, opts.decay)
    distiller = TrainDistillation(
        default_flags(data_folder=workdir + "/",
                      checkpoint_folder=os.path.join(workdir, f"ckpt_cd_{tag}"),
                      load=True),  # resumes a run cut short
        dcfg, teacher_params=ckpt_io.load_inference_weights(ckpt, dev), device=dev)
    model = distiller.train()
    student = {k: v.detach().clone() for k, v in distiller.ema_params.items()}

    out = Path(opts.out or os.path.join(workdir, "distill_scaling.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    source = (f"torch_distill_variant.py: coarse {opts.nsteps}-pt sigma grid, target decay "
              f"{opts.decay}, {opts.epochs} epochs from the same teacher")
    return measure_consistency(model, student, dcfg, workdir, CONSISTENCY_STEPS,
                               lambda n: f"{tag}_Consistency_{n}", load_results(out), out, dev,
                               extra={"source": source})


if __name__ == "__main__":
    main()
