#!/usr/bin/env python3
"""Extend the few-step run's consistency distillation and measure it again,
on calodiffusion_tpu_torch and one CUDA card.

    python3 scripts/torch_distill_extend.py [--workdir PATH] [--to-epochs N]
        [--steps 4,2] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_distill_extend.py``: the distilled
student of a ``torch_fewstep_check.py --distill --workdir PATH`` run
(``PATH/ckpt_cd/*``, its ``config.json`` with ``MAXEPOCH`` raised to
``--to-epochs``) resumes from its per-epoch checkpoint against the same
teacher (``PATH/ckpt/*/final.ckpt``'s SWA, EMA or final weights), then the
run's eval set is generated with the Consistency sampler from the student's
EMA target at each of ``--steps`` (default 4,2; ``--steps 1,2,4`` for the
full ladder) and scored with ``torch_fidelity_check.compute_seps``.  Each
row, ``epochs<N>_Consistency_<steps>``, is merged into the report ``--out``
(default ``PATH/distill_scaling.json``, the JAX script's
``docs/distill_scaling.json`` keys) as soon as it is measured.  The script
runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402
from torch_int8_fence_regate import DEFAULT_WORKDIR, reference, teacher  # noqa: E402


def measure_consistency(model, student, cfg, workdir, steps_list, tag_of, results, out,
                        device, extra=None) -> dict:
    """The eval set with the Consistency sampler from ``student`` at each
    of ``steps_list``, scored and merged into ``results`` under
    ``tag_of(steps)`` (with ``extra``), ``out`` rewritten after each."""
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.utils.config import default_flags
    from torch_fidelity_check import compute_seps

    ref, ref_e = reference(workdir)
    model.load_state_dict(student)
    sampler = model.make_sampler("Consistency")
    for n in steps_list:
        eval_loader, _ = load_data(default_flags(data_folder=workdir + "/"), cfg, eval=True,
                                   device=device)
        gen, en = model.generate(eval_loader, n, sampler=sampler,
                                 generator=torch.Generator(device=device).manual_seed(0))
        seps = compute_seps(ref, ref_e, gen, en, cfg, device)
        tag = tag_of(n)
        results[tag] = dict({k: float(v) for k, v in seps.items()}, **(extra or {}))
        print(f"[{tag}] auc={seps.get('classifier_auc', float('nan')):.3f} "
              f"fpd={seps.get('fpd', float('nan')):.3f}", flush=True)
        out.write_text(json.dumps(results, indent=1))  # a cut run keeps its rows
    print(f"wrote {out}", flush=True)
    return results


def load_results(out: Path) -> dict:
    return json.loads(out.read_text()) if out.exists() else {}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--to-epochs", type=int, default=200)
    ap.add_argument("--steps", default="4,2", help="Consistency steps, comma-separated")
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
    found = glob.glob(os.path.join(workdir, "ckpt_cd", "*", "config.json"))
    if not found:
        raise SystemExit(f"no distilled student under {workdir}/ckpt_cd: run "
                         "scripts/torch_fewstep_check.py --distill --workdir there first")
    with open(found[0]) as f:
        dcfg = json.load(f)
    dcfg["MAXEPOCH"] = opts.to_epochs
    teacher_weights = ckpt_io.load_inference_weights(teacher(workdir)[0], dev)

    distiller = TrainDistillation(
        default_flags(data_folder=workdir + "/", checkpoint_folder=os.path.join(workdir, "ckpt_cd"),
                      load=True),
        dcfg, teacher_params=teacher_weights, device=dev)
    model = distiller.train()  # resumes from checkpoint.ckpt
    student = {k: v.detach().clone() for k, v in distiller.ema_params.items()}

    out = Path(opts.out or os.path.join(workdir, "distill_scaling.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    return measure_consistency(
        model, student, dcfg, workdir, [int(s) for s in opts.steps.split(",")],
        lambda n: f"epochs{opts.to_epochs}_Consistency_{n}", load_results(out), out, dev)


if __name__ == "__main__":
    main()
