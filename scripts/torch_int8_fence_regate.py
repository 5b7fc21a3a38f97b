#!/usr/bin/env python3
"""W8A8 int8 sampling behind the down-path fence, on the few-step teacher of
scripts/torch_fewstep_check.py, on one CUDA card.

    python3 scripts/torch_int8_fence_regate.py [--workdir PATH] [--sample-steps N]
        [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_int8_fence_regate.py``: it loads the
trained single-stage ds2 teacher of a ``torch_fewstep_check.py --workdir
PATH`` run (``PATH/ckpt/*/final.ckpt`` and its ``config.json``; its SWA, EMA
or final weights, as ``load_for_inference`` picks), generates that run's
eval set with 400-step DDim and W8A8 int8 behind the fence
(``QUANT_INT8_EXCLUDE``: ``ResnetBlock_{i}/`` for i < 2 n_res and
``CondUnet_0/Conv3d_{i}`` for i < n_res - 1, n_res = len(LAYER_SIZE_UNET) -
1; ``torch_fidelity_check.int8_fence``), calibrated on the first batch, and
scores it against the run's raw eval showers with
``torch_fidelity_check.compute_seps``.  The report ``--out`` (default
``PATH/int8_fence_regate.json``) holds the JAX script's JSON, ``{"int8_fenced":
{separation: value}}``; the JAX script's table in ``docs/INT8_CASCADE.md``
is not written.  ``--sample-steps`` cuts a run (``chip_smoke.py`` phase 19).
The script runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402
from torch_fidelity_check import SHOWERSCALE, compute_seps, int8_fence  # noqa: E402

DEFAULT_WORKDIR = "_work/fewstep"
SAMPLE_STEPS = 400


def teacher(workdir: str) -> tuple[str, dict]:
    """The few-step run's teacher checkpoint and config."""
    found = glob.glob(os.path.join(workdir, "ckpt", "*", "final.ckpt"))
    if not found:
        raise SystemExit(f"no teacher under {workdir}/ckpt: run "
                         "scripts/torch_fewstep_check.py --workdir there first")
    with open(os.path.join(os.path.dirname(found[0]), "config.json")) as f:
        return found[0], json.load(f)


def reference(workdir: str) -> tuple[np.ndarray, np.ndarray]:
    """The run's raw eval showers and energies, in the loader's units."""
    with np.load(os.path.join(workdir, "dataset_2_2.hdf5.raw.npz")) as f:
        return f["showers"] * SHOWERSCALE, f["energies"] * SHOWERSCALE


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--sample-steps", type=int, default=SAMPLE_STEPS)
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

    dev, workdir = opts.device, os.path.abspath(opts.workdir)
    print(fam.card_line(dev), flush=True)
    ckpt, cfg = teacher(workdir)
    ref, ref_e = reference(workdir)
    results = {}
    for tag, exclude in (("int8_fenced", int8_fence(cfg)),):
        c = dict(cfg, QUANT_INT8=True, QUANT_INT8_EXCLUDE=exclude)
        inf = TrainDiffusion(default_flags(data_folder=workdir + "/", model_loc=ckpt), c,
                             load_data=False, save_model=False, device=dev)
        model = inf.load_for_inference()
        eval_loader, _ = load_data(default_flags(data_folder=workdir + "/"), c, eval=True,
                                   device=dev)
        gen, en = model.generate(eval_loader, opts.sample_steps,
                                 generator=torch.Generator(device=dev).manual_seed(0))
        seps = compute_seps(ref, ref_e, gen, en, c, dev)
        results[tag] = {k: float(v) for k, v in seps.items()}
        print(f"[{tag}] auc={seps.get('classifier_auc', float('nan')):.3f} "
              f"fpd={seps.get('fpd', float('nan')):.3f} Etot={seps['Etot']:.4f}", flush=True)
    out = Path(opts.out or os.path.join(workdir, "int8_fence_regate.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
