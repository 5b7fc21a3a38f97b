#!/usr/bin/env python3
"""The cascade's fidelity gate over several training seeds, on
calodiffusion_tpu_torch and one CUDA card.

    python3 scripts/torch_cascade_seeds.py [--seeds 1,2,3] [--epochs 200]
        [--events 32768] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_cascade_seeds.py``: the cascade
family of ``torch_fidelity_families.py`` (the 200-epoch base U-Net with EMA,
SWA over the last quarter, 32,768 events, the stage-1 floor) once per seed.
Each seed's row (its separations, AUC, JSD, FPD, wall) goes to
``torch_cascade_seeds.json`` beside ``--out`` as soon as it is done, and a
rerun skips the seeds it holds.  Over every row held, the report
``--out`` (default ``torch_fidelity_report.json``, which git ignores) gets
``layer_seed_n``, the mean AUC and FPD with their t-based 95 % half-widths
(``layer_seed_auc_mean``, ``_auc_ci95``, ``_fpd_mean``, ``_fpd_ci95``) and
``layer_seeds_ok``, the gate on the means.  The JAX package's
``docs/cascade_seeds.json`` and ``fidelity_report.json`` are never written.

``--eval-events``, ``--sample-steps``, ``--stage1-epochs`` and ``--workdir``
(each seed in ``PATH/seed<N>``, resumed) pass to the family as in
``torch_fidelity_families.py``; ``chip_smoke.py`` phase 18 cuts a run with
them.  The script runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402
from torch_fidelity_check import AUC_MAX, FPD_MAX  # noqa: E402  (the shared gate)


def aggregate(rows: dict) -> dict:
    """``layer_seed_*`` over the rows: the mean AUC and FPD and their
    t-based 95 % half-widths (n <= 6, so the normal quantile is too tight;
    NaN below two rows), and the gate on the means."""
    aucs = np.array([r["classifier_auc"] for r in rows.values() if "classifier_auc" in r])
    fpds = np.array([r["fpd"] for r in rows.values() if "fpd" in r])
    n = len(aucs)
    if n >= 2:
        from scipy import stats

        tq = stats.t.ppf(0.975, n - 1)
        auc_ci = tq * aucs.std(ddof=1) / np.sqrt(n)
        fpd_ci = tq * fpds.std(ddof=1) / np.sqrt(n)
    else:
        auc_ci = fpd_ci = float("nan")
    return {
        "layer_seed_n": int(n),
        "layer_seed_auc_mean": round(float(aucs.mean()), 4),
        "layer_seed_auc_ci95": round(float(auc_ci), 4),
        "layer_seed_fpd_mean": round(float(fpds.mean()), 4),
        "layer_seed_fpd_ci95": round(float(fpd_ci), 4),
        # the statistical gate: the recipe passes if the mean passes
        "layer_seeds_ok": bool(aucs.mean() <= AUC_MAX and fpds.mean() <= FPD_MAX),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--events", type=int, default=32768)
    ap.add_argument("--out", default=str(fam.REPORT))
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--eval-events", type=int, default=fam.EVAL_EVENTS)
    ap.add_argument("--sample-steps", type=int, default=400)
    ap.add_argument("--stage1-epochs", type=int, default=None)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    out = Path(args.out)
    if out.resolve() == (ROOT / "fidelity_report.json").resolve():
        raise SystemExit("--out: fidelity_report.json is the JAX package's report")
    rows_path = out.parent / "torch_cascade_seeds.json"
    fam.check_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = json.loads(rows_path.read_text()) if rows_path.exists() else {}

    for seed in seeds:
        tag = f"seed{seed}"
        if tag in rows:
            print(f"[{tag}] already recorded, skipping", flush=True)
            continue
        # the family's own flags: the recipe (--swa) at this seed
        argv = ["layer", "--swa", "--seed", str(seed), "--events", str(args.events),
                "--device", args.device, "--eval-events", str(args.eval_events),
                "--sample-steps", str(args.sample_steps), "--out", str(out)]
        if args.stage1_epochs is not None:
            argv += ["--stage1-epochs", str(args.stage1_epochs)]
        if args.workdir:
            argv += ["--workdir", os.path.join(args.workdir, tag), "--resume"]
        opts = fam.parse(argv)
        t0 = time.perf_counter()
        seps, _walls = fam.layer_family(args.epochs, opts)
        row = {k: float(v) for k, v in seps.items()}
        row.update(wall_s=round(time.perf_counter() - t0, 1), epochs=args.epochs,
                   events=args.events)
        rows[tag] = row
        rows_path.parent.mkdir(parents=True, exist_ok=True)
        rows_path.write_text(json.dumps(rows, indent=1))  # keep finished seeds
        print(f"[{tag}] auc={row.get('classifier_auc', float('nan')):.3f} "
              f"fpd={row.get('fpd', float('nan')):.3f} ({row['wall_s']:.0f}s)", flush=True)

    agg = aggregate(rows)
    report = json.loads(out.read_text()) if out.exists() else {}
    report.update(agg)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"cascade over {agg['layer_seed_n']} seeds: AUC {agg['layer_seed_auc_mean']:.4f} "
          f"± {agg['layer_seed_auc_ci95']:.4f} (95% CI), FPD {agg['layer_seed_fpd_mean']:.4f} "
          f"± {agg['layer_seed_fpd_ci95']:.4f}; layer_seeds_ok={agg['layer_seeds_ok']}",
          flush=True)
    return agg


if __name__ == "__main__":
    main()
