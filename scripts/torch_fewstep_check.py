#!/usr/bin/env python3
"""Few-step sampling on calodiffusion_tpu_torch: fidelity and throughput
below 400 steps, on one CUDA card.

    python3 scripts/torch_fewstep_check.py [epochs] [--int8] [--distill [N]]
        [--workdir PATH] [--seed N] [--swa] [--events N] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_fewstep_check.py``: the dataset-2
U-Net at full width (widths [32, 32, 64, 32], EMA 0.999, ECUT) trains once
as the teacher (200 epochs on 32,768 synthetic showers by default), then the
eval set (2048) is generated with each (sampler, steps) candidate from the
same weights: the 400-step DDim baseline, ``CANDIDATES`` and the EDM
specialists ``EDM_CANDIDATES`` (with their ``NOISY_SAMPLE`` and
``SAMPLER_OPTIONS`` ``RHO`` overrides).  Each candidate gets the separations,
classifier AUC and JSD and FPD of ``torch_fidelity_check.compute_seps``, the
absolute gate (``THRESH``, ``AUC_MAX``, ``FPD_MAX``) and the gate relative to
the baseline (``REL_AUC_DELTA``, ``REL_FPD_DELTA``), and, where it passes
either, its showers/s: a warm batch-128 ``sample`` at its steps from seeded
random weights, best of 3, timed here (the JAX script's ``bench.py``
methodology; no benchmark file is written).  ``--int8`` evaluates
``CANDIDATES`` again with W8A8 int8 sampling under the down-path fence
(``int8_fence``) as ``fewstep_int8_*``; ``--distill [N]`` consistency-distills
the teacher (N epochs, default 400) and adds Consistency@{1, 2, 4} from the
student's EMA target.  ``write_report`` supersedes its prefix's whole entry
and leaves the other prefix and every other key alone.  ``--workdir PATH``
keeps the data and checkpoints there and resumes the teacher's and the
distillation's training; a changed setup in an existing workdir is refused.

Departures from the JAX script, forced by the card's machine: the data are
npz caches (``chip_smoke.write_cache``; the eval set's raw showers kept as
``dataset_2_2.hdf5.raw.npz``, the reference), the sampling noise comes from a
seeded ``torch.Generator``, int8 runs wherever it is asked for, the speeds
are timed by this script (the port does not import ``bench.py``), and the
report goes to ``--out`` (default ``torch_fidelity_report.json``, which git
ignores), never to ``fidelity_report.json``.

``--eval-events`` and ``--candidates TAG ...`` cut a run for a smoke test
(``chip_smoke.py`` phase 18): the eval events and the candidates evaluated
(the baseline always is).  The script runs on the card unless ``--device
cpu`` is given, and refuses where there is none.
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

# the down-path fence and the absolute gate, shared with the other harnesses
from torch_fidelity_check import AUC_MAX, FPD_MAX, THRESH, int8_fence  # noqa: E402
from torch_fidelity_families import card_line, check_device, sync, tiny_ds2_config  # noqa: E402

REPORT = ROOT / "torch_fidelity_report.json"

# (sampler, steps[, tag, config overrides]): the standard few-step solvers
CANDIDATES = [
    ("DDim", 100),
    ("DDim", 50),
    ("DPM", 21),
    ("DPMPP2M", 50),
    ("DPMPP2M", 36),
    ("DPMPP2M", 18),
]

# the EDM few-NFE specialists, bf16 only: Restart, Heun and DPM2 with churn
# (NOISY_SAMPLE: S_churn 40), and the Karras ladder's RHO
EDM_CANDIDATES = [
    ("Restart", 100),
    ("Restart", 50),
    ("Restart", 36),
    ("Heun", 50),
    ("Heun", 50, "Heun_50_churn", {"NOISY_SAMPLE": True}),
    ("Heun", 36, "Heun_36_churn", {"NOISY_SAMPLE": True}),
    ("DPM2", 36, "DPM2_36_churn", {"NOISY_SAMPLE": True}),
    ("Heun", 50, "Heun_50_rho3", {"SAMPLER_OPTIONS": {"RHO": 3}}),
    ("Heun", 50, "Heun_50_rho15", {"SAMPLER_OPTIONS": {"RHO": 15}}),
]

CONSISTENCY = [("Consistency", 1), ("Consistency", 2), ("Consistency", 4)]
# the baseline every candidate is judged against, from the same weights
BASELINE = ("DDim", 400)

# the gate relative to the 400-step baseline from the same weights: no
# degradation beyond metric noise (AUC err ~0.015, FPD err ~0.05)
REL_AUC_DELTA = 0.05
REL_FPD_DELTA = 0.25

N_EVAL = 2048

# the report's prefix of each mode, and the separations a candidate's row holds
PREFIX = {"bf16": "fewstep", "int8": "fewstep_int8"}
ROW_KEYS = ("Etot", "ERatio", "layer_profile_L1", "classifier_auc", "fpd")


def norm_cand(c):
    """A candidate row as (sampler name, steps, tag, overrides)."""
    if len(c) == 2:
        return c[0], c[1], f"{c[0]}_{c[1]}", {}
    return c[0], c[1], c[2], c[3]


def mode_candidates(mode: str) -> list:
    """The standard candidates ``mode`` evaluates: ``CANDIDATES``, and in
    bf16 the EDM specialists too."""
    return list(CANDIDATES) + (EDM_CANDIDATES if mode == "bf16" else [])


def report_keys(mode: str, tags) -> tuple[list, list]:
    """What ``write_report`` writes in ``mode`` for candidates ``tags``
    after a baseline: their separations (numbers), and the verdicts
    (booleans: each candidate's two gates and the teacher's)."""
    prefix = PREFIX[mode]
    values = [f"{prefix}_{t}_{k}" for t in tags for k in ROW_KEYS]
    verdicts = [f"{prefix}_{t}_{g}" for t in tags for g in ("ok", "rel_ok")]
    return values, verdicts + [f"{prefix}_teacher_ok"]


def gates(seps: dict, base) -> tuple[bool, bool]:
    """(absolute, relative) verdicts of one candidate; a missing sharp
    metric fails both, never passes vacuously."""
    ok_hist = all(seps[k] < v for k, v in THRESH.items())
    have_sharp = "classifier_auc" in seps and "fpd" in seps
    ok = (ok_hist and have_sharp and seps["classifier_auc"] <= AUC_MAX
          and seps["fpd"] <= FPD_MAX)
    rel_ok = ok_hist and have_sharp and base is not None and (
        seps["classifier_auc"] <= base.get("classifier_auc", AUC_MAX) + REL_AUC_DELTA
    ) and (seps["fpd"] <= base.get("fpd", FPD_MAX) + REL_FPD_DELTA)
    return bool(ok), bool(rel_ok)


def fewstep_config(epochs: int, swa: bool = False) -> dict:
    """The teacher's config (``epochs``; ``swa``: SWA over the last quarter)."""
    from torch_fidelity_check import ECUT_RAW_MEV

    return tiny_ds2_config(
        VAL_FILES=["dataset_2_2.hdf5"], EVAL=["dataset_2_2.hdf5"],
        BATCH=128, MAXEPOCH=epochs, NSTEPS=400,
        LAYER_SIZE_UNET=[32, 32, 64, 32], COND_SIZE_UNET=128,
        BLOCK_ATTN=True, MID_ATTN=True, PRECISION="bf16",
        EMA_DECAY=0.999,  # sample from the EMA weights
        CHECKPOINT_NAME="fewstep",
        ECUT=ECUT_RAW_MEV * 1e-3,
        **({"SWA_START_FRAC": 0.75} if swa else {}),
    )


def fewstep_showers(n_train, n_eval):
    """{file: (raw ds2 showers, incident energies)} of the JAX script's seed."""
    from torch_fidelity_check import synth_showers

    rng = np.random.default_rng(0)
    return {fname: synth_showers(n, rng)
            for fname, n in (("dataset_2_1.hdf5", n_train), ("dataset_2_2.hdf5", n_eval))}


def setup_workdir(opts) -> str:
    """The run's folder; with ``--workdir`` its ``harness_meta.json`` must
    match this run's setup (a mix of checkpoints is refused)."""
    if not opts.workdir:
        return tempfile.mkdtemp(prefix="fewstep_")
    tmp = os.path.abspath(opts.workdir)
    os.makedirs(tmp, exist_ok=True)
    meta = {"epochs": opts.epochs, "seed": opts.seed, "events": opts.events,
            "eval_events": opts.eval_events, "distill": opts.distill, "swa": opts.swa}
    meta_path = os.path.join(tmp, "harness_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            old = json.load(f)
        if old != meta:
            raise SystemExit(f"workdir {tmp} was set up with {old}, rerun asked for {meta}; "
                             "use a fresh --workdir")
        print(f"resuming in workdir {tmp}", flush=True)
    else:
        with open(meta_path, "w") as f:
            json.dump(meta, f)
    return tmp


def measure_sampling(cfg, sampler_name, steps, device, batch=128, runs=3) -> float:
    """Showers/s of a warm batch-``batch`` ``sample`` at ``steps``, from
    seeded random weights, best of ``runs`` (int8 calibrated before)."""
    import torch

    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    model = CaloDiffusion(cfg, n_steps=steps, loss_type="l2", device=device,
                          generator=torch.Generator().manual_seed(0))
    sampler = model.make_sampler(sampler_name)
    g = torch.Generator(device=device).manual_seed(1)
    E = torch.rand((batch, 3 if cfg.get("HGCAL") else 1), generator=g, device=device)
    layers = torch.randn((batch, cfg["SHAPE_FINAL"][2] + 1), generator=g, device=device)
    if model.int8_sampling_enabled():
        model.prepare_int8()
    best = float("inf")
    for i in range(runs + 1):  # the first call warms up
        sync(device)
        t0 = time.perf_counter()
        model.sample(E, layers=layers, num_steps=steps, generator=g, sampler=sampler)
        sync(device)
        if i:
            best = min(best, time.perf_counter() - t0)
    return batch / best


def candidate_speed(cfg, cand, mode, device) -> float:
    """``measure_sampling`` of candidate ``cand`` (a row of ``CANDIDATES``,
    ``EDM_CANDIDATES`` or ``CONSISTENCY``) on ``cfg``'s network with the
    candidate's overrides; ``mode`` "int8" samples W8A8 under the fence."""
    sampler_name, steps, _, overrides = norm_cand(cand)
    c = dict(cfg, **overrides, SAMPLER=sampler_name)
    c.pop("CHECKPOINT_NAME", None)
    if mode == "int8":
        c.update(QUANT_INT8=True, QUANT_INT8_EXCLUDE=int8_fence(cfg))
    return measure_sampling(c, sampler_name, steps, device)


def write_report(results, speeds, baseline, int8=False, out=None, baseline_tag="DDim_400"):
    """Merge this run's few-step results into the report (``out``, else
    ``REPORT``): each call supersedes its prefix's whole entry, so keys of
    an earlier run with other weights or candidates cannot pass for
    current; the other prefix and every non-few-step key stay.  The
    baseline's row (``baseline_tag``) is no candidate."""
    path = Path(out or REPORT)
    report = json.loads(path.read_text()) if path.exists() else {}
    prefix = PREFIX["int8" if int8 else "bf16"]
    for k in [k for k in report
              if k.startswith(prefix + "_")
              and not (prefix == "fewstep" and k.startswith("fewstep_int8_"))]:
        del report[k]
    if int8:
        # int8 rows are measured under the down-path fence (int8_fence)
        report["fewstep_int8_fenced"] = True
    best_tag, best_speed = None, 0.0
    for tag, r in results.items():
        if tag == baseline_tag:
            continue
        for k in ROW_KEYS:
            if k in r["seps"]:
                report[f"{prefix}_{tag}_{k}"] = r["seps"][k]
        report[f"{prefix}_{tag}_ok"] = r["ok"]
        report[f"{prefix}_{tag}_rel_ok"] = r["rel_ok"]
        if tag in speeds:  # failed-gate candidates skip the measurement
            report[f"{prefix}_{tag}_showers_per_sec"] = round(speeds[tag], 2)
        if r["ok"] and speeds.get(tag, 0.0) > best_speed:
            best_tag, best_speed = tag, speeds[tag]
    if baseline is not None:
        report[f"{prefix}_baseline_auc"] = baseline.get("classifier_auc")
        report[f"{prefix}_baseline_fpd"] = baseline.get("fpd")
        teacher_ok = (all(baseline[k] < v for k, v in THRESH.items())
                      and baseline.get("classifier_auc", 1.0) <= AUC_MAX
                      and baseline.get("fpd", 99.0) <= FPD_MAX)
        report[f"{prefix}_teacher_ok"] = bool(teacher_ok)
        if not teacher_ok:
            print("WARNING: the 400-step baseline itself fails the gate - "
                  "the teacher has not converged; few-step verdicts from "
                  "this run measure the teacher, not the samplers. "
                  "Re-run with more epochs.", flush=True)
    report[f"{prefix}_best"] = best_tag
    # a None tag carries a None speed, not a fabricated 0.0
    report[f"{prefix}_best_showers_per_sec"] = round(best_speed, 2) if best_tag else None
    rel_best, rel_speed = None, 0.0
    for tag, r in results.items():
        if tag != baseline_tag and r["rel_ok"] and speeds.get(tag, 0.0) > rel_speed:
            rel_best, rel_speed = tag, speeds[tag]
    report[f"{prefix}_best_rel"] = rel_best
    report[f"{prefix}_best_rel_showers_per_sec"] = round(rel_speed, 2) if rel_best else None
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    print(f"wrote {path}: {prefix}_best={best_tag} @ {best_speed:.1f} showers/sec", flush=True)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, default=200)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--distill", nargs="?", type=int, const=400, default=None,
                    metavar="N", help="distill N epochs (default 400) and add Consistency")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--swa", action="store_true")
    ap.add_argument("--events", type=int, default=32768)
    ap.add_argument("--out", default=str(REPORT))
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    ap.add_argument("--eval-events", type=int, default=N_EVAL)
    ap.add_argument("--candidates", nargs="+", default=None, metavar="TAG")
    return ap


def main(argv=None):
    opts = parser().parse_args(argv)
    if Path(opts.out).resolve() == (ROOT / "fidelity_report.json").resolve():
        raise SystemExit("--out: fidelity_report.json is the JAX package's report")
    check_device(opts.device)
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags
    from torch_fidelity_check import compute_seps
    from torch_fidelity_families import have_files, write_caches

    dev = opts.device
    card = card_line(dev)
    print(card, flush=True)
    tmp = setup_workdir(opts)
    data = tmp + "/"
    cfg = fewstep_config(opts.epochs, opts.swa)
    files = ("dataset_2_1.hdf5.npz", "dataset_2_2.hdf5.npz", "dataset_2_2.hdf5.raw.npz")
    # drawn again unless every file is there (the files share one stream)
    if not have_files(tmp, files):
        write_caches(tmp, fewstep_showers(opts.events, opts.eval_events), cfg,
                     "dataset_2_2.hdf5")

    trainer = TrainDiffusion(default_flags(data_folder=data, checkpoint_folder=tmp + "/ckpt",
                                           seed=opts.seed, load=bool(opts.workdir)),
                             cfg, device=dev)
    t0 = time.perf_counter()
    model = trainer.train()
    # the EMA (and with --swa the SWA tail average) of the teacher
    teacher = {k: v.detach().clone() for k, v in trainer.inference_weights().items()}
    model.load_state_dict(teacher)
    sync(dev)
    print(f"trained {opts.epochs} epochs in {time.perf_counter() - t0:.0f}s on {card}",
          flush=True)

    with np.load(os.path.join(tmp, "dataset_2_2.hdf5.raw.npz")) as f:
        ref = f["showers"] * 0.001  # SHOWERSCALE
        ref_e = f["energies"] * 0.001

    want_int8 = opts.int8
    if want_int8:
        model.config["QUANT_INT8"] = True
        if not model.int8_sampling_enabled():
            print("int8 requested but not allowed (CALODIFF_INT8=0)", flush=True)
            want_int8 = False
        model.config["QUANT_INT8"] = False

    wanted = None if opts.candidates is None else set(opts.candidates)
    student = None
    # per mode: --int8 adds an int8 record beside the bf16 one
    results = {"bf16": {}, "int8": {}}
    speeds = {"bf16": {}, "int8": {}}
    baseline = {}  # mode -> 400-step DDim separations from the same weights

    def chosen(cand_list):
        return [c for c in cand_list if wanted is None or norm_cand(c)[2] in wanted]

    def eval_candidates(cand_list, mode):
        model.config["QUANT_INT8"] = mode == "int8"
        if mode == "int8":  # measured under the down-path fence
            model.config["QUANT_INT8_EXCLUDE"] = int8_fence(cfg)
        for cand in cand_list:
            sampler_name, steps, tag, overrides = norm_cand(cand)
            eval_loader, _ = load_data(default_flags(data_folder=data), cfg, eval=True,
                                       device=dev)
            saved = {k: model.config.get(k, "__missing__") for k in overrides}
            model.config.update(overrides)
            sampler = model.make_sampler(sampler_name)
            weights = student if sampler_name == "Consistency" else teacher
            model.load_state_dict(weights)
            if sampler_name == "Consistency" and mode == "int8":
                model._int8_scales = None  # calibrate again for the student
            t0 = time.perf_counter()
            try:
                gen, en = model.generate(eval_loader, steps, sampler=sampler,
                                         generator=torch.Generator(device=dev).manual_seed(0))
            finally:
                for k, v in saved.items():
                    if v == "__missing__":
                        model.config.pop(k, None)
                    else:
                        model.config[k] = v
            sync(dev)
            gen_t = time.perf_counter() - t0
            seps = compute_seps(ref, ref_e, gen, en, cfg, dev)
            ok, rel_ok = gates(seps, baseline.get(mode))
            results[mode][tag] = {"seps": seps, "ok": ok, "rel_ok": rel_ok, "gen_s": gen_t}
            if (sampler_name, steps) == BASELINE:
                baseline[mode] = seps
            print(f"[{mode}:{tag}] ok={ok} rel_ok={rel_ok} "
                  f"Etot={seps['Etot']:.4f} ERatio={seps['ERatio']:.4f} "
                  f"auc={seps.get('classifier_auc', float('nan')):.3f} "
                  f"fpd={seps.get('fpd', float('nan')):.4f} ({gen_t:.0f}s generate)",
                  flush=True)
        model.config["QUANT_INT8"] = False

    def measure_speeds(cand_list, mode):
        # throughput at each candidate's steps from random weights; a
        # candidate that failed both gates is skipped (its verdict is its
        # fidelity)
        for cand in cand_list:
            tag = norm_cand(cand)[2]
            r = results[mode].get(tag)
            if r is not None and not (r["ok"] or r["rel_ok"]):
                print(f"[{mode}:{tag}] speed skipped (failed gate)", flush=True)
                continue
            speeds[mode][tag] = candidate_speed(cfg, cand, mode, dev)
            print(f"[{mode}:{tag}] {speeds[mode][tag]:.1f} showers/sec (batch 128, best of "
                  f"3, random weights) on {card}", flush=True)

    def report(mode):
        write_report(results[mode], speeds[mode], baseline.get(mode), int8=mode == "int8",
                     out=opts.out, baseline_tag=norm_cand(BASELINE)[2])

    modes = ["bf16"] + (["int8"] if want_int8 else [])
    # the standard candidates are reported before the (long) distillation
    for mode in modes:
        cands = chosen(mode_candidates(mode))
        eval_candidates([BASELINE] + cands, mode)
        measure_speeds(cands, mode)
        report(mode)

    if opts.distill is not None:
        # teacher -> few-step student; with --workdir the distiller resumes
        # from its per-epoch checkpoint
        from calodiffusion_tpu_torch.train.train_distill import TrainDistillation

        dcfg = dict(cfg, MAXEPOCH=opts.distill, CHECKPOINT_NAME="fewstep_cd", DISTILL_LR=1e-4)
        t0 = time.perf_counter()
        distiller = TrainDistillation(
            default_flags(data_folder=data, checkpoint_folder=tmp + "/ckpt_cd",
                          seed=opts.seed, load=bool(opts.workdir)),
            dcfg, teacher_params=teacher, device=dev)
        distiller.train()
        # sample from the EMA target network
        student = {k: v.detach().clone() for k, v in distiller.ema_params.items()}
        print(f"distilled {opts.distill} epochs in {time.perf_counter() - t0:.0f}s",
              flush=True)
        for mode in modes:
            eval_candidates(chosen(CONSISTENCY), mode)
            measure_speeds(chosen(CONSISTENCY), mode)
            report(mode)
    return results, speeds


if __name__ == "__main__":
    main()
