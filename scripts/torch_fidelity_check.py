#!/usr/bin/env python3
"""Physics-fidelity check of calodiffusion_tpu_torch on one CUDA card.

    python3 scripts/torch_fidelity_check.py [epochs] [--int8] [--out FILE]

The port's counterpart of ``scripts/tpu_fidelity_check.py``: the full
dataset-2 U-Net (``configs/config_dataset2.json`` with that script's
overrides: batch 128, EMA 0.999, ECUT, SHOWERSCALE 0.001, the eval file as
the val file) trains through the port's ``TrainDiffusion`` on its
structured synthetic showers (``synth_showers``: energy-dependent
longitudinal and radial profiles; 8192 train, 2048 eval), then generates
the eval set with 400-step DDim from the EMA weights.  Reported: the
separation powers between generated and "Geant" showers (total energy,
deposited over incident energy, the longitudinal profile's L1, sparsity),
then ``fidelity_metrics`` (classifier AUC and JSD, FPD), and the same gate
("FIDELITY OK" / "NEEDS MORE TRAINING").  ``epochs`` defaults to 80, the
JAX script's.

No jax and no h5py: the data are npz caches, as ``chip_smoke.write_cache``
writes them.  The histogram suite of ``evaluation/plots.py`` needs
matplotlib and runs only where it is installed.  ``--int8`` adds the JAX
script's A/B (scripts/tpu_fidelity_check.py:112-135): from the same trained
weights the eval set is generated again with W8A8 int8 sampling
(``QUANT_INT8``, calibrated on the first batch's conditioning), once
unfenced and once with the down-path fence of
scripts/tpu_fewstep_check.py:95-103 (``QUANT_INT8_EXCLUDE``: ResnetBlock_0..5
and the downsampling convs), and reports their separations, AUC, JSD and
FPD as ``int8_*`` and ``int8_fenced_*`` beside the float ones, with their
own gates and generation walls.  The report goes to ``--out``
(default ``torch_fidelity_report.json`` at the repository root, which git
ignores), never to the JAX package's ``fidelity_report.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# dataset-2 readout threshold, raw MeV (= the shipped config's ECUT of
# 1.51e-5 GeV): the synthetic "Geant" showers carry it and ECUT makes the
# inverse preprocessing apply it to the generated ones, as in
# scripts/tpu_fidelity_check.py
ECUT_RAW_MEV = 0.0151
SHOWERSCALE = 0.001
N_TRAIN, N_EVAL = 8192, 2048

# the JAX scripts' gate, which every harness of the port shares: the
# histogram separations ...
THRESH = {"Etot": 0.1, "ERatio": 0.1, "layer_profile_L1": 0.15}
# ... and the sharp instruments (CaloChallenge convention: AUC < ~0.7 good)
AUC_MAX = 0.70
FPD_MAX = 1.0


def synth_showers(n, rng):
    """Energy-dependent synthetic ds2 showers in raw MeV-like units (the
    recipe of scripts/tpu_fidelity_check.py)."""
    e_inc = 10 ** rng.uniform(3, 6, (n, 1)).astype(np.float32)  # 1 GeV..1 TeV
    z = np.arange(45, dtype=np.float32)[None, :, None, None]
    r = np.arange(9, dtype=np.float32)[None, None, None, :]
    # shower max depth grows with log E; radial spread fixed-ish
    t_max = 8 + 3 * (np.log10(e_inc) - 3)[:, :, None, None]
    prof_z = np.exp(-0.5 * ((z - t_max) / 6.0) ** 2)
    prof_r = np.exp(-r / 1.5)
    base = prof_z * prof_r / 16.0
    shower = base * rng.gamma(2.0, 1.0, (n, 45, 16, 9)).astype(np.float32)
    shower *= 0.5 * e_inc[:, :, None, None] / base.sum(
        axis=(1, 2, 3), keepdims=True
    )
    shower[rng.uniform(size=shower.shape) < 0.3] = 0
    shower[shower < ECUT_RAW_MEV] = 0
    return shower.reshape(n, -1).astype(np.float32), e_inc


def build_config(epochs: int) -> dict:
    """config_dataset2.json at full width with the JAX script's overrides."""
    cfg = json.loads((ROOT / "configs" / "config_dataset2.json").read_text())
    cfg.update(VAL_FILES=["dataset_2_2.hdf5"], EVAL=["dataset_2_2.hdf5"], BATCH=128,
               MAXEPOCH=epochs, NSTEPS=400, EMA_DECAY=0.999, CHECKPOINT_NAME="fidelity",
               ECUT=ECUT_RAW_MEV * 1e-3, SHOWERSCALE=SHOWERSCALE)
    return cfg


def compute_seps(ref, ref_e, gen, en, cfg, device):
    from calodiffusion_tpu_torch.evaluation.evaluate import FDPCalculationError, fidelity_metrics
    from calodiffusion_tpu_torch.evaluation.metrics_utils import separation_power

    seps = {}
    # total energy
    ref_tot, gen_tot = ref.sum(-1), gen.sum(-1)
    binning = np.geomspace(
        max(min(ref_tot.min(), gen_tot.min()), 1e-3),
        max(ref_tot.max(), gen_tot.max()), 30,
    )
    h1, _ = np.histogram(ref_tot, bins=binning, density=True)
    h2, _ = np.histogram(gen_tot, bins=binning, density=True)
    seps["Etot"] = separation_power(h2, h1, binning)

    # energy ratio (dep / inc), binned over the observed range
    ref_ratio = ref_tot / ref_e[:, 0]
    gen_ratio = gen_tot / en[:, 0]
    lo = min(np.quantile(ref_ratio, 0.001), np.quantile(gen_ratio, 0.001))
    hi = max(np.quantile(ref_ratio, 0.999), np.quantile(gen_ratio, 0.999))
    binning = np.linspace(lo, hi, 30)
    h1, _ = np.histogram(ref_ratio, bins=binning, density=True)
    h2, _ = np.histogram(gen_ratio, bins=binning, density=True)
    seps["ERatio"] = separation_power(h2, h1, binning)

    # longitudinal profile (fraction per layer), averaged shape distance
    ref_l = ref.reshape(-1, 45, 144).sum(-1)
    gen_l = gen.reshape(-1, 45, 144).sum(-1)
    ref_frac = (ref_l / ref_l.sum(1, keepdims=True)).mean(0)
    gen_frac = (gen_l / np.maximum(gen_l.sum(1, keepdims=True), 1e-8)).mean(0)
    seps["layer_profile_L1"] = float(np.abs(ref_frac - gen_frac).sum())

    # sparsity
    binning = np.linspace(0, 1, 21)
    h1, _ = np.histogram((ref > 1e-5).mean(-1), bins=binning, density=True)
    h2, _ = np.histogram((gen > 1e-5).mean(-1), bins=binning, density=True)
    seps["sparsity"] = separation_power(h2, h1, binning)

    # the evaluation suite's own separation powers, where matplotlib is
    try:
        import matplotlib

        matplotlib.use("Agg")
    except ImportError:
        print("plot-suite separations not run: no matplotlib here", flush=True)
    else:
        from calodiffusion_tpu_torch.evaluation import plots as plots_mod
        from calodiffusion_tpu_torch.utils.config import default_flags

        pflags = default_flags(
            plot_folder=tempfile.mkdtemp(), plot_extensions=["png"], plot_reshape=False,
            generated="fidelity", cms=False, layer_only=False, hgcal=False, EMin=-1.0,
        )
        data_dict = {
            "Geant4": ref.reshape(cfg["SHAPE_FINAL"]),
            "CaloDiffusion": gen.reshape(cfg["SHAPE_FINAL"]),
        }
        for cls, key in ((plots_mod.HistEtot, "plot_Etot"),
                         (plots_mod.HistERatio, "plot_ERatio"),
                         (plots_mod.SparsityLayer, "plot_sparsity")):
            p = cls(pflags, cfg)
            p(dict(data_dict), ref_e)
            for name, val in p.last_separations.items():
                seps[f"{key}|{name}"] = float(val)

    # classifier AUC/JSD + FPD over the high-level features; the report
    # survives the FPD's singular covariance, as in the JAX script, and
    # nothing else
    try:
        seps.update(fidelity_metrics(ref, ref_e[:, 0], gen, en[:, 0], nlayers=45,
                                     device=device))
    except FDPCalculationError as err:
        print(f"classifier/FPD metrics failed: {err}", flush=True)
    return seps


def gate(d) -> bool:
    """The JAX script's gate: the histogram separations, the classifier
    AUC and FPD where recorded."""
    ok = all(d[k] < v for k, v in THRESH.items())
    if "classifier_auc" in d:
        ok = ok and d["classifier_auc"] <= AUC_MAX
    if "fpd" in d:
        ok = ok and d["fpd"] <= FPD_MAX
    return bool(ok)


def int8_fence(cfg) -> list:
    """The down-path exclusion of the JAX package's int8 recipe
    (scripts/tpu_fewstep_check.py:95-103): every down-path ResnetBlock and
    the downsampling convs."""
    n_res = len(cfg["LAYER_SIZE_UNET"]) - 1
    return ([f"ResnetBlock_{i}/" for i in range(2 * n_res)]
            + [f"CondUnet_0/Conv3d_{i}" for i in range(n_res - 1)])


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 80 epochs + EMA, as the JAX script: its classifier AUC at 40 epochs
    # varied 0.44-0.76 between identical runs
    ap.add_argument("epochs", nargs="?", type=int, default=80)
    ap.add_argument("--int8", action="store_true",
                    help="also generate with W8A8 int8 sampling from the same weights, "
                         "unfenced and fenced, and report int8_* beside the float metrics")
    ap.add_argument("--out", default=str(ROOT / "torch_fidelity_report.json"))
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    args = ap.parse_args(argv)
    if Path(args.out).resolve() == (ROOT / "fidelity_report.json").resolve():
        sys.exit("--out: fidelity_report.json is the JAX package's report")

    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags
    from chip_smoke import write_cache

    card = card_line() if args.device != "cpu" else "CPU"
    print(card, flush=True)
    cfg = build_config(args.epochs)
    tmp = tempfile.TemporaryDirectory()
    data = Path(tmp.name)
    rng = np.random.default_rng(0)
    raw = {}
    for fname, n in (("dataset_2_1.hdf5", N_TRAIN), ("dataset_2_2.hdf5", N_EVAL)):
        raw[fname] = synth_showers(n, rng)
        write_cache(data / f"{fname}.npz", *raw[fname], cfg)

    flags = default_flags(data_folder=f"{data}/", checkpoint_folder=str(data / "ckpt"))
    trainer = TrainDiffusion(flags, cfg, device=args.device)
    t0 = time.perf_counter()
    model = trainer.train()
    # SWA tail average if accumulated, else EMA, else the raw final weights
    model.load_state_dict(trainer.inference_weights())
    if args.device != "cpu":
        torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    print(f"trained {args.epochs} epochs of {N_TRAIN // cfg['BATCH']} steps in "
          f"{train_s:.0f} s on {card}", flush=True)

    showers, e_inc = raw["dataset_2_2.hdf5"]
    ref, ref_e = showers * SHOWERSCALE, e_inc * SHOWERSCALE
    report = dict(epochs=args.epochs, train_s=train_s, card=card)
    # the float path, then (--int8) int8 unfenced and fenced from the same weights
    variants = [("", None)] + ([("int8_", []), ("int8_fenced_", int8_fence(cfg))]
                               if args.int8 else [])
    for tag, exclude in variants:
        model.config.update(QUANT_INT8=exclude is not None, QUANT_INT8_EXCLUDE=exclude or [])
        model._int8_scales = None  # generate calibrates on the first batch
        eval_loader, _ = load_data(default_flags(data_folder=f"{data}/"), cfg, eval=True)
        t0 = time.perf_counter()
        gen, en = model.generate(eval_loader, 400,
                                 generator=torch.Generator(device=model.device).manual_seed(0))
        generate_s = time.perf_counter() - t0
        print(f"{tag}generated {len(gen)} showers, 400-step DDim, in {generate_s:.1f} s "
              f"({len(gen) / generate_s:.3f} showers/s)", flush=True)
        t0 = time.perf_counter()
        seps = compute_seps(ref, ref_e, gen, en, cfg, args.device)
        metrics_s = time.perf_counter() - t0
        for k, v in seps.items():
            print(f"{tag}separation[{k}] = {v:.4f}", flush=True)
        ok = gate(seps)
        print(f"{tag}FIDELITY", "OK" if ok else "NEEDS MORE TRAINING", flush=True)
        report.update({f"{tag}{k}": float(v) for k, v in seps.items()})
        report.update({f"{tag}ok": ok, f"{tag}generate_s": generate_s,
                       f"{tag}metrics_s": metrics_s})
    tmp.cleanup()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
