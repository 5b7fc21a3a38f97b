#!/usr/bin/env python3
"""Physics-fidelity checks of calodiffusion_tpu_torch for every family
beyond dataset 2, on one CUDA card.

    python3 scripts/torch_fidelity_families.py [epochs] [family ...] [--int8]
        [--oracle] [--roundtrip] [--swa] [--events N] [--seed N]
        [--workdir PATH] [--resume] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/tpu_fidelity_families.py``, with its
five families, data, configs, flags and report rules: ``hgcal`` (the GLaM
pre-embed at widths [16, 16, 32, 32], sparse decoding, the readout threshold
applied to the generated showers as the inference CLI's ``--energy-min``),
``ds1`` and ``ds1pion`` (the orig-NN embed on stand-in binnings), ``ds3``
(the full 45 x 50 x 18 grid and the shipped widths) and ``layer`` (the
two-stage cascade at ds2's full widths).  Each trains through the port's
``TrainDiffusion`` (``TrainLayerModel`` for the cascade's stage 1), samples
the eval set with 400-step DDim from the SWA, EMA or final weights, and
reports the separations (total energy, deposited over incident energy, the
longitudinal profile where the family has layers), the classifier AUC and
JSD and the FPD of ``fidelity_metrics``, with the JAX script's gate.  The
families default to ``hgcal ds1`` and to the JAX script's epochs
(``DEFAULT_EPOCHS``).  ``--int8`` adds W8A8 int8 sampling from the same
weights (``int8_*``), ``--oracle`` the cascade's stage 2 on the true layer
energies (``oracle_*``), ``--roundtrip`` the eval showers through the embed's
encode and decode (``ceiling_*``, dataset 1 and HGCal), ``--swa`` SWA over
the last quarter of each trainer's epochs.  ``--events`` sets the train
events, ``--seed`` the trainers' draws (the data stay on their own seeds).
A rerun supersedes a family's whole entry; the report is written after
every family.

Departures from the JAX script, each forced by the card's machine:

- The data are npz caches as the loader writes them from h5 files
  (``chip_smoke.write_cache`` and ``write_hgcal_cache``), since that machine
  has no h5py; the raw eval showers, the "Geant" reference, are kept beside
  them as ``<eval file>.raw.npz`` and read back from there.  The synthetic
  showers are drawn from the JAX script's seeds and equal its h5 files bit
  for bit.
- The sampling noise comes from a seeded ``torch.Generator`` in place of
  ``PRNGKey(0)`` (HGCal's sparse decode from ``default_rng(0)``).
- Int8 runs wherever it is asked for (the port's ``int8_allowed``).
- ``--workdir PATH`` (each family in ``PATH/<family>``) with ``--resume``
  resumes every family's training from its per-epoch checkpoints (the JAX
  script: ds3 alone), since a call on the card lasts at most an hour and
  the cascade and ds3 need several; the data are drawn again where any of a
  family's files is missing.  The cascade's
  eval arrays go to ``<workdir>/fidelity_layer_arrays.npz``, not ``/tmp``.
- The report goes to ``--out`` (default ``torch_fidelity_report.json`` at
  the repository root, which git ignores), never to the JAX package's
  ``fidelity_report.json``.

``--eval-events``, ``--sample-steps`` and ``--stage1-epochs`` cut a run for
a smoke test (``chip_smoke.py`` phase 18): the eval events (default 1536),
the DDim steps of every stage (400) and the cascade stage 1's epochs (by
default ``max(2 epochs, 400 * 8192 / events)``).  The script runs on the card
unless ``--device cpu`` is given, and refuses where there is none.
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

from torch_fidelity_check import AUC_MAX, FPD_MAX, THRESH  # noqa: E402  (the shared gate)

REPORT = ROOT / "torch_fidelity_report.json"

# Synthetic zeros are threshold-driven (the JAX script's note): every zero is
# "energy below the readout threshold", set at this quantile of the pre-cut
# voxel distribution, so the rank-limited decodes can reproduce the sparsity
SPARSITY_QUANTILE = 0.45

FAMILIES = ("hgcal", "ds1", "ds1pion", "layer", "ds3")
# the JAX script's measured per-family epochs
DEFAULT_EPOCHS = {"hgcal": 25, "ds1": 100, "ds1pion": 100, "layer": 200, "ds3": 100}
TRAIN_EVENTS = {"hgcal": 6144, "ds1": 6144, "ds1pion": 6144, "layer": 32768, "ds3": 16384}
EVAL_EVENTS = 1536
# the layer axis of each family's separations (the longitudinal profile)
LAYER_AXIS = {"hgcal": 28, "ds1": None, "ds1pion": None, "layer": 45, "ds3": 45}
# the separations of each prefix: the histogram terms, then the sharp
# instruments of ``fidelity_metrics``
HIST_KEYS = ("Etot", "ERatio")
SHARP_KEYS = ("classifier_auc", "classifier_jsd", "fpd", "fpd_err")
# the prefix each flag's separations carry, and the families that write them
FLAG_PREFIXES = {"int8": ("int8_", FAMILIES),
                 "roundtrip": ("ceiling_", ("hgcal", "ds1", "ds1pion")),
                 "oracle": ("oracle_", ("layer",))}

# tests/utils_test.py::tiny_ds2_config, which every family's config overrides
TINY_DS2 = {
    "FILES": ["dataset_2_1.hdf5"], "EVAL": ["dataset_2_2.hdf5"], "BIN_FILE": "",
    "DATASET_NUM": 2, "HOLDOUT": 0, "SHAPE_ORIG": [-1, 6480],
    "SHAPE_PAD": [-1, 1, 45, 16, 9], "SHAPE_FINAL": [-1, 1, 45, 16, 9], "BATCH": 4,
    "LR": 4e-4, "MAXEPOCH": 2, "EARLYSTOP": 20, "LAYER_SIZE_UNET": [16, 16, 16, 16],
    "COND_SIZE_UNET": 32, "BLOCK_ATTN": False, "MID_ATTN": False, "COMPRESS_Z": True,
    "EMAX": 1000.0, "EMIN": 1.0, "ECUT": 0.0000151, "logE": True, "MAXDEP": 2,
    "CYLINDRICAL": True, "SHOWERSCALE": 0.001, "SHOWERMAP": "layer-logit-norm",
    "R_Z_INPUT": True, "NOISE_SCHED": "log", "NSTEPS": 400, "CONSIS_NSTEPS": 100,
    "TRAINING_OBJ": "hybrid_weight", "LOSS_TYPE": "l2", "TIME_EMBED": "log",
    "COND_EMBED": "id", "SHOWER_EMBED": "", "CHECKPOINT_NAME": "tiny_ds2",
}

# the cascade's int8 fence (docs/INT8_CASCADE.md): the down path stays bf16
CASCADE_INT8_EXCLUDE = ([f"ResnetBlock_{i}/" for i in range(6)]
                        + ["CondUnet_0/Conv3d_0", "CondUnet_0/Conv3d_1"])

# Stand-in dataset-1 geometries: (layer id, r_edges, n_bin_alpha) per layer
DS1_GEOMS = {
    "photon": [
        ("0", list(range(0, 31, 2)), 1),
        ("1", list(range(0, 31)), 10),
        ("2", list(range(0, 31, 3)), 10),
        ("3", list(range(0, 31, 5)), 1),
    ],
    "pion": [
        ("0", [0, 5, 10, 30, 50, 100, 200, 300], 1),
        ("1", [0, 2, 4, 6, 10, 15, 30, 50, 90, 150, 200, 300], 10),
        ("2", [0, 5, 10, 20, 30, 50, 80, 130, 200, 300], 10),
        ("3", [0, 50, 100, 200, 300], 1),
        ("4", [0, 10, 20, 30, 50, 80, 100, 130, 160, 200, 250, 300], 1),
        ("5", [0, 50, 100, 150, 200, 250, 300], 1),
        ("6", [0, 50, 100, 150, 200, 250, 300], 1),
    ],
}

# the "classifier/FPD metrics failed" messages of this process, in order:
# each a singular covariance in the FPD, which costs its prefix the sharp
# instruments (any other failure ends the run)
METRIC_FAILURES: list = []


def tiny_ds2_config(**overrides) -> dict:
    return {**json.loads(json.dumps(TINY_DS2)), **overrides}


def swa_overrides(opts) -> dict:
    """``--swa``: SWA over the last quarter of each trainer's epochs."""
    return {"SWA_START_FRAC": 0.75} if opts.swa else {}


def workdir(opts, tag: str) -> str:
    """The family's folder: ``<--workdir>/<tag>`` (made where missing) or a
    new temporary one."""
    if opts.workdir:
        path = os.path.abspath(os.path.join(opts.workdir, tag))
        os.makedirs(path, exist_ok=True)
        return path
    return tempfile.mkdtemp(prefix=f"fid_{tag}_")


def have_files(tmp: str, names) -> bool:
    return all(os.path.exists(os.path.join(tmp, n)) for n in names)


def write_caches(tmp: str, files: dict, cfg: dict, eval_file: str, device="cpu") -> None:
    """The npz cache the loader writes for each ``{file: (showers,
    energies)}`` (HGCal: gen_info, encoded by its pre-embed converter on
    ``device``), and the raw eval showers as ``<eval_file>.raw.npz``."""
    from chip_smoke import write_cache, write_hgcal_cache

    if cfg.get("HGCAL"):
        from calodiffusion_tpu_torch.utils import hgcal_utils

        conv = hgcal_utils.make_pre_embed_converter(cfg, device=device)
    for fname, (showers, energies) in files.items():
        path = os.path.join(tmp, f"{fname}.npz")
        if cfg.get("HGCAL"):
            write_hgcal_cache(path, [(showers, energies)], cfg, conv, device=device)
        else:
            write_cache(path, showers, energies, cfg)
    showers, energies = files[eval_file]
    np.savez(os.path.join(tmp, f"{eval_file}.raw.npz"), showers=showers, energies=energies)


def cache_names(files, eval_file) -> list:
    return [f"{f}.npz" for f in files] + [f"{eval_file}.raw.npz"]


def separations(ref, ref_e, gen, gen_e, nlayer_axis, include_occupancy=True, device=None):
    """The JAX script's separation set over (N, ...) physical showers:
    total energy, deposited over incident energy, the longitudinal profile's
    L1 (with ``nlayer_axis``), then ``fidelity_metrics`` (classifier AUC and
    JSD, FPD) on the feature matrices built once.  ``include_occupancy`` is
    False for the embedded-decode families (HGCal GLaM, dataset 1's embed):
    a rank-limited decode cannot carry per-cell zeros."""
    from calodiffusion_tpu_torch.evaluation.evaluate import (FDPCalculationError,
                                                             fidelity_metrics,
                                                             shower_feature_matrix)
    from calodiffusion_tpu_torch.evaluation.metrics_utils import separation_power

    seps = {}
    ref_flat = ref.reshape(ref.shape[0], -1)
    gen_flat = gen.reshape(gen.shape[0], -1)
    ref_tot, gen_tot = ref_flat.sum(-1), gen_flat.sum(-1)
    binning = np.geomspace(
        max(min(ref_tot.min(), gen_tot.min()), 1e-3),
        max(ref_tot.max(), gen_tot.max()), 30,
    )
    h1, _ = np.histogram(ref_tot, bins=binning, density=True)
    h2, _ = np.histogram(gen_tot, bins=binning, density=True)
    seps["Etot"] = float(separation_power(h2, h1, binning))

    ref_ratio = ref_tot / ref_e.reshape(-1)
    gen_ratio = gen_tot / gen_e.reshape(-1)
    lo = min(np.quantile(ref_ratio, 0.001), np.quantile(gen_ratio, 0.001))
    hi = max(np.quantile(ref_ratio, 0.999), np.quantile(gen_ratio, 0.999))
    binning = np.linspace(lo, hi, 30)
    h1, _ = np.histogram(ref_ratio, bins=binning, density=True)
    h2, _ = np.histogram(gen_ratio, bins=binning, density=True)
    seps["ERatio"] = float(separation_power(h2, h1, binning))

    if nlayer_axis:
        ref_l = ref.reshape(ref.shape[0], nlayer_axis, -1).sum(-1)
        gen_l = gen.reshape(gen.shape[0], nlayer_axis, -1).sum(-1)
        ref_frac = (ref_l / np.maximum(ref_l.sum(1, keepdims=True), 1e-8)).mean(0)
        gen_frac = (gen_l / np.maximum(gen_l.sum(1, keepdims=True), 1e-8)).mean(0)
        seps["layer_profile_L1"] = float(np.abs(ref_frac - gen_frac).sum())

    f_ref = shower_feature_matrix(ref, ref_e, nlayer_axis, include_occupancy)
    f_gen = shower_feature_matrix(gen, gen_e, nlayer_axis, include_occupancy)
    try:
        seps.update(fidelity_metrics(
            ref, ref_e, gen, gen_e, nlayers=nlayer_axis,
            include_occupancy=include_occupancy, features=(f_ref, f_gen), device=device,
        ))
    except FDPCalculationError as err:  # the report survives a singular covariance
        METRIC_FAILURES.append(f"classifier/FPD metrics failed: {err}")
        print(METRIC_FAILURES[-1], flush=True)

    if seps.get("classifier_auc", 0.0) > 0.7:
        feature_deltas(f_ref, f_gen, include_occupancy=include_occupancy)
    return seps


def feature_deltas(f_ref, f_gen, top=8, include_occupancy=True):
    """Which high-level features carry a difference the classifier sees:
    each feature's standardised mean shift and its spread ratio."""
    from calodiffusion_tpu_torch.evaluation.evaluate import feature_names

    names = feature_names(f_ref.shape[1], include_occupancy)
    mu_r, mu_g = f_ref.mean(0), f_gen.mean(0)
    sd_r = np.maximum(f_ref.std(0), 1e-12)
    sd_g = np.maximum(f_gen.std(0), 1e-12)
    shift = np.abs(mu_g - mu_r) / sd_r
    order = np.argsort(-shift)[:top]
    print("feature deltas (|Δmean|/σ_ref, σ_gen/σ_ref):", flush=True)
    for i in order:
        print(f"  {names[i]:16s} shift={shift[i]:8.3f} "
              f"sd_ratio={sd_g[i]/sd_r[i]:6.3f} "
              f"(ref {mu_r[i]:.4g}±{sd_r[i]:.3g} "
              f"gen {mu_g[i]:.4g}±{sd_g[i]:.3g})", flush=True)


def gate(seps: dict, pfx: str = "") -> bool:
    """The JAX script's gate: the histogram separations, and the classifier
    AUC (CaloChallenge convention: < ~0.7 good) and FPD where recorded."""
    ok = all(seps[pfx + k] < THRESH[k] for k in HIST_KEYS)
    if f"{pfx}classifier_auc" in seps:
        ok = ok and seps[f"{pfx}classifier_auc"] <= AUC_MAX
    if f"{pfx}fpd" in seps:
        ok = ok and seps[f"{pfx}fpd"] <= FPD_MAX
    return bool(ok)


def expected_keys(family: str, opts) -> list:
    """The separations a run of ``family`` with ``opts``' flags writes
    (each under ``<family>_`` in the report): each prefix's histogram terms,
    the profile where the family has layers, and the sharp instruments,
    which a prefix lacks only where its FPD failed (``METRIC_FAILURES``)."""
    prefixes = [""] + [p for flag, (p, fams) in FLAG_PREFIXES.items()
                       if getattr(opts, flag) and family in fams]
    keys = HIST_KEYS + (("layer_profile_L1",) if LAYER_AXIS[family] else ()) + SHARP_KEYS
    return [p + k for p in prefixes for k in keys]


def sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def generator(device):
    import torch

    return torch.Generator(device=device).manual_seed(0)


def run_family(tag, cfg, tmp, opts, eval_file, energy_key, emin=0.0, sparse=False,
               eval_batch=None):
    """Train and generate one family (the JAX script's ``run_family``).
    ``emin`` > 0 applies the inference CLI's ``--energy-min`` mask
    (``apply_mask_conserveE``, in the metric's units) to the generated
    showers (HGCal, whose ReverseNorm never cuts); ``sparse`` generates with
    GLaM sparse decoding; ``eval_batch`` overrides the loader's batch for
    generation only.  Returns (ref, ref_e, gen, gen_e, gen_q, gen_rt,
    walls)."""
    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.evaluation.metrics_utils import apply_mask_conserveE
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    dev = opts.device

    def eval_loader():
        extra = {"batch_size": eval_batch} if eval_batch else {}
        return load_data(default_flags(data_folder=tmp + "/", **extra), cfg, eval=True,
                         device=dev)[0]

    def generate(**kw):
        t0 = time.perf_counter()
        out = model.generate(eval_loader(), opts.sample_steps, generator=generator(dev),
                             sparse_decoding=sparse, rng=np.random.default_rng(0), **kw)
        sync(dev)
        return out, time.perf_counter() - t0

    flags = default_flags(data_folder=tmp + "/", checkpoint_folder=tmp + "/ckpt",
                          seed=opts.seed, load=opts.resume)
    trainer = TrainDiffusion(flags, cfg, device=dev)
    t0 = time.perf_counter()
    model = trainer.train()
    # SWA tail average if --swa, else EMA if on, else the final weights
    model.load_state_dict(trainer.inference_weights())
    sync(dev)
    walls = {"train_s": time.perf_counter() - t0}
    print(f"[{tag}] trained {cfg['MAXEPOCH']} epochs in {walls['train_s']:.0f}s", flush=True)

    (gen, gen_e), walls["generate_s"] = generate()
    print(f"[{tag}] generated {len(gen)} in {walls['generate_s']:.0f}s", flush=True)

    gen_q = None
    if opts.int8:  # the same weights, W8A8 int8 sampling
        model.config["QUANT_INT8"] = True
        if model.int8_sampling_enabled():
            model._int8_scales = None  # generate calibrates on the first batch
            (gen_q, _), walls["int8_generate_s"] = generate()
            print(f"[{tag}] int8 generated in {walls['int8_generate_s']:.0f}s", flush=True)
        else:
            print(f"[{tag}] int8 requested but not allowed (CALODIFF_INT8=0)", flush=True)
        model.config["QUANT_INT8"] = False

    gen_rt = None
    if opts.roundtrip:
        # the embedding's ceiling: the eval showers through encode -> decode
        # and the inverse preprocessing, a perfect model behind this embed
        (gen_rt, _), walls["roundtrip_s"] = generate(roundtrip=True)
        print(f"[{tag}] embed roundtrip in {walls['roundtrip_s']:.0f}s", flush=True)

    if emin > 0.0:
        gen = apply_mask_conserveE(gen, gen < emin)
        if gen_q is not None:
            gen_q = apply_mask_conserveE(gen_q, gen_q < emin)
        if gen_rt is not None:
            gen_rt = apply_mask_conserveE(gen_rt, gen_rt < emin)

    # generate() returns loader-unit (raw x SHOWERSCALE) showers and
    # physical energies; the Geant reference in the same units
    scale = cfg.get("SHOWERSCALE", 200.0)
    with np.load(os.path.join(tmp, f"{eval_file}.raw.npz")) as f:
        ref = f["showers"].astype(np.float32) * scale
        if energy_key == "gen_info":
            ref_e = f["energies"][:, 0].astype(np.float32)
            gen_e_1d = gen_e[:, 0]
        else:
            ref_e = f["energies"].astype(np.float32) * scale
            gen_e_1d = gen_e.reshape(-1)
    return ref, ref_e, gen, gen_e_1d, gen_q, gen_rt, walls


def score(ref, ref_e, runs, nlayer_axis, include_occupancy, device) -> dict:
    """Separations of each (prefix, showers, energies) of ``runs`` that ran."""
    seps = {}
    for pfx, gen, gen_e in runs:
        if gen is not None:
            seps.update({pfx + k: v for k, v in separations(
                ref, ref_e, gen, gen_e, nlayer_axis, include_occupancy, device).items()})
    return seps


# ---------------------------------------------------------------------------
# HGCal
# ---------------------------------------------------------------------------

def hgcal_geom():
    from calodiffusion_tpu_torch.utils import hgcal_utils

    return hgcal_utils.make_synthetic_geom(nlayers=28, cells_per_ring=9, nrings=20)


def hgcal_showers(geom, n_train, n_eval):
    """{file: (raw showers (n, 28, C), gen_info (n, 3))} and the readout
    threshold, from the JAX script's seed."""
    C = geom.max_ncell
    ring = np.maximum(geom.ring_map, 0.0)  # (28, C)
    valid = geom.ring_map >= 0
    rng = np.random.default_rng(0)
    thr, files = None, {}
    for fname, n in (("hgcal_1.h5", n_train), ("hgcal_2.h5", n_eval)):
        E = rng.uniform(50.0, 100.0, n).astype(np.float32)
        theta = rng.uniform(1.99, 2.01, n).astype(np.float32)
        phi = rng.uniform(1.57, 1.572, n).astype(np.float32)
        gen_info = np.stack([E, theta, phi], axis=1)
        lay = np.arange(28, dtype=np.float32)[None, :, None]
        t_max = (8 + 6 * (np.log10(E) - np.log10(50.0)))[:, None, None]
        prof_z = np.exp(-0.5 * ((lay - t_max) / 5.0) ** 2)
        prof_r = np.exp(-ring[None] / 4.0) * valid[None]
        base = prof_z * prof_r
        showers = base * rng.gamma(2.0, 1.0, (n, 28, C)).astype(np.float32)
        showers *= 0.5 * E[:, None, None] / np.maximum(
            base.sum(axis=(1, 2), keepdims=True), 1e-8
        )
        # readout threshold, raw units: the only source of zeros; applied to
        # the generated showers at evaluation (run_family(emin=...))
        if thr is None:
            thr = float(np.quantile(showers[:, valid], SPARSITY_QUANTILE))
        showers[showers < thr] = 0
        files[fname] = (showers.astype(np.float32), gen_info)
    return files, thr


def hgcal_config(opts, geom_path, C, epochs) -> dict:
    return tiny_ds2_config(
        FILES=["hgcal_1.h5"], VAL_FILES=["hgcal_2.h5"], EVAL=["hgcal_2.h5"],
        HGCAL=True, DATASET_NUM=121, BIN_FILE=geom_path,
        # the production path: data pre-embedded at load, the U-Net in embed
        # space, the GLaM decode with sparse decoding
        SHOWER_EMBED="NN-pre-embed", TRAINABLE_EMBED=False,
        SHAPE_ORIG=[-1, 28, C], SHAPE_PAD=[-1, 1, 28, 12, 21],
        SHAPE_FINAL=[-1, 1, 28, 12, 21], MAX_CELLS=C,
        LAYER_SIZE_UNET=[16, 16, 32, 32], COND_SIZE_UNET=64,
        BLOCK_ATTN=False, MID_ATTN=True, R_Z_INPUT=True, PHI_INPUT=True,
        EMAX=[100, 2.01, 1.572], EMIN=[50, 1.99, 1.57],
        logE=False, MAXDEP=1.0, SHOWERSCALE=200.0, ECUT=0.0,
        BATCH=64, MAXEPOCH=epochs, NSTEPS=400, PRECISION="bf16",
        CHECKPOINT_NAME="fidelity_hgcal", **swa_overrides(opts),
    )


def hgcal_family(epochs, opts):
    from calodiffusion_tpu_torch.utils import hgcal_utils

    tmp = workdir(opts, "hgcal")
    geom = hgcal_geom()
    geom_path = os.path.join(tmp, "geom.pkl")
    hgcal_utils.save_geom(geom, geom_path)
    cfg = hgcal_config(opts, geom_path, geom.max_ncell, epochs)
    files, thr = hgcal_showers(geom, opts.events or TRAIN_EVENTS["hgcal"], opts.eval_events)
    if not have_files(tmp, cache_names(files, "hgcal_2.h5")):
        write_caches(tmp, files, cfg, "hgcal_2.h5", opts.device)
    del files
    ref, ref_e, gen, gen_e, gen_q, gen_rt, walls = run_family(
        "hgcal", cfg, tmp, opts, "hgcal_2.h5", "gen_info",
        emin=thr * 200.0,  # metric units = raw x SHOWERSCALE
        sparse=True,
    )
    # embedded-decode family: occupancy features excluded
    seps = score(ref, ref_e, [("", gen, gen_e), ("int8_", gen_q, gen_e)], LAYER_AXIS["hgcal"],
                 False, opts.device)
    # the embedding's fidelity ceiling (--roundtrip)
    seps.update(score(ref, ref_e, [("ceiling_", gen_rt, ref_e)], LAYER_AXIS["hgcal"], False,
                      opts.device))
    return seps, walls


# ---------------------------------------------------------------------------
# dataset 1
# ---------------------------------------------------------------------------

def ds1_binning_xml(particle: str) -> str:
    return (f'<Bins>\n<Particle name="{particle}">\n'
            + "".join(f'  <Bin id="{bid}" r_edges="' + ",".join(str(i) for i in edges)
                      + f'" n_bin_alpha="{nalpha}"/>\n'
                      for bid, edges, nalpha in DS1_GEOMS[particle])
            + "</Particle>\n</Bins>\n")


def ds1_names(particle: str):
    return f"dataset_1_{particle}s_1.hdf5", f"dataset_1_{particle}s_2.hdf5"


def ds1_showers(particle, xml, n_train, n_eval):
    """{file: (raw showers (n, voxels), incident energies (n, 1))} and the
    readout threshold, from the JAX script's seed."""
    from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

    bins = XMLHandler(particle, xml)
    total = bins.GetTotalNumberOfBins()
    rng = np.random.default_rng(1)
    thr, files = None, {}
    lay_sizes = np.diff(np.asarray(bins.GetBinEdges()))
    for fname, n in zip(ds1_names(particle), (n_train, n_eval)):
        # raw MeV, so that x SHOWERSCALE (0.001) lands in [EMIN, EMAX] GeV
        E = (256.0 * (4194304.0 / 256.0) ** rng.uniform(0, 1, (n, 1))).astype(np.float32)
        voxels = []
        t_max = 1.0 + 1.5 * np.log10(E / 256.0) / 4.2  # (n, 1)
        for lay_i, size in enumerate(lay_sizes):
            prof_z = np.exp(-0.5 * ((lay_i - t_max) / 1.2) ** 2)  # (n, 1)
            r_frac = np.linspace(0, 1, int(size), endpoint=False)[None, :]
            prof_r = np.exp(-3.0 * r_frac)
            voxels.append(prof_z * prof_r)
        base = np.concatenate(voxels, axis=1)  # (n, total)
        showers = base * rng.gamma(2.0, 1.0, (n, total)).astype(np.float32)
        showers *= 0.4 * E / np.maximum(base.sum(1, keepdims=True), 1e-8)
        # readout threshold: the only source of zeros; ReverseNorm applies
        # the same cut to the generated showers through ECUT
        if thr is None:
            thr = float(np.quantile(showers, SPARSITY_QUANTILE))
        showers[showers < thr] = 0
        files[fname] = (showers.astype(np.float32), E)
    return files, thr


def ds1_config(opts, particle, xml, thr, epochs) -> dict:
    from calodiffusion_tpu_torch.utils.geom import GeomConverter
    from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

    tag = "ds1" if particle == "photon" else "ds1pion"
    bins = XMLHandler(particle, xml)
    f_train, f_eval = ds1_names(particle)
    return tiny_ds2_config(
        FILES=[f_train], VAL_FILES=[f_eval], EVAL=[f_eval],
        DATASET_NUM=1 if particle == "photon" else 0, BIN_FILE=xml, PART_TYPE=particle,
        SHOWER_EMBED="orig-NN",
        SHAPE_ORIG=[-1, bins.GetTotalNumberOfBins()],
        SHAPE_PAD=[-1, 1, bins.GetTotalNumberOfBins()],
        SHAPE_FINAL=[-1, 1, len(DS1_GEOMS[particle]), 10, GeomConverter(bins).dim_r_out],
        LAYER_SIZE_UNET=[16, 16, 32, 32], COND_SIZE_UNET=64,
        BLOCK_ATTN=False, MID_ATTN=True, R_Z_INPUT=False, PHI_INPUT=True,
        EMAX=4194.304, EMIN=0.256, MAXDEP=3.1,
        ECUT=thr * 1e-3,  # GeV, in-pipeline through ReverseNorm
        SHOWERSCALE=0.001,
        BATCH=128, MAXEPOCH=epochs, NSTEPS=400, PRECISION="bf16",
        # EMA off: at ~2400 steps EMA 0.999 regressed (AUC 0.81 -> 0.94, JAX)
        CHECKPOINT_NAME=f"fidelity_{tag}", **swa_overrides(opts),
    )


def ds1_family(epochs, opts, particle="photon"):
    tag = "ds1" if particle == "photon" else "ds1pion"
    tmp = workdir(opts, tag)
    xml = os.path.join(tmp, "binning.xml")
    with open(xml, "w") as f:
        f.write(ds1_binning_xml(particle))
    files, thr = ds1_showers(particle, xml, opts.events or TRAIN_EVENTS[tag], opts.eval_events)
    cfg = ds1_config(opts, particle, xml, thr, epochs)
    f_eval = ds1_names(particle)[1]
    if not have_files(tmp, cache_names(files, f_eval)):
        write_caches(tmp, files, cfg, f_eval)
    del files
    ref, ref_e, gen, gen_e, gen_q, gen_rt, walls = run_family(
        tag, cfg, tmp, opts, f_eval, "incident_energies")
    # the NN decode's rank limit, as GLaM's: occupancy features excluded
    seps = score(ref, ref_e, [("", gen, gen_e), ("int8_", gen_q, gen_e),
                              ("ceiling_", gen_rt, ref_e)], LAYER_AXIS[tag], False,
                 opts.device)
    return seps, walls


# ---------------------------------------------------------------------------
# dataset 3
# ---------------------------------------------------------------------------

DS3_FILES = ("dataset_3_1.hdf5", "dataset_3_2.hdf5")


def ds3_showers(n_train, n_eval, only=None):
    """{file: (raw showers (n, 40500), incident energies (n, 1))} from the
    JAX script's seed, the zeros the shipped ECUT (0.0151 raw MeV); drawn in
    chunks of 2048 events.  ``only`` keeps one file's arrays (the other is
    drawn and dropped, since the files share the stream)."""
    rng = np.random.default_rng(3)
    ecut_raw_mev = 1.51e-2
    z = np.arange(45, dtype=np.float32)[None, :, None, None]
    r = np.arange(18, dtype=np.float32)[None, None, None, :]
    files = {}
    for fname, n in zip(DS3_FILES, (n_train, n_eval)):
        keep = only is None or fname == only
        showers = np.empty((n if keep else 0, 45 * 50 * 18), dtype=np.float32)
        e_inc = 10 ** rng.uniform(3, 6, (n, 1)).astype(np.float32)  # MeV
        for lo in range(0, n, 2048):
            hi = min(lo + 2048, n)
            e = e_inc[lo:hi]
            t_max = (8 + 3 * (np.log10(e) - 3))[:, :, None, None]
            prof_z = np.exp(-0.5 * ((z - t_max) / 6.0) ** 2)
            prof_r = np.exp(-r / 3.0)
            base = (prof_z * prof_r / 50.0).astype(np.float32)
            s = base * rng.gamma(2.0, 1.0, (hi - lo, 45, 50, 18)).astype(np.float32)
            s *= 0.5 * e[:, :, None, None] / base.sum(axis=(1, 2, 3), keepdims=True)
            s[s < ecut_raw_mev] = 0
            if keep:
                showers[lo:hi] = s.reshape(hi - lo, -1)
        if keep:
            files[fname] = (showers, e_inc)
    return files


def ds3_config(opts, epochs) -> dict:
    return tiny_ds2_config(
        FILES=["dataset_3_1.hdf5"], VAL_FILES=["dataset_3_2.hdf5"], EVAL=["dataset_3_2.hdf5"],
        DATASET_NUM=3, SHAPE_ORIG=[-1, 40500],
        SHAPE_PAD=[-1, 1, 45, 50, 18], SHAPE_FINAL=[-1, 1, 45, 50, 18],
        # the shipped ds3 network: thinner than ds2, Z-compressed
        LAYER_SIZE_UNET=[32, 32, 32, 32], COND_SIZE_UNET=128,
        BLOCK_ATTN=True, MID_ATTN=True, COMPRESS_Z=True,
        SHOWERMAP="logit-norm",  # no layer factorisation (shipped config)
        TIME_EMBED="sigma", NOISE_SCHED="cosine", R_Z_INPUT=True,
        EMAX=1000.0, EMIN=1.0, logE=True, MAXDEP=2, ECUT=1.51e-5, SHOWERSCALE=0.001,
        BATCH=64, MAXEPOCH=epochs, NSTEPS=400, PRECISION="bf16",
        # the JAX recipe's memory settings: batch 64 in microbatches of 32,
        # the working set streamed each epoch
        TRAIN_MICROBATCH=32, CACHE_DATA_ON_DEVICE=False, EMA_DECAY=0.999,
        CHECKPOINT_NAME="fidelity_ds3", **swa_overrides(opts),
    )


def ds3_family(epochs, opts):
    tmp = workdir(opts, "ds3")
    cfg = ds3_config(opts, epochs)
    if not have_files(tmp, cache_names(DS3_FILES, DS3_FILES[1])):
        files = ds3_showers(opts.events or TRAIN_EVENTS["ds3"], opts.eval_events)
        write_caches(tmp, files, cfg, DS3_FILES[1])
        del files
    ref, ref_e, gen, gen_e, gen_q, _, walls = run_family(
        "ds3", cfg, tmp, opts, DS3_FILES[1], "incident_energies",
        # sampled at the ds3 throughput plateau's batch, trained at 64
        eval_batch=128,
    )
    # the voxel grid itself (no rank-limited decode): occupancy features in
    seps = score(ref, ref_e, [("", gen, gen_e), ("int8_", gen_q, gen_e)], LAYER_AXIS["ds3"],
                 True, opts.device)
    return seps, walls


# ---------------------------------------------------------------------------
# the layer cascade
# ---------------------------------------------------------------------------

LAYER_FILES = ("dataset_2_1.hdf5", "dataset_2_2.hdf5")


def layer_showers(n_train, n_eval):
    """{file: (raw ds2 showers, incident energies)}: ``synth_showers`` with
    each event's total rescaled into the calibrated totalE range and the
    readout threshold applied again, from the JAX script's seed."""
    from calodiffusion_tpu_torch.utils import consts
    from torch_fidelity_check import ECUT_RAW_MEV, synth_showers

    rng = np.random.default_rng(0)
    c = consts.dataset_params[2]
    files = {}
    for fname, n in zip(LAYER_FILES, (n_train, n_eval)):
        showers, e_inc = synth_showers(n, rng)
        # the layer-energy diffusion works in consts-standardised space
        z = np.clip(rng.standard_normal((n, 1)), -3, 3)
        target = 2.0 * e_inc * (c["totalE_mean"] + c["totalE_std"] * z)
        cur = showers.sum(axis=1, keepdims=True)
        showers = showers * (target / np.maximum(cur, 1e-8))
        showers[showers < ECUT_RAW_MEV] = 0
        files[fname] = (showers.astype(np.float32), e_inc)
    return files


def layer_config(opts, epochs) -> dict:
    return tiny_ds2_config(
        VAL_FILES=["dataset_2_2.hdf5"], EVAL=["dataset_2_2.hdf5"],
        BATCH=128, MAXEPOCH=epochs, NSTEPS=400, LAYER_STEPS=opts.sample_steps,
        LAYER_SIZE_UNET=[32, 32, 64, 32], COND_SIZE_UNET=128,
        BLOCK_ATTN=True, MID_ATTN=True, PRECISION="bf16",
        # 200+ epochs with EMA average the late-training weight noise out
        EMA_DECAY=0.999,
        # int8 fence: the down path stays bf16 (docs/INT8_CASCADE.md)
        QUANT_INT8_EXCLUDE=list(CASCADE_INT8_EXCLUDE),
        CHECKPOINT_NAME="fidelity_cascade", **swa_overrides(opts),
    )


def stage1_epochs(epochs, n_train, opts) -> int:
    """Stage 1 (the 46-dim layer-energy ResNet) trains to at least ~25k
    optimizer steps: the floor in epochs keeps the step count as the corpus
    (``--events``) scales.  ``--stage1-epochs`` overrides it."""
    if opts.stage1_epochs is not None:
        return opts.stage1_epochs
    return max(epochs * 2, max(1, round(400 * 8192 / n_train)))


def layer_family(epochs, opts):
    """The two-stage cascade: base U-Net and layer model trained on synthetic
    ds2, layer energies from stage 1 and showers from stage 2, through the
    composite loading path."""
    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    dev = opts.device
    n_train = opts.events or TRAIN_EVENTS["layer"]
    tmp = workdir(opts, "layer")
    cfg = layer_config(opts, epochs)
    if not have_files(tmp, cache_names(LAYER_FILES, LAYER_FILES[1])):
        files = layer_showers(n_train, opts.eval_events)
        write_caches(tmp, files, cfg, LAYER_FILES[1])
        del files
    data = tmp + "/"
    walls = {}

    t0 = time.perf_counter()
    base_trainer = TrainDiffusion(
        default_flags(data_folder=data, checkpoint_folder=tmp + "/ckpt", seed=opts.seed,
                      load=opts.resume), dict(cfg), device=dev)
    base_trainer.train()
    sync(dev)
    walls["train_s"] = time.perf_counter() - t0
    print(f"[layer] base model trained in {walls['train_s']:.0f}s", flush=True)

    t0 = time.perf_counter()
    layer_trainer = TrainLayerModel(
        default_flags(data_folder=data, checkpoint_folder=tmp + "/ckpt_layer", seed=opts.seed,
                      load=opts.resume),
        dict(cfg, MAXEPOCH=stage1_epochs(epochs, n_train, opts)), device=dev)
    layer_trainer.train()
    sync(dev)
    walls["stage1_train_s"] = time.perf_counter() - t0
    print(f"[layer] layer model trained in {walls['stage1_train_s']:.0f}s", flush=True)

    # two-stage inference through the composite loading path
    inf_cfg = dict(cfg, layer_model=os.path.join(layer_trainer.checkpoint_folder, "final.ckpt"))
    inf = TrainLayerModel(
        default_flags(data_folder=data,
                      model_loc=os.path.join(base_trainer.checkpoint_folder, "final.ckpt")),
        inf_cfg, load_data=False, save_model=False, inference=True, device=dev)
    model = inf.load_for_inference()

    def generate(key, **kw):
        loader, _ = load_data(default_flags(data_folder=data), inf_cfg, eval=True, device=dev)
        t0 = time.perf_counter()
        out = model.generate(loader, opts.sample_steps, generator=generator(dev), **kw)
        sync(dev)
        walls[key] = time.perf_counter() - t0
        return out

    gen, gen_e = generate("generate_s")
    gen_o = None
    if opts.oracle:
        # stage 2 on the true layer energies: the gap to the cascade's
        # metrics is stage 1's sampled-vector quality
        gen_o, _ = generate("oracle_generate_s", oracle_layers=True)
    gen_q = None
    if opts.int8:  # int8 through the two-stage cascade
        model.config["QUANT_INT8"] = True
        if model.int8_sampling_enabled():
            model._int8_scales = None
            gen_q, _ = generate("int8_generate_s")
        model.config["QUANT_INT8"] = False

    with np.load(os.path.join(tmp, f"{LAYER_FILES[1]}.raw.npz")) as f:
        ref = f["showers"].astype(np.float32) * 0.001
        ref_e = f["energies"].astype(np.float32) * 0.001
    gen_e = gen_e.reshape(-1)
    seps = score(ref, ref_e, [("", gen, gen_e), ("oracle_", gen_o, gen_e),
                              ("int8_", gen_q, gen_e)], LAYER_AXIS["layer"], True, dev)
    dump = {"ref": ref, "ref_e": ref_e, "gen": gen, "gen_e": gen_e}
    if gen_o is not None:
        dump["gen_oracle"] = gen_o
    if gen_q is not None:
        dump["gen_int8"] = gen_q
    path = os.path.join(tmp, "fidelity_layer_arrays.npz")
    np.savez_compressed(path, **dump)
    print(f"[layer] dumped eval arrays to {path}", flush=True)
    return seps, walls


RUNNERS = {"hgcal": hgcal_family, "ds1": ds1_family,
           "ds1pion": lambda e, o: ds1_family(e, o, particle="pion"),
           "layer": layer_family, "ds3": ds3_family}


def update_report(report: dict, fam: str, seps: dict, extra: dict = None) -> dict:
    """Supersede the family's whole entry with this run's separations and
    gates (a key of an older run with other flags must not linger); the
    ds2 key "layer_profile_L1" is not a family key.  ``extra`` (walls, the
    card) goes in under the family's prefix too."""
    for k in [k for k in report if k.startswith(fam + "_") and k != "layer_profile_L1"]:
        del report[k]
    for k, v in seps.items():
        print(f"[{fam}] separation[{k}] = {v:.4f}", flush=True)
        report[f"{fam}_{k}"] = v
    report[f"{fam}_ok"] = gate(seps)
    if "int8_Etot" in seps:
        report[f"{fam}_int8_ok"] = gate(seps, "int8_")
    report.update({f"{fam}_{k}": v for k, v in (extra or {}).items()})
    print(f"[{fam}] FIDELITY", "OK" if report[f"{fam}_ok"] else "NEEDS MORE TRAINING",
          flush=True)
    return report


def card_line(device) -> str:
    if str(device) == "cpu":
        return "CPU"
    from torch_fidelity_check import card_line as smi

    return smi()


def check_device(device) -> None:
    import torch

    if str(device) != "cpu" and not torch.cuda.is_available():
        sys.exit("no CUDA card here: pass --device cpu to run on the CPU")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*", help="[epochs] [family ...] (families: "
                                            + ", ".join(FAMILIES) + "; default hgcal ds1)")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--roundtrip", action="store_true")
    ap.add_argument("--swa", action="store_true")
    ap.add_argument("--events", type=int, default=None, help="train events")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=str(REPORT))
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    ap.add_argument("--eval-events", type=int, default=EVAL_EVENTS)
    ap.add_argument("--sample-steps", type=int, default=400)
    ap.add_argument("--stage1-epochs", type=int, default=None)
    return ap


def parse(argv=None):
    opts = parser().parse_args(argv)
    pos = list(opts.args)
    opts.epochs = int(pos.pop(0)) if pos and pos[0].isdigit() else None
    opts.families = pos or ["hgcal", "ds1"]
    unknown = [f for f in opts.families if f not in RUNNERS]
    if unknown:  # fail before hours of training, not after
        raise SystemExit(f"unknown families {unknown}; known: {sorted(RUNNERS)}")
    if Path(opts.out).resolve() == (ROOT / "fidelity_report.json").resolve():
        raise SystemExit("--out: fidelity_report.json is the JAX package's report")
    return opts


def main(argv=None):
    opts = parse(argv)
    check_device(opts.device)
    card = card_line(opts.device)
    print(card, flush=True)
    out = Path(opts.out)
    report = json.loads(out.read_text()) if out.exists() else {}
    for fam in opts.families:
        epochs = opts.epochs or DEFAULT_EPOCHS[fam]
        t0 = time.perf_counter()
        seps, walls = RUNNERS[fam](epochs, opts)
        walls["wall_s"] = time.perf_counter() - t0
        update_report(report, fam, seps, dict(walls, epochs=epochs, seed=opts.seed, card=card))
        # after every family: a crash in the next must not lose this one
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
