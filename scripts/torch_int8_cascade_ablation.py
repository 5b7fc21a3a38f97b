#!/usr/bin/env python3
"""Per-group int8 ablation of the trained layer cascade's stage-2 U-Net, on
calodiffusion_tpu_torch and one CUDA card.

    python3 scripts/torch_int8_cascade_ablation.py [--workdir PATH]
        [--groups coarse|fine] [--events N] [--sample-steps N] [--out FILE]
        [--device cpu]

The port's counterpart of ``scripts/tpu_int8_cascade_ablation.py``: from the
same trained cascade (a finished ``torch_fidelity_families.py layer`` run:
``PATH/ckpt/*/final.ckpt`` and ``PATH/ckpt_layer/*/final.ckpt``, the eval
caches and the raw eval showers), the eval set is generated with 400-step
DDim in both stages once a row, the rows differing only in which stage-2
convolutions run W8A8 int8: ``bf16`` (none), ``int8_full`` (the table
calibrated once on the first batch, E twice over and [its layers, a stage-1
sample], 32 rows each; ``QUANT_INT8_EXCLUDE`` of the run's config applies
there, as in the JAX package), ``w8a16_all`` (int8 weights, float
activations), then for each group of ``conv_groups`` (``--groups coarse``:
down, mid, up, final_block; ``fine``: each level) ``excl_<group>`` (the
group float) and ``only_<group>`` (the group alone int8).  Each row gets
``torch_fidelity_families.separations`` against the Geant showers, the first
``--events`` of each where given.  The report ``--out`` (default
``PATH/int8_cascade_ablation.json``), the JAX script's JSON ``{row:
{separation: value}}``, is written after every row; the JAX script's
``docs/INT8_CASCADE.md`` is not.

``--workdir`` defaults to the newest ``fid_layer_*`` folder with a trained
base under the temporary directory, as the JAX script's does under /tmp.
``--sample-steps`` cuts a run (``chip_smoke.py`` phase 19).  The script runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_fidelity_families as fam  # noqa: E402

SAMPLE_STEPS = 400
CALIBRATION_ROWS = 32


def find_workdir(path=None) -> str:
    if path:
        return os.path.abspath(path)
    cands = sorted(glob.glob(os.path.join(tempfile.gettempdir(), "fid_layer_*")),
                   key=os.path.getmtime, reverse=True)
    for c in cands:
        if glob.glob(os.path.join(c, "ckpt", "*", "final.ckpt")):
            return c
    raise SystemExit("no finished fid_layer_* workdir found; run "
                     "scripts/torch_fidelity_families.py layer first, or pass --workdir")


def conv_groups(table, n_res, mode="coarse"):
    """Partition the calibrated scale table's conv paths into named groups
    (JAX ``conv_groups``).  U-Net numbering (flax occurrence order):
    ResnetBlock_{0..2R-1} the down path, {2R, 2R+1} the mid, {2R+2..4R+1}
    the up path, {4R+2} the final block; CondUnet_0/Conv3d_{0..R-2} the
    downsampling convs."""
    down_end = 2 * n_res
    up_start = 2 * n_res + 2

    def which(path):
        m = re.search(r"ResnetBlock_(\d+)", path)
        if m:
            i = int(m.group(1))
            if i < down_end:
                return ("down", f"down{i // 2}")
            if i < up_start:
                return ("mid", "mid")
            if i < up_start + 2 * n_res:
                return ("up", f"up{(i - up_start) // 2}")
            return ("final_block", "final_block")
        m = re.search(r"CondUnet_\d+/Conv3d_(\d+)$", path)
        if m:  # the strided downsampling conv after level int(m.group(1))
            return ("down", f"downsample{m.group(1)}")
        return ("other", "other")

    groups = {}
    for path in table:
        coarse, fine = which(path)
        groups.setdefault(coarse if mode == "coarse" else fine, []).append(path)
    return groups


def ablation_rows(full_table, groups) -> dict:
    """{row tag: scale table (None: float)} in the JAX script's order."""
    from calodiffusion_tpu_torch.ops import quant

    rows = {"bf16": None, "int8_full": dict(full_table),
            "w8a16_all": {p: quant.WEIGHT_ONLY for p in full_table}}
    for g in sorted(groups):
        rows[f"excl_{g}"] = {p: v for p, v in full_table.items() if p not in set(groups[g])}
    for g in sorted(groups):
        rows[f"only_{g}"] = {p: v for p, v in full_table.items() if p in set(groups[g])}
    return rows


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--groups", default="coarse", choices=("coarse", "fine"))
    ap.add_argument("--events", type=int, default=None)
    ap.add_argument("--sample-steps", type=int, default=SAMPLE_STEPS)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    fam.check_device(opts.device)
    import torch

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
    from calodiffusion_tpu_torch.utils.config import default_flags

    dev = opts.device
    print(fam.card_line(dev), flush=True)
    tmp = find_workdir(opts.workdir)
    print(f"workdir: {tmp}", flush=True)
    base_ckpt = glob.glob(os.path.join(tmp, "ckpt", "*", "final.ckpt"))[0]
    layer_ckpt = glob.glob(os.path.join(tmp, "ckpt_layer", "*", "final.ckpt"))[0]
    with open(os.path.join(os.path.dirname(base_ckpt), "config.json")) as f:
        cfg = json.load(f)
    inf_cfg = dict(cfg, layer_model=layer_ckpt)
    model = TrainLayerModel(default_flags(data_folder=tmp + "/", model_loc=base_ckpt), inf_cfg,
                            load_data=False, save_model=False, inference=True,
                            device=dev).load_for_inference()
    with np.load(os.path.join(tmp, "dataset_2_2.hdf5.raw.npz")) as f:
        ref = f["showers"].astype(np.float32) * 0.001
        ref_e = f["energies"].astype(np.float32) * 0.001
    if opts.events:
        ref, ref_e = ref[:opts.events], ref_e[:opts.events]

    def eval_loader():
        return load_data(default_flags(data_folder=tmp + "/"), inf_cfg, eval=True, device=dev)[0]

    def gen_and_score(tag, scales):
        """The eval set with the scale table ``scales`` (None: float),
        scored against the Geant showers."""
        model.config["QUANT_INT8"] = scales is not None
        model._int8_scales = scales
        t0 = time.perf_counter()
        gen, gen_e = model.generate(eval_loader(), opts.sample_steps,
                                    generator=torch.Generator(device=dev).manual_seed(0))
        if opts.events:
            gen, gen_e = gen[:opts.events], gen_e[:opts.events]
        seps = fam.separations(ref, ref_e, gen, gen_e.reshape(-1), nlayer_axis=45, device=dev)
        model.config["QUANT_INT8"] = False
        print(f"[{tag}] auc={seps.get('classifier_auc', float('nan')):.3f} "
              f"jsd={seps.get('classifier_jsd', float('nan')):.3f} "
              f"fpd={seps.get('fpd', float('nan')):.3f} Etot={seps['Etot']:.4f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
        return seps

    out = Path(opts.out or os.path.join(tmp, "int8_cascade_ablation.json"))
    out.parent.mkdir(parents=True, exist_ok=True)
    results = {}

    def flush_results():
        # after every row: a cut run keeps what it measured
        out.write_text(json.dumps({k: {kk: float(vv) for kk, vv in v.items()}
                                   for k, v in results.items()}, indent=1))

    results["bf16"] = gen_and_score("bf16", None)
    flush_results()

    # the full table, calibrated once on the real conditioning as generate does
    model.config["QUANT_INT8"] = True
    model._int8_scales = None
    E0, lay0, _ = next(iter(eval_loader()))
    E0 = torch.as_tensor(np.asarray(E0, np.float32), device=dev)
    lay0 = torch.as_tensor(np.asarray(lay0, np.float32), device=dev)
    m = min(CALIBRATION_ROWS, len(E0))
    g = torch.Generator(device=dev).manual_seed(1)
    samp = model.sample_layers(E0[:m], g)
    full_table = model.prepare_int8(E=torch.cat([E0[:m]] * 2), layers=torch.cat([lay0[:m], samp]),
                                    generator=g)
    model.config["QUANT_INT8"] = False
    print(f"calibrated {len(full_table)} convs", flush=True)

    groups = conv_groups(full_table, len(cfg["LAYER_SIZE_UNET"]) - 1, mode=opts.groups)
    print("groups:", {k: len(v) for k, v in groups.items()}, flush=True)
    for tag, scales in ablation_rows(full_table, groups).items():
        if tag != "bf16":
            results[tag] = gen_and_score(tag, scales)
            flush_results()
    print(f"wrote {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
