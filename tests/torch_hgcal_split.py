"""HGCal sampling from trained weights, the port against the JAX package on
the CPU: the split of ``scripts/torch_fidelity_families.py hgcal``'s
departure between sampling and training.

    JAX_PLATFORMS=cpu python tests/torch_hgcal_split.py --checkpoint W.pt
        [--events 256] [--steps 400] [--threads 4] [--out FILE]

``--checkpoint``: the weights the harness sampled from, as a ``state_dict``
of the port (``TrainDiffusion.inference_weights()`` saved with
``torch.save``) or a trainer checkpoint (``final.ckpt``; its SWA, EMA or raw
weights, as ``load_for_inference`` picks).  Both packages take those weights
(JAX through ``calodiffusion_tpu/tools/torch_import.torch_state_dict_to_params``),
the harness's geometry and config in f32 (the harness samples in bf16; f32
holds the two packages to each other elementwise, where bf16 would hold
them only in distribution), the
conditioning (E, layer energies) of the first ``--events`` events of the
harness's eval set (its shower law, seed 0, the train set drawn first in
chunks, the readout threshold from the whole train set), one seeded start
noise, ``--steps``-step DDim in batches of the config's 64, then each
package's ``reverse_norm_hgcal`` with sparse decoding from one numpy
Generator (as ``generate`` calls it) and the ``--energy-min`` mask at the
threshold (``apply_mask_conserveE``).  Reported (and written to ``--out``):
the max differences of the DDim outputs, of layers 24-27's energies before
the mask, of every cell, and after the mask each package's and Geant's
layer 24-27 energies (log10 mean and spread), share of events whose layer
was masked away, lit cells a layer, and the cells whose occupancy the two
packages disagree on.

It imports both packages, so it lives beside the tests and never under
``scripts/``; nothing here runs on the card.  At 256 events and 400 steps
the port's sampling takes about 25 min and JAX's an hour on eight shared
CPU cores, and drawing the train set's threshold holds 3 GB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (ROOT, os.path.join(ROOT, "scripts")):
    if path not in sys.path:
        sys.path.insert(0, path)

DEEP = slice(24, 28)
N_TRAIN, N_EVAL = 6144, 1536  # the harness's recipe
CHUNK = 256  # train showers drawn at a time


def harness_eval_set(geom, events, n_train=None, n_eval=None):
    """The first ``events`` showers and gen_info of the harness's eval file
    and its readout threshold, drawn as ``torch_fidelity_families.hgcal_showers``
    draws them (the same stream, bit for bit) with the train showers made
    ``CHUNK`` at a time: the threshold is the ``SPARSITY_QUANTILE`` of all
    valid train cells (float64, as there)."""
    import torch_fidelity_families as tfam

    n_train, n_eval = n_train or N_TRAIN, n_eval or N_EVAL
    C = geom.max_ncell
    ring = np.maximum(geom.ring_map, 0.0)
    valid = geom.ring_map >= 0
    rng = np.random.default_rng(0)
    lay = np.arange(28, dtype=np.float32)[None, :, None]
    prof_r = np.exp(-ring[None] / 4.0) * valid[None]

    def draw_info(n):
        E = rng.uniform(50.0, 100.0, n).astype(np.float32)
        theta = rng.uniform(1.99, 2.01, n).astype(np.float32)
        phi = rng.uniform(1.57, 1.572, n).astype(np.float32)
        return np.stack([E, theta, phi], axis=1)

    def draw_showers(E):
        t_max = (8 + 6 * (np.log10(E) - np.log10(50.0)))[:, None, None]
        base = np.exp(-0.5 * ((lay - t_max) / 5.0) ** 2) * prof_r
        showers = base * rng.gamma(2.0, 1.0, (len(E), 28, C)).astype(np.float32)
        showers *= 0.5 * E[:, None, None] / np.maximum(base.sum(axis=(1, 2), keepdims=True),
                                                        1e-8)
        return showers

    info = draw_info(n_train)
    cells = np.empty((n_train, int(valid.sum())), dtype=np.float64)
    for lo in range(0, n_train, CHUNK):
        cells[lo:lo + CHUNK] = draw_showers(info[lo:lo + CHUNK, 0])[:, valid]
    thr = float(np.quantile(cells, tfam.SPARSITY_QUANTILE, overwrite_input=True))
    del cells
    info = draw_info(n_eval)[:events]
    showers = draw_showers(info[:, 0])
    showers[showers < thr] = 0
    return showers.astype(np.float32), info, thr


def load_weights(path):
    """A ``state_dict`` of the port from ``path``: a saved state_dict, or a
    trainer checkpoint's inference weights."""
    import torch

    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "params" in obj:
        folder, name = os.path.split(os.path.splitext(os.path.abspath(path))[0])
        arrays, host = ckpt_io.load_checkpoint(folder, name, map_location="cpu")
        obj = ckpt_io.inference_params(arrays, host)
    return {k: v.float() if v.is_floating_point() else v for k, v in obj.items()}


def deep_stats(cells, emin):
    """Layers 24-27 of (n, 28, C) showers after the mask: log10 energy mean
    and spread, the share of events with the layer empty, lit cells a layer."""
    e = cells[:, DEEP].sum(-1)
    lit = (cells[:, DEEP] >= emin).sum(-1)
    log_e = np.log10(e + 1e-8)
    return {f"layer{24 + i}": dict(log10E_mean=float(log_e[:, i].mean()),
                                   log10E_std=float(log_e[:, i].std()),
                                   empty_share=float((e[:, i] <= 0).mean()),
                                   lit_cells_mean=float(lit[:, i].mean()))
            for i in range(4)}


def run(opts) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke
    import torch_fidelity_families as tfam
    from calodiffusion_tpu.evaluation import metrics_utils as jmetrics
    from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
    from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
    from calodiffusion_tpu.tools.torch_import import torch_state_dict_to_params
    from calodiffusion_tpu.utils import hgcal_utils as jh
    from calodiffusion_tpu_torch.evaluation import metrics_utils as tmetrics
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.samplers import get_sampler
    from calodiffusion_tpu_torch.utils import hgcal_utils as th

    torch.set_num_threads(opts.threads)
    tmp = tempfile.mkdtemp(prefix="hgcal_split_")
    geom = th.make_synthetic_geom(nlayers=28, cells_per_ring=9, nrings=20)
    geom_path = os.path.join(tmp, "geom.pkl")
    th.save_geom(geom, geom_path)
    cfg = dict(tfam.hgcal_config(tfam.parse(["hgcal", "--device", "cpu"]), geom_path,
                                 geom.max_ncell, tfam.DEFAULT_EPOCHS["hgcal"]),
               PRECISION="f32")

    t0 = time.perf_counter()
    showers, gen_info, thr = harness_eval_set(geom, opts.events)
    conv = th.make_pre_embed_converter(cfg, device="cpu")
    chip_smoke.write_hgcal_cache(os.path.join(tmp, "eval.npz"), [(showers, gen_info)], cfg,
                                 conv, device="cpu")
    with np.load(os.path.join(tmp, "eval.npz")) as f:
        E, layers = f["E"].astype(np.float32), f["layers"].astype(np.float32)
    print(f"eval set: {opts.events} events, threshold {thr!r} raw, "
          f"{time.perf_counter() - t0:.0f} s", flush=True)

    sd = load_weights(opts.checkpoint)
    tm = CaloDiffusion(dict(cfg), n_steps=cfg["NSTEPS"], device="cpu")
    tm.load_state_dict(sd)
    jm = JaxModel(dict(cfg), n_steps=cfg["NSTEPS"])
    params = torch_state_dict_to_params({k: v.numpy() for k, v in sd.items()}, jm,
                                        jax.jit(jm.init)(jax.random.PRNGKey(0)))
    start = np.random.default_rng(0).standard_normal(
        (opts.events, 1, *cfg["SHAPE_FINAL"][2:])).astype(np.float32)
    B = cfg["BATCH"]

    t0 = time.perf_counter()
    sampler = get_sampler("DDim")(cfg)
    port = []
    with torch.no_grad():
        for lo in range(0, opts.events, B):
            sl = slice(lo, lo + B)
            port.append(sampler(tm, torch.from_numpy(start[sl]), torch.from_numpy(E[sl]),
                                torch.from_numpy(layers[sl]), opts.steps, 0, None,
                                False).float().numpy())
    port = np.concatenate(port)
    port_s = time.perf_counter() - t0
    print(f"port: {opts.steps}-step DDim of {opts.events} in {port_s:.0f} s", flush=True)

    t0 = time.perf_counter()
    jsampler = jax_get_sampler("DDim")(cfg)
    jitted = jax.jit(lambda p, st, e, lay: jsampler(jm, p, st, e, lay, opts.steps, 0,
                                                    jax.random.PRNGKey(0), False))
    ref = np.concatenate([np.asarray(jitted(params, jnp.asarray(start[lo:lo + B]),
                                            jnp.asarray(E[lo:lo + B]),
                                            jnp.asarray(layers[lo:lo + B])), np.float32)
                          for lo in range(0, opts.events, B)])
    jax_s = time.perf_counter() - t0
    print(f"JAX: {opts.steps}-step DDim of {opts.events} in {jax_s:.0f} s", flush=True)

    # each package's inverse preprocessing, as its generate calls it, the
    # sparse draws from one Generator (JAX's fresh one a batch patched to it)
    kw = dict(shape=cfg["SHAPE_FINAL"], config=cfg, emax=cfg["EMAX"], emin=cfg["EMIN"],
              layerE=layers, logE=cfg["logE"], binning_file=geom_path,
              max_deposit=cfg["MAXDEP"], showerMap=cfg["SHOWERMAP"],
              dataset_num=cfg["DATASET_NUM"], orig_shape=False, ecut=float(cfg["ECUT"]),
              embed=True, sparse_decoding=True)
    cells_t = th.reverse_norm_hgcal(port, E, rng=np.random.default_rng(1), device="cpu",
                                    **kw)[0]
    shared = np.random.default_rng(1)
    real = np.random.default_rng
    np.random.default_rng = lambda *a, **k: shared
    try:
        cells_j = jh.reverse_norm_hgcal(ref, E, **kw)[0]
    finally:
        np.random.default_rng = real
    emin = thr * cfg["SHOWERSCALE"]
    geant = showers * cfg["SHOWERSCALE"]
    masked_t = tmetrics.apply_mask_conserveE(cells_t.copy(), cells_t < emin)
    masked_j = jmetrics.apply_mask_conserveE(cells_j.copy(), cells_j < emin)

    deep_t, deep_j = cells_t[:, DEEP].sum(-1), cells_j[:, DEEP].sum(-1)
    differ = (masked_t[:, DEEP] > 0) != (masked_j[:, DEEP] > 0)
    report = dict(
        checkpoint=os.path.abspath(opts.checkpoint), events=opts.events, steps=opts.steps,
        threshold_raw=thr, emin=emin,
        ddim_max_abs_diff=float(np.abs(port - ref).max()),
        ddim_deep_max_abs_diff=float(np.abs(port - ref)[:, :, DEEP].max()),
        ddim_scale=float(np.abs(ref).max()),
        deep_energy_max_rel_diff_before_mask=float(
            (np.abs(deep_t - deep_j) / np.maximum(deep_j, 1e-30)).max()),
        cell_max_abs_diff=float(np.abs(cells_t - cells_j).max()),
        deep_cells_occupancy_disagree=int(differ.sum()),
        deep_cells_lit=int((masked_j[:, DEEP] > 0).sum()),
        port=deep_stats(masked_t, emin), jax=deep_stats(masked_j, emin),
        geant=deep_stats(geant, emin),
        port_before_mask=deep_stats(cells_t, emin), jax_before_mask=deep_stats(cells_j, emin),
        port_sample_s=port_s, jax_sample_s=jax_s)
    print(json.dumps(report, indent=1), flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None)
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
