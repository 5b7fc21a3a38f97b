"""Draw average showers per layer from a config-described h5 (regular-grid
polar maps; HGCal showers are GLaM-embedded first).

A copy of ``calodiffusion_tpu/tools/plot_avg_shower.py`` (the port imports
nothing of the JAX package); ``h5py`` and ``matplotlib`` are imported when
it runs.

Usage:
  python -m calodiffusion_tpu_torch.tools.plot_avg_shower -c config.json \
      -i showers.h5 -o ./plots/showers/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-i", "--fin", required=True, help="Shower h5 to plot")
    ap.add_argument("-n", "--n-showers", type=int, default=10000)
    ap.add_argument("-o", "--outdir", default="./plots/showers/")
    ap.add_argument("--EMin", type=float, default=-1.0)
    args = ap.parse_args(argv)

    import h5py
    import matplotlib

    matplotlib.use("Agg")

    from calodiffusion_tpu_torch.evaluation.plots import plot_shower_layer
    from calodiffusion_tpu_torch.utils.config import LoadJson

    config = LoadJson(args.config)
    hgcal = config.get("HGCAL", False)
    scale = config.get("SHOWERSCALE", 0.001)
    os.makedirs(args.outdir, exist_ok=True)

    with h5py.File(args.fin, "r") as f:
        showers = f["showers"][: args.n_showers].astype(np.float32) * scale
    if args.EMin > 0.0:
        showers[showers < args.EMin] = 0.0

    if hgcal:
        from calodiffusion_tpu_torch.utils import hgcal_utils

        conv = hgcal_utils.HGCalConverter(
            bins=config["SHAPE_FINAL"], geom_file=config["BIN_FILE"]
        )
        conv.init()
        showers = np.asarray(conv.enc_batches(
            showers.reshape(showers.shape[0], *config["SHAPE_PAD"][2:])
        ))
        showers = showers.reshape([-1] + list(config["SHAPE_FINAL"][1:]))
    else:
        showers = showers.reshape(config["SHAPE_FINAL"])

    avg = np.mean(showers, axis=0)  # (1, Z, A, R)
    for ilay in range(avg.shape[1]):
        layer = avg[0, ilay]        # (A, R)
        plot_shower_layer(
            layer, fname=os.path.join(args.outdir, f"avg_shower_lay{ilay}.png"),
            title=f"Avg shower, layer {ilay}",
        )
    print(f"wrote {avg.shape[1]} layer images to {args.outdir}")


if __name__ == "__main__":
    main()
