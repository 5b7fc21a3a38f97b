"""Draw individual + average HGCal showers as per-layer hex-cell heatmaps.

Working version of the reference's legacy script
(calodiffusion/tests/plot_h5_shower.py - which calls a ``plot_shower_hex``
that is defined nowhere in the reference tree).  A copy of
``calodiffusion_tpu/tools/plot_h5_shower.py`` (the port imports nothing of
the JAX package); ``h5py`` and ``matplotlib`` are imported when it runs.

Usage:
  python -m calodiffusion_tpu_torch.tools.plot_h5_shower -g geom.pkl \
      -i showers.h5 -n 2 -o ./plots/showers/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-g", "--geom-file", required=True, help="Geometry pickle")
    ap.add_argument("-i", "--fin", required=True, help="Shower h5 to plot")
    ap.add_argument("-n", "--n-showers", type=int, default=1)
    ap.add_argument("-o", "--outdir", default="./plots/showers/")
    ap.add_argument("--EMin", type=float, default=-1.0,
                    help="Voxel min energy (layer-energy conserving mask)")
    ap.add_argument("--shower-scale", type=float, default=200.0)
    args = ap.parse_args(argv)

    import h5py
    import matplotlib

    matplotlib.use("Agg")

    from calodiffusion_tpu_torch.evaluation.metrics_utils import (
        apply_mask_conserveE,
    )
    from calodiffusion_tpu_torch.evaluation.plots import plot_shower_hex
    from calodiffusion_tpu_torch.utils import hgcal_utils

    geom = hgcal_utils.load_geom(args.geom_file)
    os.makedirs(args.outdir, exist_ok=True)
    with h5py.File(args.fin, "r") as f:
        showers = f["showers"][: max(args.n_showers, 256)].astype(np.float32)
    showers = showers * args.shower_scale

    if args.EMin > 0.0:
        showers = apply_mask_conserveE(showers, showers < args.EMin)

    def draw(shower, tag):
        for ilay in range(geom.nlayers):
            ncells = int(round(geom.ncells[ilay]))
            plot_shower_hex(
                geom.xmap[ilay][:ncells], geom.ymap[ilay][:ncells],
                shower[ilay][:ncells], nrings=geom.nrings,
                fout=os.path.join(args.outdir, f"{tag}_lay{ilay}.png"),
                title=f"{tag} layer {ilay}",
            )

    for i in range(args.n_showers):
        print(f"Shower {i}")
        draw(showers[i], f"shower{i}")

    print("avg shower")
    draw(np.mean(showers, axis=0), "avg_shower")
    draw(np.std(showers, axis=0), "stddev_shower")


if __name__ == "__main__":
    main()
