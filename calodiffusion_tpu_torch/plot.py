"""Standalone plotting CLI (port of ``calodiffusion_tpu/plot.py``): the
same argparse front end over the port's plot pipeline in ``inference.py``
(HGCal's plots with ``--hgcal`` or the config's ``HGCAL``; ``--plot-reshape``
encodes HGCal showers on the card: ``inference.py plot`` takes ``--device``).

Usage:
  python -m calodiffusion_tpu_torch.plot -c config.json -g generated.h5 \\
      -d DATA --plot-folder ./plots
"""

from __future__ import annotations

import argparse

from calodiffusion_tpu_torch.inference import plot_results, process_data_dict
from calodiffusion_tpu_torch.utils.config import LoadJson, dotdict


def plot_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-d", "--data-folder", dest="data_folder",
                        default="./data/")
    parser.add_argument("-g", "--generated", default="")
    parser.add_argument("--plot-folder", dest="plot_folder", default="./plots")
    parser.add_argument("--plot-label", dest="plot_label", default="")
    parser.add_argument("--plot-reshape", dest="plot_reshape",
                        action="store_true", default=False)
    parser.add_argument("-e", "--extension", nargs="+", default=["png"])
    parser.add_argument("--cms", action="store_true", default=False)
    parser.add_argument("--energy-min", dest="EMin", type=float, default=-1.0)
    parser.add_argument("--geant-only", dest="geant_only",
                        action="store_true", default=False)
    parser.add_argument("-n", "--nevts", type=int, default=-1)
    parser.add_argument("--job-idx", dest="job_idx", type=int, default=-1)
    parser.add_argument("--layer-only", dest="layer_only",
                        action="store_true", default=False)
    parser.add_argument("--hgcal", action="store_true", default=None)
    return parser


def plot(args=None):
    """Draw the plot suite; returns each plot's separation powers."""
    parsed = plot_parser().parse_args(args)
    flags = dotdict(vars(parsed))
    flags.plot_extensions = flags.pop("extension")
    config = LoadJson(flags.config)
    if flags.hgcal is None:
        flags.hgcal = config.get("HGCAL", False)
    else:
        config["HGCAL"] = flags.hgcal

    data_dict, energies = process_data_dict(flags, config)
    return plot_results(flags, config, data_dict, energies)


if __name__ == "__main__":
    plot()
