"""Build per-energy-bin average and std showers: the cold-diffusion prior
(reference: calodiffusion/utils/create_average_showers.py).

A copy of ``calodiffusion_tpu/tools/create_average_showers.py`` (the port
imports nothing of the JAX package), with the binning split from the h5
reading: ``average_showers`` takes preprocessed showers and energies in
memory (``CaloDiffusion.set_cold_prior`` takes its output where there is no
h5py), ``build_average_showers`` reads a config's files first.  ``h5py`` is
imported when a file is read or written.

Usage:
  python -m calodiffusion_tpu_torch.tools.create_average_showers \
      -c config.json --data_folder DATA -o avg_showers.h5
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from calodiffusion_tpu_torch.utils.config import LoadJson
from calodiffusion_tpu_torch.utils.preprocessing import load_calochallenge_h5


def average_showers(data, energies, dataset_num: int):
    """(avg_showers, std_showers, E_bins) of preprocessed showers ``data``
    (n, *shower shape) binned by their preprocessed energies (log energies
    ~uniform in [0, 1]): 100 bins for datasets >= 2, 15 for dataset 1,
    ``E_bins = linspace(-0.001, 1, nbins)``, a shower in bin
    ``digitize(E, E_bins) - 1``; an empty bin stays 0."""
    energies = np.reshape(energies, -1)
    nbins = 100 if dataset_num >= 2 else 15
    E_bins = np.linspace(-0.001, 1.0, nbins)
    bins = np.digitize(energies, E_bins) - 1

    shape = list(data.shape)
    shape[0] = nbins
    avg_showers = np.zeros(shape, dtype=np.float32)
    std_showers = np.zeros(shape, dtype=np.float32)
    for i in range(nbins):
        sel = bins == i
        if sel.any():
            avg_showers[i] = np.mean(data[sel], axis=0)
            std_showers[i] = np.std(data[sel], axis=0)
    return avg_showers, std_showers, E_bins


def build_average_showers(config: dict, data_folder: str, nevts: int = -1):
    """``average_showers`` of the config's ``FILES`` read and preprocessed
    as the loader does, in its training layout (``SHAPE_PAD``; flat for an
    "orig" embed)."""
    dataset_num = config["DATASET_NUM"]
    orig_shape = "orig" in config.get("SHOWER_EMBED", "")
    binning_file = config.get("BIN_FILE", None)

    data, energies = None, None
    files = config["FILES"]
    for i, dataset in enumerate(files):
        d, e, _ = load_calochallenge_h5(
            os.path.join(data_folder, dataset),
            shape=config["SHAPE_PAD"],
            emax=config["EMAX"], emin=config["EMIN"],
            nevts=nevts,
            binning_file=binning_file,
            max_deposit=config["MAXDEP"],
            logE=config["logE"],
            showerMap=config["SHOWERMAP"],
            shower_scale=config.get("SHOWERSCALE", 0.001),
            nholdout=config.get("HOLDOUT", 0) if i == len(files) - 1 else 0,
            dataset_num=dataset_num,
            orig_shape=orig_shape,
        )
        data = d if data is None else np.concatenate((data, d))
        energies = e if energies is None else np.concatenate((energies, e))

    if not orig_shape:
        # the loader's training-array layout, so that the prior broadcasts
        # against training batches and noise
        data = np.reshape(data, config["SHAPE_PAD"])
    return average_showers(data, energies, dataset_num)


def write_average_showers(path: str, avg, std, E_bins) -> None:
    import h5py as h5

    with h5.File(path, "w") as fout:
        fout.create_dataset("avg_showers", data=avg)
        fout.create_dataset("std_showers", data=std)
        fout.create_dataset("E_bins", data=E_bins)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_folder", default="../data/")
    parser.add_argument("-c", "--config", default="configs/test.json")
    parser.add_argument("--output", "-o", default="avg_showers.h5")
    parser.add_argument("--nevts", type=int, default=-1)
    flags = parser.parse_args(argv)

    config = LoadJson(flags.config)
    avg, std, E_bins = build_average_showers(config, flags.data_folder, flags.nevts)
    print(f"Writing out to {flags.output}")
    write_average_showers(flags.output, avg, std, E_bins)
    print("Done!")


if __name__ == "__main__":
    main()
