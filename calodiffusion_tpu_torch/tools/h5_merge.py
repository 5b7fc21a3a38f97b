"""hadd-style HDF5 concatenation (reference: calodiffusion/utils/h5_merge.py).

A copy of ``calodiffusion_tpu/tools/h5_merge.py`` (the port imports nothing
of the JAX package); ``h5py`` is imported when it runs.

Usage: python -m calodiffusion_tpu_torch.tools.h5_merge out.h5 in1.h5 in2.h5 ...
"""

from __future__ import annotations

import sys


def append_h5(f, name, data):
    prev = f[name].shape[0]
    f[name].resize(prev + data.shape[0], axis=0)
    f[name][prev:] = data


def merge(fin_name: str, fout_name: str) -> None:
    import h5py

    with h5py.File(fin_name, "r") as fin, h5py.File(fout_name, "r+") as fout:
        fin_keys, fout_keys = list(fin.keys()), list(fout.keys())
        if fin_keys != fout_keys:
            print("Input and output files have different datasets!")
            print(f"fin {fin_name}: {fin_keys}")
            print(f"fout {fout_name}: {fout_keys}")
            print("skipping this dataset")
            return
        for key in fin_keys:
            append_h5(fout, key, fin[key])


def resizable_copy(fin_name: str, fout_name: str) -> None:
    import h5py

    with h5py.File(fin_name, "r") as fin, h5py.File(fout_name, "w") as fout:
        for key in fin.keys():
            shape = list(fin[key].shape)
            shape[0] = None
            fout.create_dataset(
                key, data=fin[key], chunks=True, maxshape=shape,
                compression="gzip",
            )


def merge_multiple(fout_name: str, fs: list[str]) -> None:
    print("Merging H5 files:", fs)
    print(f"Dest {fout_name}")
    resizable_copy(fs[0], fout_name)
    for fin_name in fs[1:]:
        print(f"Merging {fin_name}")
        merge(fin_name, fout_name)


if __name__ == "__main__":
    merge_multiple(sys.argv[1], sys.argv[2:])
    print("Done!")
