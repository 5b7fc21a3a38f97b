"""Small utilities with reference parity (calodiffusion/utils/utils.py
leftovers): mask-file creation, numpy data splitting, batched model
application.

A copy of ``calodiffusion_tpu/utils/misc.py``: the port imports nothing of
the JAX package."""

from __future__ import annotations

import numpy as np


def conversion_preprocess(file_path: str) -> str:
    """Create the always-empty-voxel mask file next to a shower HDF5
    (reference utils.py:823-830); used by write_out(do_mask=True)."""
    import h5py as h5

    with h5.File(file_path, "r") as h5f:
        showers = h5f["showers"][:]
    mask = np.sum(showers, 0) == 0
    mask_file = file_path.replace(".hdf5", "_mask.hdf5")
    print(f"Creating mask file {mask_file}")
    with h5.File(mask_file, "w") as h5f:
        h5f.create_dataset("mask", data=mask)
    return mask_file


def split_data_np(data: np.ndarray, frac: float = 0.8):
    """In-place shuffle + split (reference utils.py:26-31)."""
    np.random.shuffle(data)
    split = int(frac * data.shape[0])
    return data[:split], data[split:]


def apply_in_batches(fn, data: np.ndarray, batch_size: int = 128) -> np.ndarray:
    """Apply a function over data in fixed-size batches
    (reference utils.py:1000-1012)."""
    outs = []
    for i in range(0, data.shape[0], batch_size):
        outs.append(np.asarray(fn(data[i: i + batch_size])))
    return np.concatenate(outs, axis=0)
