"""Shared evaluation math: separation power, weighted moments, masking.

Reference: calodiffusion/utils/utils.py:167-175 (_separation_power),
:1021-1032 (apply_mask_conserveE); calodiffusion/utils/plots.py:17-43
(weighted means / angular center-spread).

A copy of ``calodiffusion_tpu/evaluation/metrics_utils.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def separation_power(hist1: np.ndarray, hist2: np.ndarray, bins: np.ndarray) -> float:
    """Triangular discrimination (eq. 15 of arXiv:2009.03796).  Inputs are
    density histograms; multiply by bin widths so each sums to 1."""
    hist1, hist2 = hist1 * np.diff(bins), hist2 * np.diff(bins)
    ret = (hist1 - hist2) ** 2
    ret = ret / (hist1 + hist2 + 1e-16)
    return 0.5 * ret.sum()


def weighted_mean(coord, energies, power=1, axis=-1):
    ec = np.sum(energies * np.power(coord, power), axis=axis)
    sum_energies = np.sum(energies, axis=axis)
    return np.ma.divide(ec, sum_energies).filled(0)


def ang_center_spread(matrix, energies, axis=-1):
    """Weighted circular mean/spread of a periodic coordinate."""
    cos_ec = weighted_mean(np.cos(matrix), energies, axis=axis)
    sin_ec = weighted_mean(np.sin(matrix), energies, axis=axis)
    ang_mean = np.arctan2(sin_ec, cos_ec)
    R = np.clip(np.sqrt(sin_ec**2 + cos_ec**2), 1e-8, 1.0)
    return ang_mean, np.sqrt(-np.log(R))


def get_width(mean, mean2):
    return np.ma.sqrt(mean2 - mean**2).filled(0)


def apply_mask_conserveE(generated: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero masked voxels while conserving per-layer energy."""
    generated[generated < 0] = 0
    d_masked = np.where(mask, generated, 0.0)
    lostE = np.sum(d_masked, axis=-1, keepdims=True)
    ELayer = np.sum(generated, axis=-1, keepdims=True)
    eps = 1e-10
    rescale = (ELayer + eps) / (ELayer - lostE + eps)
    generated[mask] = 0.0
    generated *= rescale
    return generated
