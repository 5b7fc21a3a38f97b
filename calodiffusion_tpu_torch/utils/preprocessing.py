"""CaloChallenge shower preprocessing and its exact inverse.

Host-side numpy code, copied from ``calodiffusion_tpu/utils/preprocessing.py``
(the port imports nothing of the JAX package): preprocessing runs once per
input HDF5 and is cached as an ``.npz`` next to the source file, so fidelity
depends on these transforms matching the reference chain *exactly*
(reference: calodiffusion/utils/utils.py:233-243 logit, :260-312 DataLoader,
:315-436 preprocess_shower, :446-573 ReverseNormCaloChall).

Chain (forward):
  raw shower (MeV) --x shower_scale--> /(MAXDEP*E) --[layer split: per-layer
  fractions -> logit -> standardize; totalE -> standardize]--> voxel transform
  (logit or log, then norm or scaled) --> optional sklearn quantile transform.
"""

from __future__ import annotations

import numpy as np

from calodiffusion_tpu_torch.utils import consts
from calodiffusion_tpu_torch.utils.geom import GeomConverter
from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

LOGIT_ALPHA = 1e-6


def logit(x: np.ndarray, alpha: float = LOGIT_ALPHA) -> np.ndarray:
    o = alpha + (1 - 2 * alpha) * x
    # masked log: invalid/0 entries are filled with 0 like the reference
    return np.ma.log(o / (1 - o)).filled(0)


def reverse_logit(x: np.ndarray, alpha: float = LOGIT_ALPHA) -> np.ndarray:
    """The inverse of ``logit``.  Where exp(x) overflows (x past ~88.7 in
    f32), the JAX package's copy gives inf / inf = NaN; this gives the
    limit, 1 before the alpha rescaling (ROADMAP Queue 3).  Elsewhere the
    two agree bit for bit."""
    with np.errstate(over="ignore", invalid="ignore"):
        exp = np.exp(x)
        o = np.where(np.isinf(exp), np.ones_like(exp), exp / (1 + exp))
    return (o - alpha) / (1 - 2 * alpha)


def _load_quantile_transform(path: str):
    import joblib

    return joblib.load(path)


def preprocess_shower(
    shower: np.ndarray,
    e: np.ndarray,
    shape,
    binning_file: str,
    showerMap: str = "log-norm",
    dataset_num: int = 2,
    orig_shape: bool = False,
    ecut: float = 0,
    max_deposit: float = 2,
):
    """Forward-transform showers; returns (shower, layerE or None)."""
    bins = None
    if dataset_num == 1:
        bins = XMLHandler("photon", binning_file)
    elif dataset_num == 0:
        bins = XMLHandler("pion", binning_file)

    if dataset_num <= 1 and not orig_shape:
        g = GeomConverter(bins)
        shower = g.convert(g.reshape(shower))
    elif not orig_shape:
        shower = shower.reshape(shape)

    if dataset_num > 3 or dataset_num < 0:
        raise ValueError(f"Invalid dataset {dataset_num}")

    # original-shape dataset-1 uses its own normalization constants
    if orig_shape and dataset_num <= 1:
        dataset_num += 10

    c = consts.dataset_params[dataset_num]

    if "quantile" in showerMap and ecut > 0:
        np.random.seed(123)
        shower = shower + (ecut / 3) * np.random.rand(*shower.shape)

    layerE = None
    prefix = ""
    if "layer" in showerMap:
        eshape = (-1, *(1,) * (len(shower.shape) - 1))
        shower = np.ma.divide(shower, max_deposit * e.reshape(eshape))
        if dataset_num % 10 > 1 or not orig_shape:
            # regular grid: layer = sum over (alpha, R); works for both the
            # (N, 1, Z, A, R) padded layout and the (N, L, A, R) output of
            # GeomConverter (dataset-1 regular path)
            layers = np.sum(shower, tuple(range(shower.ndim - 2, shower.ndim)),
                            keepdims=True)
            totalE = np.sum(shower, tuple(range(shower.ndim - 3, shower.ndim)),
                            keepdims=True)
            shower = np.reshape(shower, (shower.shape[0], -1))
        else:
            # irregular flat layout: layer boundaries from the binning XML
            boundaries = np.unique(bins.GetBinEdges())
            layers = np.zeros(
                (shower.shape[0], boundaries.shape[0] - 1), dtype=np.float32
            )
            totalE = np.sum(shower, 1, keepdims=True)
            for idx in range(boundaries.shape[0] - 1):
                layers[:, idx] = np.sum(
                    shower[:, boundaries[idx]: boundaries[idx + 1]], 1
                )

        layers = np.ma.divide(layers, totalE)
        layers = logit(layers)
        layers = (layers - c["layers_mean"]) / c["layers_std"]
        totalE = (totalE - c["totalE_mean"]) / c["totalE_std"]
        totalE = np.reshape(totalE, (totalE.shape[0], 1))
        layers = np.squeeze(layers)
        layerE = np.concatenate((totalE, layers), axis=1)
    else:
        shower = np.reshape(shower, (shower.shape[0], -1))
        shower = shower / (max_deposit * e)

    if "logit" in showerMap:
        shower = logit(shower)
        if "norm" in showerMap:
            shower = (shower - c[prefix + "logit_mean"]) / c[prefix + "logit_std"]
        elif "scaled" in showerMap:
            shower = (
                2.0 * (shower - c["logit_min"]) / (c["logit_max"] - c["logit_min"])
                - 1.0
            )
    elif "log" in showerMap:
        shower = np.ma.log(shower).filled(c["log_min"])
        if "norm" in showerMap:
            shower = (shower - c[prefix + "log_mean"]) / c[prefix + "log_std"]
        elif "scaled" in showerMap:
            shower = (
                2.0
                * (shower - c[prefix + "log_min"])
                / (c[prefix + "log_max"] - c[prefix + "log_min"])
                - 1.0
            )

    if "quantile" in showerMap and c.get(prefix + "qt") is not None:
        qt = _load_quantile_transform(c["qt"])
        shower = qt.transform(shower.reshape(-1, 1)).reshape(shower.shape)

    return shower, layerE


def load_calochallenge_h5(
    file_name: str,
    shape=None,
    emax: float = 99999.0,
    emin: float = 0.0001,
    binning_file: str = "",
    nevts: int = -1,
    max_deposit: float = 2,
    ecut: float = 0,
    logE: bool = True,
    showerMap: str = "log-norm",
    nholdout: int = 0,
    from_end: bool = False,
    dataset_num: int = 2,
    orig_shape: bool = False,
    evt_start: int = 0,
    shower_scale: float = 0.001,
    **_unused,
):
    """Read + preprocess one CaloChallenge HDF5 (reference DataLoaderCaloChall)."""
    import h5py as h5

    with h5.File(file_name, "r") as h5f:
        if nevts == -1 and nholdout > 0:
            nevts = -nholdout
        end = evt_start + int(nevts)
        if from_end:
            evt_start = -int(nevts)
            end = None
        if end == -1:
            end = None
        e = h5f["incident_energies"][evt_start:end].astype(np.float32) * shower_scale
        shower = h5f["showers"][evt_start:end].astype(np.float32) * shower_scale

    e = np.reshape(e, (-1, 1))
    shower, layerE = preprocess_shower(
        shower, e, shape, binning_file, showerMap,
        dataset_num=dataset_num, orig_shape=orig_shape,
        ecut=ecut, max_deposit=max_deposit,
    )

    if logE:
        E = np.log10(e / emin) / np.log10(emax / emin)
    else:
        E = (e - emin) / (emax - emin)

    return shower, E, layerE


def reverse_norm(
    voxels: np.ndarray,
    e: np.ndarray,
    emax: float = 9999.0,
    emin: float = 0.0001,
    config=None,
    shape=None,
    binning_file: str = "",
    max_deposit: float = 2,
    logE: bool = True,
    layerE=None,
    showerMap: str = "log",
    dataset_num: int = 2,
    orig_shape: bool = False,
    ecut: float = 0.0,
    **_unused,
):
    """Exact inverse of :func:`preprocess_shower` (reference ReverseNormCaloChall)."""
    if dataset_num > 3 or dataset_num < 0:
        raise ValueError(f"Invalid dataset {dataset_num}")

    bins = None
    if dataset_num == 1:
        bins = XMLHandler("photon", binning_file)
    elif dataset_num == 0:
        bins = XMLHandler("pion", binning_file)

    if orig_shape and dataset_num <= 1:
        dataset_num += 10
    c = consts.dataset_params[dataset_num]

    if logE:
        energy = emin * (emax / emin) ** e
    else:
        energy = emin + (emax - emin) * e

    prefix = ""
    if "quantile" in showerMap and c.get("qt") is not None:
        qt = _load_quantile_transform(c["qt"])
        voxels = qt.inverse_transform(voxels.reshape(-1, 1)).reshape(voxels.shape)

    if "logit" in showerMap:
        if "norm" in showerMap:
            voxels = voxels * c[prefix + "logit_std"] + c[prefix + "logit_mean"]
        elif "scaled" in showerMap:
            voxels = (voxels + 1.0) * 0.5 * (
                c[prefix + "logit_max"] - c[prefix + "logit_min"]
            ) + c[prefix + "logit_min"]
        data = reverse_logit(voxels)
    elif "log" in showerMap:
        if "norm" in showerMap:
            voxels = voxels * c[prefix + "log_std"] + c[prefix + "log_mean"]
        elif "scaled" in showerMap:
            voxels = (voxels + 1.0) * 0.5 * (
                c[prefix + "log_max"] - c[prefix + "log_min"]
            ) + c[prefix + "log_min"]
        voxels = np.minimum(voxels, np.log(max_deposit))
        data = np.exp(voxels)
    else:
        data = voxels

    if "layer" in showerMap:
        assert layerE is not None
        totalE, layers = layerE[:, :1], layerE[:, 1:]
        totalE = totalE * c["totalE_std"] + c["totalE_mean"]
        layers = layers * c["layers_std"] + c["layers_mean"]
        layers = reverse_logit(layers)
        layers /= np.sum(layers, axis=1, keepdims=True)
        layers *= totalE

        data = np.squeeze(data)
        eps = 1e-6
        data[data < 0] = 0

        if dataset_num % 10 > 1 or not orig_shape:
            prev_layers = np.sum(data, (2, 3), keepdims=True)
            layers = layers.reshape((-1, data.shape[1], 1, 1))
            rescale_facs = layers / (prev_layers + 1e-10)
            # layers that are essentially zero on either side are left alone
            rescale_facs[layers < eps] = 1.0
            rescale_facs[prev_layers < eps] = 1.0
            data *= rescale_facs
        else:
            boundaries = np.unique(bins.GetBinEdges())
            for idx in range(boundaries.shape[0] - 1):
                prev_layer = np.sum(
                    data[:, boundaries[idx]: boundaries[idx + 1]], 1, keepdims=True
                )
                rescale_fac = layers[:, idx: idx + 1] / (prev_layer + 1e-10)
                rescale_fac[layers[:, idx: idx + 1] < eps] = 1.0
                rescale_fac[prev_layer < eps] = 1.0
                data[:, boundaries[idx]: boundaries[idx + 1]] *= rescale_fac

    if dataset_num > 1 or orig_shape:
        data = data.reshape(voxels.shape[0], -1) * max_deposit * energy.reshape(-1, 1)
    else:
        g = GeomConverter(bins)
        data = np.squeeze(data)
        data = g.unreshape(g.unconvert(data)) * max_deposit * energy.reshape(-1, 1)

    if "quantile" in showerMap and ecut > 0.0:
        data -= 0.5 * (ecut / 3)

    if ecut > 0:
        data[data < ecut] = 0

    return data, energy


# ---------------------------------------------------------------------------
# Constant conditioning images (reference: utils.py create_R_Z_image /
# create_phi_image) - numpy here; the model keeps them as
# device buffers.
# ---------------------------------------------------------------------------

def create_phi_image(shape=(1, 45, 16, 9)) -> np.ndarray:
    n_phi = shape[-2]
    phi_bins = np.linspace(0.0, 1.0, n_phi, dtype=np.float32)
    phi_image = np.zeros(shape, dtype=np.float32)
    phi_image[..., :, :] = phi_bins[None, None, :, None]
    return phi_image


def create_R_Z_image(dataset_num=1, scaled=True, shape=(1, 45, 16, 9)):
    if dataset_num >= 100:  # HGCal: unit-spaced radial rings
        r_bins = np.arange(0, shape[-1] + 1, dtype=np.float32)
    else:
        r_bins = np.asarray(consts.R_BIN_EDGES[dataset_num], dtype=np.float32)
    r_avgs = (r_bins[:-1] + r_bins[1:]) / 2.0
    if len(r_avgs) != shape[-1]:
        raise ValueError(
            f"Mismatch for dataset shape {shape} and dataset num {dataset_num}; "
            f"expected final dim {len(r_avgs)}"
        )
    Z_image = np.zeros(shape, dtype=np.float32)
    R_image = np.zeros(shape, dtype=np.float32)
    Z_image[:] = np.arange(shape[1], dtype=np.float32)[None, :, None, None]
    R_image[:] = r_avgs[None, None, None, :]
    if scaled:
        Z_image /= shape[1]
        R_image /= r_avgs[-1]
    return R_image, Z_image
