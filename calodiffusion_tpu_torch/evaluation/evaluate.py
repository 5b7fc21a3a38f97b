"""Model-quality metrics: FPD and CNN-classifier log-posterior.

Port of ``calodiffusion_tpu/evaluation/evaluate.py`` (reference:
calodiffusion/train/evaluate.py): ``FPD`` (alias ``FDP``) over
HighLevelFeatures, the geometry-agnostic fidelity features and metrics
(numpy copies), and ``CNNCompare``, a small convolutional real-vs-generated
classifier in PyTorch that scores generated samples by mean log posterior.

The port keeps the JAX network exactly: flax's ``"SAME"`` padding (at
stride 2 it pads (0, 1) on an even size and (1, 1) on an odd one, so each
layer pads explicitly), GroupNorm's epsilon of 1e-6, the channels-last
flatten ahead of the dense layers, and ``optax.adamw``'s weight decay of
1e-4.  Its weights file is its own ``state_dict`` (``torch.save``) at
``{results_folder}/{EVAL_NETWORK}.pt``; the JAX package's flax file
(``.npz``) is not read (``tools/jax_import.comparison_params_to_state_dict``
converts a flax tree).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from calodiffusion_tpu_torch.evaluation import frechet
from calodiffusion_tpu_torch.evaluation.classifier import flax_init_
from calodiffusion_tpu_torch.evaluation.hlf import HighLevelFeatures


class FDPCalculationError(Exception):
    pass


class FPD:
    """Frechet Physics Distance over HighLevelFeatures."""

    def __init__(self, binning_dataset: str, particle: str):
        self.hlf = HighLevelFeatures(particle, filename=binning_dataset)
        self.reference_hlf = HighLevelFeatures(particle, filename=binning_dataset)

    def __call__(self, trained_model, eval_data,
                 generator: Optional[torch.Generator] = None) -> float:
        reference_shower, reference_energy = [], []
        for energy, _, data in eval_data:
            reference_shower.append(np.asarray(data))
            reference_energy.append(np.asarray(energy))
        reference_shower = np.concatenate(reference_shower)
        reference_energy = np.concatenate(reference_energy)

        generated, energies = trained_model.generate(
            eval_data, sample_steps=trained_model.config.get("NSTEPS"),
            generator=generator, sample_offset=0,
        )

        self.hlf.CalculateFeatures(generated.reshape(generated.shape[0], -1))
        self.reference_hlf.CalculateFeatures(
            reference_shower.reshape(reference_shower.shape[0], -1)
        )
        source = self.hlf.feature_matrix(energies)
        reference = self.reference_hlf.feature_matrix(reference_energy)
        try:
            value, _err = frechet.fpd(reference, source)
        except (ValueError, np.linalg.LinAlgError) as err:
            raise FDPCalculationError(err)
        return value


# registry-compatible alias (the reference class is named FDP)
FDP = FPD


def shower_feature_matrix(
    showers: np.ndarray, e_inc: np.ndarray, nlayers: int | None = None,
    include_occupancy: bool = True,
) -> np.ndarray:
    """Geometry-agnostic high-level feature vector per shower, for the
    classifier/FPD fidelity gates (a copy of the JAX package's, which
    documents the choice of features).

    Features: log1p(Etot), Etot/Einc, [sparsity, max-voxel fraction,]
    energy-weighted depth mean/std over ``nlayers`` longitudinal slices
    (or 8 flat chunks when no layer axis is known), plus the per-slice
    ``log10(E_layer + 1e-8)`` energies.  ``include_occupancy=False`` drops
    the cell-occupancy features (sparsity + max-voxel fraction), as the
    reference's HGCal classifier does (tests/hgcal_metrics.py:247-250)."""
    x = showers.reshape(showers.shape[0], -1).astype(np.float64)
    e = np.maximum(np.asarray(e_inc, np.float64).reshape(-1), 1e-12)
    tot = x.sum(axis=1)
    safe_tot = np.maximum(tot, 1e-12)

    if nlayers and x.shape[1] % nlayers == 0:
        lay = x.reshape(x.shape[0], nlayers, -1).sum(-1)
    else:
        nchunk = 8
        pad = (-x.shape[1]) % nchunk
        xp = np.pad(x, ((0, 0), (0, pad)))
        lay = xp.reshape(x.shape[0], nchunk, -1).sum(-1)
    frac = lay / safe_tot[:, None]
    depth = np.arange(lay.shape[1], dtype=np.float64)[None, :]
    d_mean = (frac * depth).sum(1)
    d_std = np.sqrt(np.maximum((frac * depth**2).sum(1) - d_mean**2, 0.0))

    cols = [
        np.log1p(np.maximum(tot, 0.0)),
        tot / e,
    ]
    if include_occupancy:
        cols += [
            (x > 1e-8).mean(axis=1),
            x.max(axis=1) / safe_tot,
        ]
    cols += [d_mean, d_std, np.log10(np.maximum(lay, 0.0) + 1e-8)]
    feats = np.column_stack(cols)
    return np.nan_to_num(feats.astype(np.float32))


def feature_names(n_features: int, include_occupancy: bool = True):
    """Column names matching shower_feature_matrix's layout."""
    names = ["log1p_Etot", "Etot_over_Einc"]
    if include_occupancy:
        names += ["occupancy", "maxvox_frac"]
    names += ["depth_mean", "depth_std"]
    names += [f"log10_Elayer_{i}" for i in range(n_features - len(names))]
    return names


def per_feature_auc(f_ref: np.ndarray, f_gen: np.ndarray,
                    cond_ref: np.ndarray | None = None,
                    cond_gen: np.ndarray | None = None,
                    n_bins: int = 10) -> np.ndarray:
    """Single-feature Mann-Whitney AUC per column (P[gen > ref] with tie
    correction): which high-level feature a discriminating classifier keys
    on.  With ``cond_ref``/``cond_gen`` (a per-event conditioning scalar,
    e.g. log E_inc) the AUC is taken within conditioning quantile bins and
    count-averaged: the conditional per-feature AUC."""
    if cond_ref is not None:
        cond_ref = np.asarray(cond_ref, np.float64).reshape(-1)
        cond_gen = np.asarray(cond_gen, np.float64).reshape(-1)
        edges = np.quantile(np.concatenate([cond_ref, cond_gen]),
                            np.linspace(0, 1, n_bins + 1))
        edges[0], edges[-1] = -np.inf, np.inf
        acc = np.zeros(f_ref.shape[1])
        tot = 0
        for i in range(n_bins):
            mr = (cond_ref >= edges[i]) & (cond_ref < edges[i + 1])
            mg = (cond_gen >= edges[i]) & (cond_gen < edges[i + 1])
            if mr.sum() < 8 or mg.sum() < 8:
                continue
            w = mr.sum() + mg.sum()
            acc += w * per_feature_auc(f_ref[mr], f_gen[mg])
            tot += w
        if tot == 0:
            # no bin had enough events on both sides: the conditional AUC
            # is undefined — return the null 0.5, not 0.0 (which would
            # read as maximal deviation to |auc-0.5| consumers)
            return np.full(f_ref.shape[1], 0.5)
        return acc / tot
    n_r, n_g = f_ref.shape[0], f_gen.shape[0]
    aucs = np.empty(f_ref.shape[1])
    for j in range(f_ref.shape[1]):
        both = np.concatenate([f_ref[:, j], f_gen[:, j]])
        order = np.argsort(both, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, both.size + 1)
        # average ranks over ties
        sorted_vals = both[order]
        i = 0
        while i < both.size:
            k = i
            while k + 1 < both.size and sorted_vals[k + 1] == sorted_vals[i]:
                k += 1
            if k > i:
                ranks[order[i:k + 1]] = 0.5 * (i + 1 + k + 1)
            i = k + 1
        r_gen = ranks[n_r:].sum()
        aucs[j] = (r_gen - n_g * (n_g + 1) / 2) / (n_r * n_g)
    return aucs


def fidelity_metrics(
    ref: np.ndarray,
    ref_e: np.ndarray,
    gen: np.ndarray,
    gen_e: np.ndarray,
    nlayers: int | None = None,
    generator: Optional[torch.Generator] = None,
    epochs: int = 20,
    include_occupancy: bool = True,
    features=None,
    device=None,
) -> dict[str, float]:
    """Classifier AUC/JSD + FPD between Geant and generated showers.

    AUC ~= 0.5 means the DNN cannot tell generated from real; FPD ~= 0
    likewise over the feature matrix.  ``features=(f_ref, f_gen)`` skips
    recomputing the feature matrices.  The classifier trains on ``device``
    (default: the card) from ``generator``'s init.  ``CALODIFF_FID_DIAG=1``
    prints the most discriminating features whatever the AUC.
    Returns {"classifier_auc", "classifier_jsd", "fpd", "fpd_err"}."""
    from calodiffusion_tpu_torch.evaluation.classifier import classifier_metrics

    if features is not None:
        f_ref, f_gen = features
    else:
        f_ref = shower_feature_matrix(ref, ref_e, nlayers, include_occupancy)
        f_gen = shower_feature_matrix(gen, gen_e, nlayers, include_occupancy)
    cls = classifier_metrics(f_ref, f_gen, generator=generator, epochs=epochs, device=device)
    if cls["auc"] > 0.65 or os.environ.get("CALODIFF_FID_DIAG") == "1":
        names = feature_names(f_ref.shape[1], include_occupancy)
        aucs = per_feature_auc(f_ref, f_gen)
        top = np.argsort(-np.abs(aucs - 0.5))[:5]
        print("[fidelity] top per-feature AUCs: "
              + ", ".join(f"{names[j]}={aucs[j]:.3f}" for j in top),
              flush=True)
        le_r = np.log10(np.maximum(np.asarray(ref_e, np.float64), 1e-12))
        le_g = np.log10(np.maximum(np.asarray(gen_e, np.float64), 1e-12))
        caucs = per_feature_auc(f_ref, f_gen, cond_ref=le_r, cond_gen=le_g)
        ctop = np.argsort(-np.abs(caucs - 0.5))[:5]
        print("[fidelity] top per-feature AUCs conditional on E: "
              + ", ".join(f"{names[j]}={caucs[j]:.3f}" for j in ctop),
              flush=True)
    try:
        fpd_val, fpd_err = frechet.fpd(f_ref, f_gen)
    except (ValueError, np.linalg.LinAlgError) as err:
        raise FDPCalculationError(err)
    return {
        "classifier_auc": float(cls["auc"]),
        "classifier_jsd": float(cls["jsd"]),
        "fpd": float(fpd_val),
        "fpd_err": float(fpd_err),
    }


def same_pads(n: int, stride: int, k: int = 3) -> tuple[int, int]:
    """flax/XLA ``"SAME"`` padding (low, high) of one axis of size ``n``:
    the output has ceil(n / stride) positions and the odd pixel of the
    total padding goes to the high side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class ComparisonNetwork(nn.Module):
    """Small conv classifier over (Z, A, R) voxel grids + incident energy:
    Z is the channel axis, so (B, Z, A, R) is already NCHW."""

    LAYERS = ((32, 2), (64, 2), (96, 1), (128, 1))  # (features, stride)

    def __init__(self, data_shape):
        super().__init__()
        Z, A, R = data_shape
        self.convs, self.norms, self.pads = nn.ModuleList(), nn.ModuleList(), []
        c_in = Z
        for feats, stride in self.LAYERS:
            self.convs.append(nn.Conv2d(c_in, feats, 3, stride=stride))
            self.norms.append(nn.GroupNorm(8, feats, eps=1e-6))
            self.pads.append(same_pads(R, stride) + same_pads(A, stride))  # F.pad: last axis first
            A, R, c_in = -(-A // stride), -(-R // stride), feats
        self.dense = nn.ModuleList([nn.Linear(A * R * c_in + 1, 128), nn.Linear(128, 1)])

    def forward(self, x, E):
        for conv, norm, pad in zip(self.convs, self.norms, self.pads):
            x = F.relu(norm(conv(F.pad(x, pad))))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's (A, R, C) order
        x = torch.cat([x, E.reshape(x.shape[0], -1)], dim=-1)
        return self.dense[1](F.relu(self.dense[0](x)))[:, 0]


# CNNCompare.train_network's epochs and learning rate by dataset
TRAIN_HP = {2: {"epochs": 48, "lr": 2.5e-4}, 3: {"epochs": 12, "lr": 5e-5}}


class CNNCompare:
    """Mean log posterior of generated showers under a real-vs-generated
    CNN classifier (reference evaluate.py:134-234).

    ``trained_model`` (the port's ``CaloDiffusion``, with its weights)
    samples from a generator on its device seeded with ``seed``; the CNN
    starts from flax's init drawn from a CPU generator of the same seed,
    then from ``{results_folder}/{EVAL_NETWORK}.pt`` where that exists, and
    is retrained (and the file written) with ``RETRAIN_EVAL_NETWORK``."""

    def __init__(self, trained_model, config, flags, seed: int = 0):
        self.flags = flags
        self.config = config
        self.trained_model = trained_model
        self.device = trained_model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.sample_offset = getattr(
            config.get("flags", {}), "sample_offset", 0
        ) or 0

        shapes = {2: (45, 16, 9), 3: (45, 50, 18)}
        num = config.get("DATASET_NUM")
        if num not in shapes:
            raise ValueError(
                f"Only datasets {list(shapes)} can be evaluated with CNNCompare."
            )
        self.data_shape = shapes[num]
        self.cnn = flax_init_(ComparisonNetwork(self.data_shape),
                              torch.Generator().manual_seed(seed)).to(self.device)
        self._load_or_init()

    def _weights_path(self):
        base = getattr(self.config.get("flags", {}), "results_folder", ".") or "."
        name = self.config.get("EVAL_NETWORK", "eval_cnn")
        return os.path.join(base, f"{name}.pt")

    def _load_or_init(self):
        path = self._weights_path()
        if os.path.exists(path):
            self.cnn.load_state_dict(torch.load(path, map_location=self.device,
                                                weights_only=True))
        else:
            flax_file = path.removesuffix(".pt") + ".npz"
            if os.path.exists(flax_file):
                print(f"WARNING: {flax_file} is the JAX package's flax file, which the port "
                      "does not read (tools/jax_import.comparison_params_to_state_dict "
                      "converts a flax tree)")
            print(f"WARNING: Cannot find weights at path {path}")
        if self.config.get("RETRAIN_EVAL_NETWORK", False):
            self.train_network()

    def _sample_batch(self, E, layers):
        out = self.trained_model.sample(
            torch.as_tensor(np.asarray(E, np.float32), device=self.device),
            layers=(torch.as_tensor(np.asarray(layers, np.float32), device=self.device)
                    if layers is not None else None),
            num_steps=self.config["NSTEPS"], generator=self.generator,
            sample_offset=self.sample_offset,
        )
        # a copy: sample's output is an inference tensor, which autograd cannot save
        return out.to(torch.float32, copy=True).reshape(-1, *self.data_shape)

    def _real_batch(self, E, data):
        x = torch.as_tensor(np.asarray(data, np.float32), device=self.device)
        return x.reshape(-1, *self.data_shape), torch.as_tensor(
            np.asarray(E, np.float32), device=self.device)

    def train_network(self):
        """AdamW (optax.adamw's defaults: weight decay 1e-4) on the binary
        cross-entropy, real = 1, over the EVAL files' batches, each beside
        a generated batch of the same energies; writes the weights file."""
        from calodiffusion_tpu_torch.data.loader import load_data

        training_data, _ = load_data(self.flags, self.config, eval=True, device=self.device)
        cfg = TRAIN_HP[self.config.get("DATASET_NUM")]
        opt = torch.optim.AdamW(self.cnn.parameters(), lr=cfg["lr"], betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
        for _ in range(cfg["epochs"]):
            for E, layers, data in training_data:
                x_gen = self._sample_batch(E, layers)
                x_real, E_t = self._real_batch(E, data)
                logit_real = self.cnn(x_real, E_t)
                logit_gen = self.cnn(x_gen, E_t)
                loss = F.binary_cross_entropy_with_logits(
                    logit_real, torch.ones_like(logit_real)
                ) + F.binary_cross_entropy_with_logits(logit_gen, torch.zeros_like(logit_gen))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()

        path = self._weights_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(self.cnn.state_dict(), path)

    @torch.no_grad()
    def __call__(self, eval_data) -> float:
        log_posteriors = []
        for E, layers, data in eval_data:
            x_gen = self._sample_batch(E, layers)
            E_t = torch.as_tensor(np.asarray(E, np.float32), device=self.device)
            log_posteriors.append(F.logsigmoid(self.cnn(x_gen, E_t)).cpu().numpy())
        return float(np.mean(np.concatenate(log_posteriors)))
