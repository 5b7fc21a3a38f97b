"""Trainable geometry embedding for CaloChallenge dataset 1.

Port of ``calodiffusion_tpu/models/converters.py`` (reference:
calodiffusion/utils/utils.py:576-656).  ``NNConverter`` lifts
:class:`~calodiffusion_tpu_torch.utils.geom.GeomConverter`'s fixed
area-weighted rebinning into per-layer trainable linear maps, initialised at
the geometric maps and their pseudo-inverses plus 1e-5 of seeded numpy
normals, so that its initial weights equal the JAX package's bit for bit.

Its parameters carry the reference names ``encs.{i}.weight`` (dim_r_out,
dim_in) and ``decs.{i}.weight`` (dim_in, dim_r_out).  Dataset-1 layers are
ragged (different radial bin counts, some with one alpha bin), so encode and
decode are a short loop of small products, one a layer; they compute in f32
whatever the network's precision, as the JAX package's embed does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from calodiffusion_tpu_torch.utils.geom import GeomConverter


def _init_from(mat: np.ndarray, seed: int, eps: float = 1e-5) -> torch.Tensor:
    noise = np.random.default_rng(seed).standard_normal(mat.shape).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(mat + eps * noise))


def _linear(weight: torch.Tensor) -> nn.Linear:
    lin = nn.Linear(weight.shape[1], weight.shape[0], bias=False)
    with torch.no_grad():
        lin.weight.copy_(weight)
    return lin


class NNConverter(nn.Module):
    """Trainable irregular <-> regular map: ``enc`` and ``dec``."""

    def __init__(self, gc: GeomConverter):
        super().__init__()
        self.gc = gc
        self.encs = nn.ModuleList(
            _linear(_init_from(mat, seed=2 * i)) for i, mat in enumerate(gc.weight_mats))
        self.decs = nn.ModuleList(
            _linear(_init_from(inv, seed=2 * i + 1)) for i, inv in enumerate(gc.weight_mats_inv))
        for i, a in enumerate(gc.lay_alphas):
            if a not in (1, gc.alpha_out):
                raise ValueError(f"layer {i}: unsupported alpha count {a} (alpha_out "
                                 f"{gc.alpha_out})")

    def enc(self, x_flat: torch.Tensor) -> torch.Tensor:
        """(B, total_bins) (or any (B, ...) of as many) -> (B, num_layers,
        alpha_out, dim_r_out), f32."""
        gc = self.gc
        x_flat = x_flat.reshape(x_flat.shape[0], -1).float()
        outs = []
        for i in range(gc.num_layers):
            lo, hi = int(gc.layer_boundaries[i]), int(gc.layer_boundaries[i + 1])
            seg = x_flat[:, lo:hi].reshape(x_flat.shape[0], int(gc.lay_alphas[i]), -1)
            o = seg @ self.encs[i].weight.T  # (B, alphas, dim_r_out)
            if gc.lay_alphas[i] == 1:  # one alpha bin: spread evenly over alpha_out
                o = o.expand(-1, gc.alpha_out, -1) / gc.alpha_out
            outs.append(o)
        return torch.stack(outs, dim=1)

    def dec(self, x: torch.Tensor) -> torch.Tensor:
        """(B, num_layers, alpha_out, dim_r_out) -> (B, total_bins), f32."""
        x = x.float()
        outs = []
        for i in range(self.gc.num_layers):
            o = x[:, i] @ self.decs[i].weight.T  # (B, alpha_out, dim_in)
            if self.gc.lay_alphas[i] == 1:
                o = o.sum(dim=-2, keepdim=True)
            outs.append(o.reshape(o.shape[0], -1))
        return torch.cat(outs, dim=1)

    def forward(self, x_flat):
        return self.enc(x_flat)
