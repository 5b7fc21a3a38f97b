"""Classifier-separation metric: Geant4-vs-generated DNN with calibration.

Port of ``calodiffusion_tpu/evaluation/classifier.py`` (reference:
calodiffusion/tests/hgcal_metrics.py:44-200 - binary DNN, isotonic
calibration, AUC + JSD reporting) as a PyTorch module: a perfect generator
gives AUC ~= 0.5 and JSD ~= 0.

The JAX package calibrates with sklearn's ``IsotonicRegression`` and skips
the calibration where sklearn is missing.  The port needs no sklearn: its
own pool-adjacent-violators fit (``isotonic_fit_transform``) has
``IsotonicRegression(out_of_bounds="clip", y_min, y_max).fit_transform``'s
semantics, and every JSD it reports is calibrated.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from calodiffusion_tpu_torch.utils.device import resolve_device

# flax's default kernel init, lecun_normal: a normal truncated at two
# standard deviations, scaled so that its variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module``'s Linear and Conv2d layers as flax's Dense and
    Conv are (lecun_normal kernels, zero biases) and its GroupNorms as
    flax's (unit scale, zero bias), drawing from the CPU ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


class DNN(nn.Module):
    """``n_layers`` Linear(hidden) + ReLU, then Linear(1); returns logits (B,)."""

    def __init__(self, n_in: int, hidden: int = 256, n_layers: int = 3):
        super().__init__()
        sizes = [n_in] + [hidden] * n_layers
        self.dense = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:])] + [nn.Linear(hidden, 1)]
        )

    def forward(self, x):
        for layer in self.dense[:-1]:
            x = F.relu(layer(x))
        return self.dense[-1](x)[:, 0]


def train_classifier(
    real: np.ndarray, gen: np.ndarray, generator: Optional[torch.Generator] = None,
    epochs: int = 20, batch_size: int = 256, lr: float = 1e-3, val_frac: float = 0.3,
    device=None, init_state: Optional[dict] = None,
):
    """Train a real-vs-generated classifier on flat features; returns
    (apply_fn, state_dict, (X_val, y_val, model, mu, sd)).

    The standardisation, the ``np.random.default_rng(0)`` permutations,
    split and batch order are the JAX package's; Adam (lr 1e-3) on the
    mean binary cross-entropy of the logits.  The weights start from
    ``init_state`` where given, else from flax's init drawn from the CPU
    ``generator`` (default: seed 0).  ``device`` defaults to the card."""
    device = resolve_device(device)
    X = np.concatenate([real.reshape(len(real), -1),
                        gen.reshape(len(gen), -1)]).astype(np.float32)
    y = np.concatenate([np.ones(len(real)), np.zeros(len(gen))]).astype(np.float32)
    # standardize
    mu, sd = X.mean(axis=0), X.std(axis=0) + 1e-8
    X = (X - mu) / sd

    rng = np.random.default_rng(0)
    perm = rng.permutation(len(X))
    X, y = X[perm], y[perm]
    n_val = int(val_frac * len(X))
    X_val, y_val = X[:n_val], y[:n_val]
    X_tr, y_tr = X[n_val:], y[n_val:]

    model = DNN(X.shape[1])
    if init_state is not None:
        model.load_state_dict(init_state)
    else:
        flax_init_(model, generator if generator is not None
                   else torch.Generator().manual_seed(0))
    model.to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    X_dev, y_dev = torch.from_numpy(X_tr).to(device), torch.from_numpy(y_tr).to(device)
    n = len(X_tr)
    for _ in range(epochs):
        order = torch.from_numpy(rng.permutation(n)).to(device)
        for i in range(0, n - batch_size + 1, batch_size):
            sl = order[i: i + batch_size]
            loss = F.binary_cross_entropy_with_logits(model(X_dev[sl]), y_dev[sl])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

    @torch.no_grad()
    def apply_fn(x):
        x = (x.reshape(len(x), -1).astype(np.float32) - mu) / sd
        return torch.sigmoid(model(torch.from_numpy(x).to(device))).cpu().numpy()

    return apply_fn, model.state_dict(), (X_val, y_val, model, mu, sd)


def auc_score(y_true: np.ndarray, y_prob: np.ndarray) -> float:
    """ROC AUC via the rank statistic (no sklearn dependency needed)."""
    order = np.argsort(y_prob)
    ranks = np.empty(len(y_prob))
    ranks[order] = np.arange(1, len(y_prob) + 1)
    n_pos = y_true.sum()
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[y_true > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    )


def _pool_adjacent_violators(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The non-decreasing least-squares fit of ``y`` under weights ``w``
    (float64): blocks pooled while a block's mean is not below the next's."""
    means, weights, sizes = [], [], []
    for yi, wi in zip(y.tolist(), w.tolist()):
        m, wt, s = yi, wi, 1
        while means and means[-1] >= m:
            pm, pw, ps = means.pop(), weights.pop(), sizes.pop()
            m = (pm * pw + m * wt) / (pw + wt)
            wt, s = pw + wt, ps + s
        means.append(m)
        weights.append(wt)
        sizes.append(s)
    return np.repeat(np.asarray(means, np.float64), sizes)


def isotonic_fit_transform(x: np.ndarray, y: np.ndarray, y_min: float,
                           y_max: float) -> np.ndarray:
    """``IsotonicRegression(out_of_bounds="clip", y_min=y_min, y_max=y_max)
    .fit_transform(x, y)`` of sklearn (increasing, unit weights) in numpy.

    As sklearn: the work is in x's dtype (float32 stays float32, anything
    else becomes float64); the points are sorted by (x, y); successive x
    closer than the dtype's resolution (1e-6 in float32, 1e-15 in float64)
    to the first x of their run are merged into it, y averaged over the
    run; the merged values are fitted non-decreasing (pool adjacent
    violators), clipped to [y_min, y_max], and read back at every x by
    linear interpolation between the merged points, x clipped to their
    range."""
    x = np.asarray(x).reshape(-1)
    dtype = x.dtype if x.dtype in (np.float32, np.float64) else np.dtype(np.float64)
    x = x.astype(dtype)
    y = np.asarray(y).reshape(-1).astype(dtype)
    order = np.lexsort((y, x))
    xs, ys = x[order], y[order]

    # merge runs of (nearly) tied x, accumulating in the dtype as sklearn's
    # _make_unique does
    eps = np.finfo(dtype).resolution
    ux, uy, uw = [], [], []
    cx, cy, cw = xs[0], dtype.type(0), dtype.type(0)
    one = dtype.type(1)
    for xi, yi in zip(xs, ys):
        if xi - cx >= eps:
            ux.append(cx)
            uy.append(cy / cw)
            uw.append(cw)
            cx, cy, cw = xi, yi * one, one
        else:
            cw = cw + one
            cy = cy + yi * one
    ux.append(cx)
    uy.append(cy / cw)
    uw.append(cw)
    ux, uy, uw = (np.asarray(a, dtype) for a in (ux, uy, uw))

    fit = _pool_adjacent_violators(uy.astype(np.float64), uw.astype(np.float64)).astype(dtype)
    np.clip(fit, y_min, y_max, fit)
    if len(fit) == 1:
        return np.repeat(fit, len(x))
    # the interior points of a constant run add nothing to the interpolation
    keep = np.ones(len(fit), dtype=bool)
    keep[1:-1] = (fit[1:-1] != fit[:-2]) | (fit[1:-1] != fit[2:])
    xk, yk = ux[keep], fit[keep]
    return np.interp(np.clip(x, ux[0], ux[-1]), xk, yk).astype(dtype)


def jsd_from_probs(y_true: np.ndarray, y_prob: np.ndarray,
                   calibrated: bool = True) -> float:
    """Jensen-Shannon divergence estimate from (optionally isotonic-
    calibrated) classifier probabilities (reference hgcal_metrics.py)."""
    p = np.clip(y_prob, 1e-7, 1 - 1e-7)
    if calibrated:
        p = isotonic_fit_transform(p, y_true, y_min=1e-7, y_max=1 - 1e-7)
        p = np.clip(p, 1e-7, 1 - 1e-7)
    # JSD = 0.5 E_real[log2(2p)] + 0.5 E_gen[log2(2(1-p))]
    real, gen = y_true > 0.5, y_true <= 0.5
    jsd = 0.5 * np.mean(np.log2(2 * p[real])) + 0.5 * np.mean(
        np.log2(2 * (1 - p[gen]))
    )
    return float(max(jsd, 0.0))


def classifier_metrics(real: np.ndarray, gen: np.ndarray,
                       generator: Optional[torch.Generator] = None, epochs: int = 20,
                       device=None, init_state: Optional[dict] = None) -> dict[str, float]:
    """Full pipeline: train, calibrate, report {auc, jsd}."""
    apply_fn, _state, (X_val, y_val, _model, mu, sd) = train_classifier(
        real, gen, generator=generator, epochs=epochs, device=device, init_state=init_state
    )
    probs = apply_fn(X_val * sd + mu)
    return {
        "auc": auc_score(y_val, probs),
        "jsd": jsd_from_probs(y_val, probs),
    }
