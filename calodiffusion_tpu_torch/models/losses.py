"""Training-objective (loss) registry.

Port of ``calodiffusion_tpu/models/losses.py`` (reference:
calodiffusion/models/loss.py), under the same names so configs run
unchanged (``TRAINING_OBJ`` in {noise_pred, mean_pred, hybrid_weight,
minsnr}).

A loss is a function of (denoise_fn, batch, randomness); sigma is drawn
either from the discrete cosine-schedule table (``NOISE_SCHED`` without
"log") or the EDM log-normal (P_mean=-1.2, P_std=1.2, sigma_data=1 when
"log" is present; reference loss.py:19-25).  All sigma math is f32.  The
noise, the discrete time and the log-normal draw may be injected (the tests
hand both packages the same numbers); otherwise they are drawn from the
caller's ``torch.Generator``.

``minsnr`` is implemented as intended (EDM c_skip/c_out target with unit
weights, arXiv:2303.09556); the reference's dispatch never reaches it.

Over the data axis of ``parallel/mesh.py`` (``data_group`` set) each rank's
loss is its share of the global batch's: its rows' numerator over the whole
batch's denominator (one all-reduce of a scalar), times the axis size, so
the ranks' mean, which DDP takes of the gradients, is the loss one process
computes on the whole batch (``share_of_mean``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import bshape, randint, randn


def share_of_mean(num, den, group):
    """This rank's share of a mean over the ranks of ``group``: num over the
    sum of every rank's den, times the group's size."""
    den = den.detach().clone()
    dist.all_reduce(den, group=group)
    return num * dist.get_world_size(group) / den


class Loss:
    def __init__(self, config: dict, n_steps: int, loss_type: str = "l1"):
        self.config = config
        self.update_step(n_steps)
        self.discrete_time = True
        self.P_mean = -1.0
        self.P_std = 1.0
        self.sigma_data = 0.5
        if "log" in config.get("NOISE_SCHED", "linear"):
            self.discrete_time = False
            self.P_mean = -1.2
            self.P_std = 1.2
            self.sigma_data = 1.0
        self.loss = self._loss(loss_type)
        self.parts = self._parts(loss_type)
        self.data_group = None  # the data axis's process group (parallel/mesh.py)

    def update_step(self, steps: int) -> None:
        self.n_steps = steps
        t = schedules.ddpm_tables(steps)
        self.sqrt_alphas_cumprod = t["sqrt_alphas_cumprod"]
        self.sqrt_one_minus_alphas_cumprod = t["sqrt_one_minus_alphas_cumprod"]
        self.posterior_variance = t["posterior_variance"]

    def get_scaling(self, sigma):
        sd = self.sigma_data
        return {
            "c_skip": sd**2 / (sigma**2 + sd**2),
            "c_out": sigma * sd / (sigma**2 + sd**2) ** 0.5,
            "c_in": 1 / (sigma**2 + sd**2) ** 0.5,
        }

    @staticmethod
    def _loss(loss_type: str) -> Callable:
        # ``mask`` (per-sample, shape (B,)) excludes padded rows from the
        # mean: the ragged last validation batch.  With mask=None every form
        # reduces exactly to the reference's (weight is used by l2 only,
        # reference loss.py:97-116).
        def _mmean(vals, mask):
            if mask is None:
                return vals.mean()
            m = mask.reshape(bshape(vals)) * torch.ones_like(vals)
            return (vals * m).sum() / m.sum()

        def l1(pred, target, weight=1.0, mask=None):
            return _mmean((pred - target).abs(), mask)

        def l2(pred, target, weight, mask=None):
            if mask is None:
                return (weight * (pred - target) ** 2).sum() / (
                    weight.mean() * float(np.prod(target.shape))
                )
            w = weight * mask.reshape(bshape(pred)) * torch.ones_like(pred)
            return (w * (pred - target) ** 2).sum() / w.sum()

        def mse(pred, target, weight=1.0, mask=None):
            return _mmean((pred - target) ** 2, mask)

        def huber(pred, target, weight=1.0, delta=1.0, mask=None):
            abs_err = (pred - target).abs()
            quad = torch.clamp(abs_err, max=delta)
            return _mmean(0.5 * quad**2 + delta * (abs_err - quad), mask)

        losses = {"l1": l1, "l2": l2, "mse": mse, "huber": huber}
        if loss_type not in losses:
            raise NotImplementedError(
                f"Loss type {loss_type} not implemented, pick from {list(losses)}"
            )
        return losses[loss_type]

    @staticmethod
    def _parts(loss_type: str) -> Callable:
        # (numerator, denominator) of each loss, the loss being their ratio:
        # the sums that add up over the data axis's ranks
        def _m(vals, mask):
            ones = torch.ones_like(vals)
            return ones if mask is None else mask.reshape(bshape(vals)) * ones

        def l1(pred, target, weight=1.0, mask=None):
            m = _m(pred, mask)
            return ((pred - target).abs() * m).sum(), m.sum()

        def l2(pred, target, weight, mask=None):
            w = weight * _m(pred, mask)
            return (w * (pred - target) ** 2).sum(), w.sum()

        def mse(pred, target, weight=1.0, mask=None):
            m = _m(pred, mask)
            return ((pred - target) ** 2 * m).sum(), m.sum()

        def huber(pred, target, weight=1.0, delta=1.0, mask=None):
            abs_err = (pred - target).abs()
            quad = torch.clamp(abs_err, max=delta)
            m = _m(pred, mask)
            return ((0.5 * quad**2 + delta * (abs_err - quad)) * m).sum(), m.sum()

        return {"l1": l1, "l2": l2, "mse": mse, "huber": huber}[loss_type]

    def reduce(self, pred, target, weight, mask=None):
        """The loss of the batch: the reference's reduction on one rank, this
        rank's ``share_of_mean`` over the data axis."""
        if self.data_group is None:
            return self.loss(pred, target, weight, mask=mask)
        return share_of_mean(*self.parts(pred, target, weight, mask=mask), self.data_group)

    def draw_sigma(self, data, generator: Optional[torch.Generator] = None,
                   time=None, rnd_normal=None):
        """Per-sample f32 sigma with shape (B, 1, 1, ...) on data's device."""
        B, dev = data.shape[0], data.device
        if self.discrete_time:
            if time is None:
                time = randint(self.n_steps, B, generator, dev)
            idx = torch.as_tensor(time, device="cpu").long()
            abar = torch.from_numpy(self.sqrt_alphas_cumprod)[idx]
            one_m = torch.from_numpy(self.sqrt_one_minus_alphas_cumprod)[idx]
            return (one_m / abar).reshape(bshape(data)).to(dev)
        if rnd_normal is None:
            rnd_normal = randn((B,), generator, dev)
        rnd_normal = torch.as_tensor(rnd_normal, dtype=torch.float32, device=dev)
        return torch.exp(rnd_normal * self.P_std + self.P_mean).reshape(bshape(data))

    def __call__(self, denoise_fn, data, E, generator: Optional[torch.Generator] = None,
                 noise=None, time=None, layers=None, rnd_normal=None, mask=None):
        """The loss of one batch.  ``noise`` (data's shape), ``time`` (B,)
        and ``rnd_normal`` (B,) are drawn from ``generator`` when absent;
        the sigma draw comes first, as the JAX package splits its key."""
        sigma = self.draw_sigma(data, generator, time=time, rnd_normal=rnd_normal)
        if noise is None:
            noise = randn(data.shape, generator, data.device)
        return self.loss_function(denoise_fn, data, E, sigma, noise, layers, mask=mask)

    def loss_function(self, denoise_fn, data, E, sigma, noise, layers, mask=None):
        raise NotImplementedError


class noise_pred(Loss):
    """Predict the noise (reference loss.py:181-195, same algebra including
    the double x0 transform)."""

    def loss_function(self, denoise_fn, data, E, sigma, noise, layers, mask=None):
        x_noisy = data + sigma * noise
        x0_pred = denoise_fn(x_noisy, E=E, sigma=sigma, layers=layers)
        x0_pred = data - sigma * x0_pred
        pred = (data - x0_pred) / sigma
        return self.reduce(pred, noise, torch.ones_like(pred), mask=mask)


class mean_pred(Loss):
    """Predict x0 directly with 1/sigma^2 weighting (reference :197-210)."""

    def loss_function(self, denoise_fn, data, E, sigma, noise, layers, mask=None):
        x_noisy = data + sigma * noise
        x0_pred = denoise_fn(x_noisy, E=E, sigma=sigma, layers=layers)
        weight = 1.0 / (sigma**2) * torch.ones_like(x0_pred)
        return self.reduce(x0_pred, data, weight, mask=mask)


class hybrid_weight(Loss):
    """EDM-style x0 target with (1 + 1/sigma^2) weighting (reference :163-179)."""

    def loss_function(self, denoise_fn, data, E, sigma, noise, layers, mask=None):
        x_noisy = data + sigma * noise
        x0_pred = denoise_fn(x_noisy, E=E, sigma=sigma, layers=layers)
        weight = (1.0 + 1.0 / sigma**2).reshape(bshape(data)) * torch.ones_like(x0_pred)
        return self.reduce(x0_pred, data, weight, mask=mask)


class minsnr(Loss):
    """Min-SNR weighting (arXiv:2303.09556), implemented as intended."""

    def __init__(self, config, n_steps, loss_type="l1"):
        super().__init__(config, n_steps, loss_type)
        self.gamma = float(config.get("MINSNR_GAMMA", 5.0))

    def loss_function(self, denoise_fn, data, E, sigma, noise, layers, mask=None):
        x_noisy = data + sigma * noise
        x0_pred = denoise_fn(x_noisy, E=E, sigma=sigma, layers=layers)
        snr = (self.sigma_data / sigma) ** 2
        weight = torch.clamp(snr, max=self.gamma) / snr
        weight = weight.reshape(bshape(data)) * torch.ones_like(x0_pred)
        return self.reduce(x0_pred, data, weight, mask=mask)


LOSS_REGISTRY = {
    "noise_pred": noise_pred,
    "mean_pred": mean_pred,
    "hybrid_weight": hybrid_weight,
    "minsnr": minsnr,
}


def get_loss(name: str):
    """Resolve a loss by its config name (``TRAINING_OBJ``)."""
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"loss '{name}' is not supported; pick from {list(LOSS_REGISTRY)}"
        ) from None
