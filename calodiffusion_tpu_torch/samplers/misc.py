"""Consistency and Bespoke Non-Stationary samplers.

Port of ``calodiffusion_tpu/samplers/misc.py`` (reference semantics:
calodiffusion/models/sample.py:957-1011, Consistency: few-step sampling at
fixed fractions of the consistency schedule; :1013-1122,
BespokeNonStationary, arXiv:2403.01329: a trainable per-step affine solver
theta[2, num_steps]).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import Sample, bshape, randn, sigma_like


class Consistency(Sample):
    def __init__(self, config):
        super().__init__(config)
        self.consis_nsteps = self.config.get("CONSIS_NSTEPS", 100)
        self.sigma_min = 0.002

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        # quirk preserved: sampling rebuilds the model's loss tables at
        # CONSIS_NSTEPS and restores them after (reference :971-1010)
        orig_steps = model.nsteps
        model.loss_function.update_step(self.consis_nsteps)
        sigmas_all = schedules.discrete_sigmas(self.consis_nsteps).astype(np.float64)

        n = self.consis_nsteps
        sample_idxs = [0, round(n * 0.5), round(n * 0.7), round(n * 0.9),
                       round(n * 0.95)]
        if num_steps > 1:
            t_steps = [float(sigmas_all[i]) for i in sample_idxs[:num_steps]]
        else:
            t_steps = [float(sigmas_all[0])]
        sigmas = t_steps + [0.0]

        x = start * sigmas[0]
        xs, x0s = [], []
        for sigma_cur, sigma_next in zip(sigmas[:-1], sigmas[1:]):
            x0 = denoise(x, sigma_like(x, sigma_cur))
            sigma_next = max(sigma_next, self.sigma_min)
            if sigma_next > self.sigma_min:
                inj = self.take_noise(1, x.shape, x.device)
                noise = self.noise(inj, 0, x.shape, generator, x.device)
                x = x0 + noise * math.sqrt(sigma_next**2 - self.sigma_min**2)
            else:
                x = x0
            if debug:
                xs.append(x)
                x0s.append(x0)

        model.loss_function.update_step(orig_steps)
        if debug:
            return x, torch.stack(xs), torch.stack(x0s)
        return x


class BespokeNonStationary(Sample):
    """Trainable affine per-step solver: x <- a_i x + b_i U(x)
    (reference :1013-1122).  theta is a (2, num_steps) f32 ``.npy`` file, the
    JAX package's format."""

    def __init__(self, config):
        super().__init__(config)
        self.theta = None

    def load_theta(self, num_steps):
        if self.theta is not None and self.theta.shape[1] == num_steps:
            return
        path = self.sample_config.get("SAMPLER_PATH")
        if path is None:
            flags = self.config.get("flags", {})
            data_folder = getattr(flags, "data_folder", None) or (
                flags.get("data_folder") if isinstance(flags, dict) else None
            )
            if data_folder:
                path = os.path.join(data_folder, "bns_sampler.npy")
        if self.sample_config.get("TRAIN_SAMPLER", False):
            raise RuntimeError(
                "theta not trained; call .train(model, loader, num_steps) "
                "before sampling"
            )
        if path is None or not os.path.exists(path):
            raise ValueError(
                "No sampler path provided, set it with 'SAMPLER_PATH' in the config"
            )
        self.theta = np.load(path)

    def train(self, model, loader, num_steps, generator=None):
        """Optimize theta against the PSNR objective (reference :1066-1105)
        on the model's device: Adam on theta alone, each iteration one pass
        over ``loader``'s (E, layers, showers) batches.  The per-step sigmas
        are fresh standard normals from ``generator``."""
        dev = model.device
        theta = torch.ones((2, num_steps), dtype=torch.float32, device=dev,
                           requires_grad=True)
        lr = self.sample_config.get("LR", 1e-3)
        max_iter = self.sample_config.get("MAX_ITER", 30)
        opt = torch.optim.Adam([theta], lr=lr, eps=1e-8)  # optax.adam's defaults

        def run_sampler(x, energy, layers):
            denoise = self.make_denoise_fn(model, energy, layers)
            for i in range(num_steps):
                sigma = randn((x.shape[0],), generator, dev).reshape(bshape(x))
                u = denoise(x, sigma)
                x = x * theta[0, i] + u * theta[1, i]
            return x

        def loss_fn(x, energy, layers):
            x_prime = run_sampler(x, energy, layers)
            mse = torch.mean((x - x_prime) ** 2)
            max_val = torch.amax(x, dim=-1)
            return 20 * torch.log10(torch.mean(max_val) / torch.sqrt(mse + 1e-12))

        def on_device(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        with torch.enable_grad():
            for _ in range(max_iter):
                for E, lay, d in loader:
                    loss = loss_fn(on_device(d), on_device(E),
                                   on_device(lay) if lay is not None else None)
                    # the gradient with respect to theta alone: the network's
                    # parameters accumulate nothing
                    (theta.grad,) = torch.autograd.grad(loss, theta)
                    opt.step()

        self.theta = theta.detach().cpu().numpy()
        path = self.sample_config.get("SAMPLER_PATH")
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.save(path, self.theta)
        return self.theta

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        self.load_theta(num_steps)
        if num_steps != self.theta.shape[1]:
            raise ValueError(
                "Number of steps must match the number of steps in the theta "
                "parameterization"
            )
        denoise = self.make_denoise_fn(model, energy, layers)
        bs = bshape(start)
        theta = np.asarray(self.theta[:, sample_offset:], np.float32)
        steps = theta.shape[1]

        # per-step sigma is a fresh standard normal per the reference's
        # model_fn (:1108-1110, "Don't really care about the noise
        # schedule"); injectable for trajectory parity
        inj = self.take_noise(steps, (start.shape[0],), start.device)
        if inj is None:
            inj = randn((steps, start.shape[0]), generator, start.device, batch_dim=1)
        sigmas = inj.reshape((steps,) + bs)

        x = start
        xs = []
        for i in range(steps):
            u = denoise(x, sigmas[i])
            x = x * float(theta[0, i]) + u * float(theta[1, i])
            if debug:
                xs.append(x)
        if debug:
            return x, torch.stack(xs), None
        return x
