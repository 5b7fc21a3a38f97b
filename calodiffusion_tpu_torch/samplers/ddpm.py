"""DDIM / DDPM ancestral samplers.

Port of ``calodiffusion_tpu/samplers/ddpm.py`` (reference semantics:
calodiffusion/models/sample.py:29-121, DDim with eta=0, DDPM = eta=1,
cosine discrete schedule).  Per-step coefficients are f32 numpy tables; the
reverse loop runs one ``denoise`` per step.
"""

from __future__ import annotations

import numpy as np
import torch

from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import Sample, bshape, randn


class DDim(Sample):
    ddim_eta = 0.0

    def _step_tables(self, num_steps: int, sample_offset: int):
        t = schedules.ddpm_tables(num_steps)
        acp = t["alphas_cumprod"].astype(np.float64)
        acp_prev = t["alphas_cumprod_prev"].astype(np.float64)
        sa = t["sqrt_alphas_cumprod"].astype(np.float64)
        s1m = t["sqrt_one_minus_alphas_cumprod"].astype(np.float64)

        steps = np.arange(num_steps)[::-1]
        if sample_offset > 0:
            steps = steps[sample_offset:]

        sigma = s1m[steps] / sa[steps]
        alpha = acp[steps]
        alpha_prev = acp_prev[steps]
        denom = sa[np.maximum(steps - 1, 0)]
        ddim_sigma = self.ddim_eta * (
            ((1 - alpha_prev) / (1 - alpha)) * (1 - alpha / alpha_prev)
        ) ** 0.5
        num = np.sqrt(1.0 - alpha_prev - ddim_sigma**2)
        sigma_prev = num / denom
        mask = (steps > 0).astype(np.float64)
        return {
            "sigma": sigma.astype(np.float32),
            "sigma_prev": sigma_prev.astype(np.float32),
            "noise_coeff": (ddim_sigma / denom).astype(np.float32),
            "mask": mask.astype(np.float32),
        }

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ):
        denoise = self.make_denoise_fn(model, energy, layers)
        tabs = self._step_tables(num_steps, sample_offset)
        # f32 products, as the JAX sampler's f32 table rows multiply
        step_coeff = tabs["mask"] * tabs["sigma_prev"]
        bs = bshape(start)
        dev = start.device

        x = start * float(tabs["sigma"][0])
        stochastic = self.ddim_eta != 0.0
        inj = (
            self.take_noise(len(tabs["sigma"]), start.shape, dev)
            if stochastic else None
        )
        xs, x0s = [], []
        for i in range(len(tabs["sigma"])):
            sigma_b = torch.full(bs, float(tabs["sigma"][i]), device=dev)
            x0_pred = denoise(x, sigma_b)
            noise_pred = (x - x0_pred) / sigma_b
            step = x0_pred + float(step_coeff[i]) * noise_pred
            if stochastic:
                noise = inj[i] if inj is not None else randn(x.shape, generator, dev)
                step = step + float(tabs["noise_coeff"][i]) * noise
            if debug:
                xs.append(step)
                x0s.append(x0_pred)
            x = step
        if debug:
            return x, torch.stack(xs), torch.stack(x0s)
        return x


class DDPM(DDim):
    ddim_eta = 1.0
