"""Sampler infrastructure.

Port of ``calodiffusion_tpu/samplers/base.py``.  Every sampler is a callable
``sampler(model, start, energy, layers, num_steps, sample_offset, generator,
debug)``; the model carries its own weights.  Per-step scalars are pure
functions of ``num_steps`` and the config, precomputed host-side as numpy
tables; the reverse trajectory is a Python loop on the model's device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def bshape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def randn(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard normals drawn on the generator's device, moved to ``device``."""
    gen_device = generator.device if generator is not None else device
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def sigma_like(x, sigma) -> torch.Tensor:
    """A per-sample (B, 1, ..., 1) f32 sigma of value ``sigma`` on x's device."""
    return torch.full(bshape(x), float(sigma), dtype=torch.float32, device=x.device)


class Sample:
    def __init__(self, config: dict) -> None:
        self.config = config
        self.sample_config = config.get("SAMPLER_OPTIONS", {})
        self._noise_table: np.ndarray | None = None
        self._noise_cursor = 0

    # -- deterministic noise injection (parity testing / reproducibility) ---
    def set_noise_table(self, table) -> None:
        """Override random normals with rows of ``table`` (consumed in draw
        order): each stochastic draw of a full sample-shaped normal takes
        one row, so a test can walk the JAX sampler's stochastic path."""
        self._noise_table = np.asarray(table, dtype=np.float32)
        self._noise_cursor = 0

    @property
    def noise_draws(self) -> int:
        """Rows consumed from the injected table so far."""
        return self._noise_cursor

    def take_noise(self, n: int, shape, device) -> torch.Tensor | None:
        """Next ``n`` injected draws as an (n, *shape) tensor on ``device``,
        or None when no table is set (use random normals)."""
        if self._noise_table is None:
            return None
        end = self._noise_cursor + n
        if end > len(self._noise_table):
            raise ValueError(
                f"noise table exhausted: need {n} more draws at cursor "
                f"{self._noise_cursor}, table has {len(self._noise_table)}"
            )
        rows = self._noise_table[self._noise_cursor:end].reshape((n, *shape))
        self._noise_cursor = end
        return torch.from_numpy(rows).to(device)

    def noise(self, inj, i, shape, generator, device) -> torch.Tensor:
        """Row ``i`` of ``inj`` (from ``take_noise``), else a fresh standard
        normal from ``generator``."""
        return inj[i] if inj is not None else randn(shape, generator, device)

    def make_denoise_fn(self, model, energy, layers):
        def denoise(x, sigma):
            return model.denoise(x, E=energy, sigma=sigma, layers=layers)

        return denoise

    def __call__(
        self, model, start, energy, layers, num_steps, sample_offset,
        generator, debug=False,
    ) -> Any:
        raise NotImplementedError
