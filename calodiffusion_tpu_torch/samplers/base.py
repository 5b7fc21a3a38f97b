"""Sampler infrastructure.

Port of ``calodiffusion_tpu/samplers/base.py``.  Every sampler is a callable
``sampler(model, start, energy, layers, num_steps, sample_offset, generator,
debug)``; the model carries its own weights.  Per-step scalars are pure
functions of ``num_steps`` and the config, precomputed host-side as numpy
tables; the reverse trajectory is a Python loop on the model's device.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any

import numpy as np
import torch

# (lo, hi, n) while a rank draws for its rows [lo, hi) of a global batch of n
_ROWS: contextvars.ContextVar = contextvars.ContextVar("rows", default=None)


@contextlib.contextmanager
def row_shard(lo: int, hi: int, n: int):
    """Within it, every draw of ``randn``, ``randint`` and ``multinomial``
    and every row of an injected noise table whose batch dim has hi - lo
    rows is the draw of the whole batch of n rows, sliced to [lo, hi): a
    rank that holds rows [lo, hi) of a batch draws what one process would
    draw for them (the data axis of ``parallel/mesh.py``).  Rows at n and
    past it (the repeats that pad a batch) take row n - 1's draw."""
    token = _ROWS.set((lo, hi, n))
    try:
        yield
    finally:
        _ROWS.reset(token)


def _global_rows(shape, batch_dim: int):
    """(global shape, index) of a draw under ``row_shard``, else None."""
    rows = _ROWS.get()
    if rows is None or len(shape) <= batch_dim or shape[batch_dim] != rows[1] - rows[0]:
        return None
    lo, hi, n = rows
    full = tuple(shape[:batch_dim]) + (n,) + tuple(shape[batch_dim + 1:])
    take = slice(lo, hi) if hi <= n else torch.arange(lo, hi).clamp(max=n - 1)
    return full, (slice(None),) * batch_dim + (take,)


def bshape(x):
    return (x.shape[0],) + (1,) * (x.ndim - 1)


def randn(shape, generator: torch.Generator | None, device, batch_dim: int = 0) -> torch.Tensor:
    """Standard normals drawn on the generator's device, moved to
    ``device``; ``batch_dim``: the dim of the batch's rows (``row_shard``)."""
    gen_device = generator.device if generator is not None else device
    g = _global_rows(shape, batch_dim)
    if g is not None:
        return torch.randn(g[0], generator=generator, device=gen_device)[g[1]].to(device)
    return torch.randn(shape, generator=generator, device=gen_device).to(device)


def randint(high: int, rows: int, generator: torch.Generator | None, device) -> torch.Tensor:
    """``rows`` integers uniform in [0, high) on the generator's device."""
    gen_device = generator.device if generator is not None else device
    g = _global_rows((rows,), 0)
    if g is not None:
        return torch.randint(0, high, g[0], generator=generator, device=gen_device)[g[1]]
    return torch.randint(0, high, (rows,), generator=generator, device=gen_device)


def multinomial(probs: torch.Tensor, rows: int, generator: torch.Generator | None):
    """``rows`` draws with replacement from ``probs``."""
    g = _global_rows((rows,), 0)
    if g is not None:
        return torch.multinomial(probs, g[0][0], replacement=True, generator=generator)[g[1]]
    return torch.multinomial(probs, rows, replacement=True, generator=generator)


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
        rows = self._noise_table[self._noise_cursor:end]
        self._noise_cursor = end
        g = _global_rows((n, *shape), 1)
        if g is not None:  # a table of the global batch's rows
            rows = torch.from_numpy(np.ascontiguousarray(rows.reshape(g[0])))
            return rows[g[1]].to(device)
        return torch.from_numpy(rows.reshape((n, *shape))).to(device)

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
