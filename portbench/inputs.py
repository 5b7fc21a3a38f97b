"""Everything a run feeds the program and the reference, made from ``--seed``.

Each stream has a seed of its own, derived from the run's seed and a tag
(``sub_seed``), so that adding a stream never moves another.  Weights and
inputs are drawn on the run's device by a ``torch.Generator`` there, in one
call each, in float32, the type the program keeps its parameters in.

- Weights: every parameter of ``reference.unet.param_specs``, uniform in
  +-1/sqrt(fan_in) (torch's default), GroupNorm scales 1 + U(-0.1, 0.1) and
  shifts U(-0.1, 0.1).
- Incident energies: log-uniform over the configuration's [EMIN, EMAX],
  which the preprocessing maps to E uniform in [0, 1].
- Layer energies (layer-conditioned maps): the preprocessed total and
  per-layer energies, standard normals.
- Training showers: preprocessed voxels, standard normals.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.unet import cond_size, param_specs


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of run ``seed`` (any whole number)."""
    words = [int(seed) % 2**64, int(seed) // 2**64, *tags]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *tags: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


WEIGHTS, INPUTS, NOISE, TRAIN_DRAWS, SAMPLE = 1, 2, 3, 4, 5


def make_weights(config, seed: int, device) -> dict:
    """{name: float32 tensor} of the network, from one uniform draw."""
    specs = param_specs(config)
    total = sum(int(np.prod(shape)) for shape, _, _ in specs.values())
    u = torch.rand(total, generator=generator(seed, WEIGHTS, device=device), device=device)
    u = u.mul_(2).sub_(1)
    out, off = {}, 0
    for name, (shape, fan_in, kind) in specs.items():
        n = int(np.prod(shape))
        v = u[off:off + n].view(shape)
        off += n
        if kind == "norm_weight":
            out[name] = 1 + 0.1 * v
        elif kind == "norm_bias":
            out[name] = 0.1 * v
        else:
            out[name] = v * fan_in ** -0.5
    return out


def conditioning(config, batch: int, n: int, seed: int, device):
    """``n`` batches of (E (B, 1), layer energies (B, 1 + Z) or None)."""
    g = generator(seed, INPUTS, device=device)
    E = torch.rand((n, batch, 1), generator=g, device=device)
    layers = None
    if cond_size(config) > 1:
        layers = torch.randn((n, batch, cond_size(config) - 1), generator=g, device=device)
    return [(E[i], None if layers is None else layers[i]) for i in range(n)]


def showers(config, batch: int, n: int, seed: int, device) -> torch.Tensor:
    """``n`` batches of preprocessed training showers (n, B, 1, Z, A, R)."""
    g = generator(seed, INPUTS, 1, device=device)
    return torch.randn((n, batch, *config["SHAPE_PAD"][1:]), generator=g, device=device)


def call_seed(seed: int, call: int) -> int:
    """The seed of the start noise of generation call ``call``."""
    return sub_seed(seed, NOISE, call)


def start_noise(config, batch: int, seed: int, call: int, device) -> torch.Tensor:
    """The unit normals a sampler draws first in call ``call``, from a
    generator on ``device`` seeded with ``call_seed``: what the program draws
    from the generator the benchmark hands it."""
    g = torch.Generator(device=device).manual_seed(call_seed(seed, call))
    return torch.randn((batch, *config["SHAPE_PAD"][1:]), generator=g, device=device)
