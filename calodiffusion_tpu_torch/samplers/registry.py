"""Sampler registry, keyed by the reference config's ``SAMPLER`` names."""

from __future__ import annotations

from calodiffusion_tpu_torch.samplers.ddpm import DDPM, DDim

SAMPLER_REGISTRY = {
    "DDim": DDim,
    "DDPM": DDPM,
}


def get_sampler(name: str):
    try:
        return SAMPLER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"sampler '{name}' is not yet ported to calodiffusion_tpu_torch; "
            f"ported: {list(SAMPLER_REGISTRY)}"
        ) from None
