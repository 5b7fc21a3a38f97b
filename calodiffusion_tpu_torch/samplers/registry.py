"""Sampler registry, keyed by the reference config's ``SAMPLER`` names
(reference: calodiffusion/utils/utils.py:1047-1061 load_attr), in the JAX
package's order."""

from __future__ import annotations

from calodiffusion_tpu_torch.samplers.ddpm import DDPM, DDim
from calodiffusion_tpu_torch.samplers.dpm import (
    DPM,
    DPMAdaptive,
    DPMPP2M,
    DPMPP2MSDE,
    DPMPP2S,
    DPMPP3MSDE,
    DPMPPSDE,
)
from calodiffusion_tpu_torch.samplers.edm import DPM2, LMS, Euler, Heun, Restart
from calodiffusion_tpu_torch.samplers.misc import BespokeNonStationary, Consistency

SAMPLER_REGISTRY = {
    "DDim": DDim,
    "DDPM": DDPM,
    "DPM": DPM,
    "DPMAdaptive": DPMAdaptive,
    "DPMPP2S": DPMPP2S,
    "DPMPPSDE": DPMPPSDE,
    "DPMPP2M": DPMPP2M,
    "DPMPP2MSDE": DPMPP2MSDE,
    "DPMPP3MSDE": DPMPP3MSDE,
    "LMS": LMS,
    "Euler": Euler,
    "Heun": Heun,
    "DPM2": DPM2,
    "Restart": Restart,
    "Consistency": Consistency,
    "BespokeNonStationary": BespokeNonStationary,
}


def get_sampler(name: str):
    try:
        return SAMPLER_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"sampler '{name}' is not supported; pick from {list(SAMPLER_REGISTRY)}"
        ) from None
