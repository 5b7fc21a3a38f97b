"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, else the CUDA card.  With no device given and no
    CUDA present this raises: the port never falls back to the CPU unasked
    (pass ``device="cpu"`` to run there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "calodiffusion_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
