"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, else the CUDA card.  With no device given (or a
    CUDA one) and no CUDA present this raises: the port never falls back to
    the CPU unasked (pass ``device="cpu"``, on the CLIs ``--device cpu``, to
    run there)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "calodiffusion_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device
