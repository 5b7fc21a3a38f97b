"""ControlNet-style conditioning of the shower U-Net.

Port of ``calodiffusion_tpu/models/controlnet.py``: a *control* U-Net
(``control_model``, built without an up path) reads the control image (e.g.
the energy-binned average shower) and returns its skip states and middle
output; each goes into the matching skip state (and the
middle) of the *base* U-Net (``model``) through a learnable scalar gate,
``(1 - mu) * h_base + mu * h_control``, with mu an f32 parameter
(``gate_mu_{i}``) initialised to 1e-6, so that the control branch starts
near a no-op.  As in the JAX package the f32 gate promotes the states it
mixes to f32; the next convolution casts them back to the compute dtype.

Training recipe: freeze the base (``freeze_base``, the set
``base_param_filter`` names) and train the control U-Net and the gates.
Inputs are NCDHW, as the port's ``CondUnet`` takes them.
"""

from __future__ import annotations

import torch
from torch import nn

from calodiffusion_tpu_torch.models.nn_modules import CondUnet

GATE_INIT = 1e-6


class ControlledUnet(nn.Module):
    """Base U-Net + control U-Net with gated hidden-state injection; both
    built from ``unet_kwargs`` (``CondUnet``'s arguments)."""

    def __init__(self, unet_kwargs: dict, dtype=torch.float32, generator=None):
        super().__init__()
        self.control_model = CondUnet(**unet_kwargs, down_only=True, dtype=dtype,
                                      generator=generator)
        self.model = CondUnet(**unet_kwargs, dtype=dtype, generator=generator)
        # one gate per skip state and one for the middle
        for i in range(self.model.num_resolutions + 1):
            self.register_parameter(f"gate_mu_{i}", nn.Parameter(torch.tensor(GATE_INIT)))

    def gates(self) -> list:
        return [getattr(self, f"gate_mu_{i}") for i in range(self.model.num_resolutions + 1)]

    def forward(self, x, x_control, cond=None, time=None):
        hiddens = self.control_model(x_control, cond=cond, time=time)

        def mix(mu):
            return lambda a, b: (1 - mu) * a.float() + mu * b.float()

        controls = [(mix(mu), h) for mu, h in zip(self.gates(), hiddens)]
        return self.model(x, cond=cond, time=time, controls=controls)


def base_param_filter(name: str) -> bool:
    """True for a base-model parameter (``model.*``), the set the JAX
    ``base_param_filter`` freezes for ControlNet training; the control
    U-Net's and the gates' are trained."""
    return name.startswith("model.")


def freeze_base(net: ControlledUnet) -> list:
    """Set ``requires_grad=False`` on the base U-Net's parameters; returns
    the names of the parameters left to train."""
    trained = []
    for name, p in net.named_parameters():
        p.requires_grad_(not base_param_filter(name))
        if p.requires_grad:
            trained.append(name)
    return trained
