"""3D convolutions for cylindrical calorimeter grids, on cuDNN.

Port of ``calodiffusion_tpu/ops/conv.py``.  Activations are NCDHW
``(B, C, Z, A, R)``; A (alpha/phi) is the periodic axis.  Weights keep
torch's layouts: ``(C_out, C_in, kZ, kA, kR)`` for a convolution and
``(C_in, C_out, kZ, kA, kR)`` for a transpose convolution.

A cylindrical convolution pads phi circularly and Z/R with zeros
(reference: calodiffusion/models/models.py:25-96).  Transpose convolutions
are torch's own ``conv_transpose3d``: the JAX package decomposed them into
subpixel phases only to suit the TPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def triple(v) -> tuple[int, int, int]:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def wrap_pad_phi(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Circular padding of the phi axis (dim 3 of NCDHW)."""
    if pad == 0:
        return x
    return F.pad(x, (0, 0, pad, pad, 0, 0), mode="circular")


def conv3d(x, w, b=None, stride=1, padding=0):
    """Plain 3D conv with symmetric zero padding."""
    return F.conv3d(x, w, b, stride=triple(stride), padding=triple(padding))


def cylindrical_conv3d(x, w, b=None, stride=1, padding=0):
    """Conv3d with circular padding on phi, zero padding on Z and R."""
    pz, pa, pr = triple(padding)
    return F.conv3d(
        wrap_pad_phi(x, pa), w, b, stride=triple(stride), padding=(pz, 0, pr)
    )


def conv3d_transpose(x, w, b=None, stride=1, padding=0, output_padding=0):
    """ConvTranspose3d: out_i = (in_i-1)*s_i - 2*p_i + k_i + op_i."""
    return F.conv_transpose3d(
        x, w, b, stride=triple(stride), padding=triple(padding),
        output_padding=triple(output_padding),
    )


def cylindrical_conv3d_transpose(x, w, b=None, stride=1, padding=0,
                                 output_padding=0):
    """Cylindrical transpose conv: circular-pad phi by the *nominal*
    padding, then run the transpose conv with phi padding forced to
    ``k_phi - 1`` (which crops the excess) while Z/R keep the nominal
    padding (reference: models.py:25-62)."""
    pz, pa, pr = triple(padding)
    k_a = w.shape[3]
    return conv3d_transpose(
        wrap_pad_phi(x, pa), w, b, stride=stride, padding=(pz, k_a - 1, pr),
        output_padding=output_padding,
    )


# ---------------------------------------------------------------------------
# torch-default initializers: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with the
# fan-ins the JAX package uses (calodiffusion_tpu/ops/conv.py:244-266)
# ---------------------------------------------------------------------------

def uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)
