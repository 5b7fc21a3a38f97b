"""Post-training W8A8 int8 quantization of the sampling path.

Port of ``calodiffusion_tpu/ops/quant.py``: per-output-channel symmetric
int8 weights, per-tensor static activation scales from a calibration pass
(``CaloDiffusion.prepare_int8``), and the ``QUANT_INT8_EXCLUDE`` matching.
The U-Net's quantizable convolutions (``nn_modules.quantizable_convs``)
hold their own activation scale, ``None`` when they run in float: there is
no module-level table here.  Training and the validation loss never run
int8.

The numerics are the JAX package's, in its order: weights are quantized
from their values in the layer's dtype read as f32, ``wq = clip(rint(w /
sw), +-127)`` with ``sw = max(|w|, 1e-12) / 127`` per output channel; an
activation is ``clip(rint(x * f32(1 / sx)), +-127)``; the output is
``float(sum) * (sw * f32(sx)) + bias``, each in f32, cast to the
activation dtype.  ``rint`` rounds half to even, as ``jnp.round``.

Gating departs from the JAX package on purpose: it runs int8 only on a TPU
or under ``CALODIFF_INT8=force`` (quant.py:48-52), while the port runs it
wherever ``QUANT_INT8`` is set, Q1 on the card and its plain version on the
CPU, like every port kernel.  ``CALODIFF_INT8=0`` still turns it off and
``CALODIFF_INT8_TRANSPOSE=1`` still opts the upsampling transposes in.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from calodiffusion_tpu_torch.ops import int8_conv

# a scale of this value runs the conv with int8-dequantized weights and
# float activations (W8A16): the diagnostic that splits weight from
# activation quantization error
WEIGHT_ONLY = "w8a16"


def int8_allowed() -> bool:
    """False only under ``CALODIFF_INT8=0``."""
    return os.environ.get("CALODIFF_INT8", "1") != "0"


def transpose_allowed() -> bool:
    """Whether the upsampling transposes quantize (``CALODIFF_INT8_TRANSPOSE=1``)."""
    return os.environ.get("CALODIFF_INT8_TRANSPOSE") == "1"


def path_matches(path: str, pattern: str) -> bool:
    """Segment-boundary containment for ``QUANT_INT8_EXCLUDE`` patterns: the
    pattern's "/"-separated segments must appear as a contiguous run of
    full segments of the module path, so "CondUnet_0/Conv3d_1" does not
    catch Conv3d_10 and "ResnetBlock_1/" not ResnetBlock_10; a trailing "/"
    matches any descendant."""
    psegs = [s for s in path.split("/") if s]
    msegs = [s for s in pattern.split("/") if s]
    if not msegs:
        return False
    return any(psegs[i:i + len(msegs)] == msegs for i in range(len(psegs) - len(msegs) + 1))


def scales_from_absmax(absmax: dict, margin: float = 1.0) -> dict:
    """{path: input abs-max} -> {path: activation scale},
    max(absmax * margin, 1e-8) / 127, in Python floats (the JAX package's
    ``scales_from_stats`` on its flattened collection)."""
    return {path: max(float(a) * margin, 1e-8) / 127.0 for path, a in absmax.items()}


def merge_stats(a: dict, b: dict) -> dict:
    """Elementwise max of two {path: scale} tables."""
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


def quantize_weight_per_cout(w):
    """(Cout, ...) float -> (int8 weights, f32 (Cout,) scales), the scale of
    each output channel over all its other dims."""
    wf = w.float()
    a = wf.abs().amax(dim=tuple(range(1, wf.dim())))
    sw = torch.clamp_min(a, 1e-12) / 127.0
    wq = torch.clamp(torch.round(wf / sw.view(-1, *(1,) * (wf.dim() - 1))), -127, 127)
    return wq.to(torch.int8), sw


def dequantized_weight(w):
    """Fake-quantize: weights through the per-cout int8 grid and back, f32."""
    wq, sw = quantize_weight_per_cout(w)
    return wq.float() * sw.view(-1, *(1,) * (w.dim() - 1))


def inv_scale(sx: float) -> float:
    """1 / sx in double, rounded once to f32 (JAX's weak-typed ``1.0 / scale``)."""
    return float(np.float32(1.0 / sx))


def dequant_scale(sw, sx: float):
    """The f32 per-cout product sw * f32(sx) that dequantizes the s32 sums
    (sx rounded to f32 first, as JAX's weak-typed ``sw * sx``)."""
    return sw * float(np.float32(sx))


def quantize_act(x, scale: float):
    """Float activations -> int8 with a static per-tensor scale."""
    return int8_conv.quantize_act(x, inv_scale(scale))


def int8_conv3d(x, w, b, sx: float, stride=1, padding=0, cylindrical: bool = False):
    """The JAX package's ``int8_conv3d`` on NCDHW tensors: x (B, Cin, Z, A,
    R) in the layer's dtype, w (Cout, Cin, kz, ka, kr) and b (Cout,) or
    None in the layer's dtype, sx the static activation scale.  Returns x's
    dtype: dequant(s8 conv) = s32 * (sw * sx) + b."""
    wq, sw = quantize_weight_per_cout(w)
    return int8_conv.int8_conv3d(
        x, wq, dequant_scale(sw, sx), None if b is None else b.float(), inv_scale(sx),
        stride, padding, cylindrical)
