"""3D convolutions for cylindrical calorimeter grids, on cuDNN.

Port of ``calodiffusion_tpu/ops/conv.py``.  Activations are NCDHW
``(B, C, Z, A, R)``; A (alpha/phi) is the periodic axis.  Weights keep
torch's layouts: ``(C_out, C_in, kZ, kA, kR)`` for a convolution and
``(C_in, C_out, kZ, kA, kR)`` for a transpose convolution.

A cylindrical convolution pads phi circularly and Z/R with zeros
(reference: calodiffusion/models/models.py:25-96).  Transpose convolutions
are torch's own ``conv_transpose3d``: the JAX package decomposed them into
subpixel phases only to suit the TPU.  The int8 transpose of the sampling
path (``int8_conv3d_transpose``) does decompose them, as the JAX package's
does, so that each (phase, output channel) carries its own weight scale;
its stride-1 core is the int8 conv of ``ops/int8_conv.py``.
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


def conv3d(x, w, b=None, stride=1, padding=0, groups=1):
    """Plain 3D conv with symmetric zero padding (``groups`` C: depthwise)."""
    return F.conv3d(x, w, b, stride=triple(stride), padding=triple(padding), groups=groups)


def cylindrical_conv3d(x, w, b=None, stride=1, padding=0, groups=1):
    """Conv3d with circular padding on phi, zero padding on Z and R."""
    pz, pa, pr = triple(padding)
    return F.conv3d(
        wrap_pad_phi(x, pa), w, b, stride=triple(stride), padding=(pz, 0, pr), groups=groups
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


def subpixel_weight(w, stride):
    """A transpose conv's weight (Cin, Cout, kz, ka, kr) -> the stride-1
    conv weight (sz sa sr Cout, Cin, Lz, La, Lr) of its phase decomposition,
    L = ceil(k / s) (calodiffusion_tpu/ops/conv.py:108-186): output channel
    ((qz sa + qa) sr + qr) Cout + co holds phase q's sub-kernel W[q + s j],
    zero-padded to L taps and flipped for the correlation."""
    sz, sa, sr = triple(stride)
    c_in, c_out, kz, ka, kr = w.shape
    Lz, La, Lr = -(-kz // sz), -(-ka // sa), -(-kr // sr)
    wp = w.new_zeros((c_in, c_out, Lz * sz, La * sa, Lr * sr))
    wp[:, :, :kz, :ka, :kr] = w
    sub = wp.reshape(c_in, c_out, Lz, sz, La, sa, Lr, sr).flip(2, 4, 6)
    return sub.permute(3, 5, 7, 1, 0, 2, 4, 6).reshape(sz * sa * sr * c_out, c_in, Lz, La, Lr)


def int8_conv3d_transpose(x, w, b, sx: float, stride=1, padding=0, output_padding=0,
                          cylindrical: bool = False, quantized=None):
    """The int8 counterpart of ``conv3d_transpose`` / ``cylindrical_conv3d_transpose``
    (calodiffusion_tpu/ops/quant.py:205-241): the subpixel decomposition
    with the int8 conv as its stride-1 core, zero pads L - 1 on each side.
    Each phase's sub-kernel is quantized per output channel; the core's
    output is dequantized (no bias) and cast to x's dtype before the phases
    interleave, and the bias is added after the crop, in x's dtype.
    ``quantized``: the (wq, sw) of ``subpixel_weight(w, stride)``, wq a
    tensor or an ``int8_conv.Int8Weights``, else computed here.  At stride 1
    it falls back to the float transpose."""
    from calodiffusion_tpu_torch.ops import int8_conv, quant

    stride, padding = triple(stride), triple(padding)
    output_padding = triple(output_padding)
    if all(s == 1 for s in stride):
        op = cylindrical_conv3d_transpose if cylindrical else conv3d_transpose
        return op(x, w, b, stride=stride, padding=padding, output_padding=output_padding)
    if cylindrical:
        x = wrap_pad_phi(x, padding[1])
        padding = (padding[0], w.shape[3] - 1, padding[2])
    sz, sa, sr = stride
    c_out, k = w.shape[1], w.shape[2:]
    L = [-(-k[i] // stride[i]) for i in range(3)]
    wq, sw = quantized if quantized is not None else quant.quantize_weight_per_cout(
        subpixel_weight(w, stride))
    y = int8_conv.int8_conv3d(x, wq, quant.dequant_scale(sw, sx), None, quant.inv_scale(sx), 1,
                              [l - 1 for l in L], False)
    B, _, tz, ta, tr = y.shape
    # interleave: index m = t s + q
    y = y.reshape(B, sz, sa, sr, c_out, tz, ta, tr).permute(0, 4, 5, 1, 6, 2, 7, 3)
    y = y.reshape(B, c_out, tz * sz, ta * sa, tr * sr)
    starts, stops = [], []
    for i in range(3):
        M = (x.shape[2 + i] - 1) * stride[i] + k[i]
        starts.append(padding[i])
        stops.append(M - padding[i] + output_padding[i])
    need = [max(0, stops[i] - y.shape[2 + i]) for i in range(3)]
    if any(need):
        y = F.pad(y, (0, need[2], 0, need[1], 0, need[0]))
    y = y[:, :, starts[0]:stops[0], starts[1]:stops[1], starts[2]:stops[2]]
    if b is not None:
        y = y + b.view(1, -1, 1, 1, 1)
    return y


# ---------------------------------------------------------------------------
# torch-default initializers: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), with the
# fan-ins the JAX package uses (calodiffusion_tpu/ops/conv.py:244-266)
# ---------------------------------------------------------------------------

def uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator | None):
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)
