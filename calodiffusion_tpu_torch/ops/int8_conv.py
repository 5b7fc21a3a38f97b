"""The W8A8 int8 3D convolution of the sampling path, on the card: Q1.

``int8_conv3d`` replaces the XLA s8 x s8 -> s32 convolution of
``calodiffusion_tpu/ops/quant.py::int8_conv3d`` (and the stride-1 core of
its ``int8_conv3d_transpose``).  PyTorch has no int8 ``conv3d`` on CUDA, so
on a CUDA tensor it runs Q1, the hand-written kernel
``csrc/int8_conv3d.cu`` (an implicit GEMM on the s8 tensor cores, the
activations quantized as they are gathered), or raises; on a CPU tensor its
plain version ``int8_conv3d_reference``.  Launches are counted in
``int8_conv3d.launches``.

Both take NCDHW activations ``x`` (B, Cin, Z, A, R) in bf16 or f32, int8
weights ``wq`` (Cout, Cin, kz, ka, kr), the f32 per-output-channel
dequantization scale ``scale`` = sw * sx, an optional f32 ``bias`` and the
f32 reciprocal ``inv_sx`` of the static activation scale, and return
``cast(float(sum q(x) wq) * scale + bias)`` in x's dtype, with q(x) =
clip(rint(x * inv_sx), -127, 127) (round half to even).  The f32 results of
the two agree bit for bit: the s32 sums are exact in both and the
dequantization takes the same two roundings.  Forward only, as the JAX
package's int8 path, which training never reaches.

Bound on the card: device-memory bytes at ds2's shapes (x read once and y
written once in the activation dtype against ~2 Cin k^3 int8 operations an
output).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from calodiffusion_tpu_torch.ops import cuda_build
from calodiffusion_tpu_torch.ops.conv import triple

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = cuda_build.DtypeKernel("int8_conv3d", {
    "calo_int8_conv3d": [_PTR] * 5 + [_INT] * 19 + [ctypes.c_float, _INT, _PTR]})
# the plain version's float64 im2col products, a chunk of rows at a time
_REFERENCE_CHUNK = 1 << 26


def output_spatial(x_shape, kernel, stride, padding) -> tuple[int, int, int]:
    """(Zo, Ao, Ro) of a convolution of x (B, C, Z, A, R) with symmetric
    padding (the cylindrical wrap pads phi by the same amount)."""
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(x_shape[2:], kernel, triple(stride), triple(padding)))


def _check(x, wq, scale, bias, stride, padding, cylindrical):
    if x.dim() != 5 or wq.dim() != 5:
        raise ValueError(f"x must be (B, Cin, Z, A, R) and wq (Cout, Cin, kz, ka, kr), got "
                         f"{tuple(x.shape)} and {tuple(wq.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32 activations, got {x.dtype}")
    Cout, Cin = wq.shape[:2]
    if Cin != x.shape[1]:
        raise ValueError(f"x has {x.shape[1]} channels, wq takes {Cin}")
    pa = triple(padding)[1]
    if cylindrical and pa > x.shape[3]:
        raise ValueError(f"a phi wrap of {pa} on an axis of {x.shape[3]}")
    if min(output_spatial(x.shape, wq.shape[2:], stride, padding)) < 1:
        raise ValueError(f"no output for x {tuple(x.shape)} and kernel {tuple(wq.shape[2:])}")
    dev = x.device
    cuda_build.check_tensor("x", x, x.shape, x.dtype, dev)
    cuda_build.check_tensor("wq", wq, wq.shape, torch.int8, dev)
    cuda_build.check_tensor("scale", scale, (Cout,), torch.float32, dev)
    if bias is not None:
        cuda_build.check_tensor("bias", bias, (Cout,), torch.float32, dev)


def launch(lib, x, wq, scale, bias, inv_sx: float, stride=1, padding=0,
           cylindrical: bool = False):
    """Allocate Q1's output and call ``lib``'s entry on checked inputs."""
    B, Cin, Z, A, R = x.shape
    Cout, _, kz, ka, kr = wq.shape
    Zo, Ao, Ro = output_spatial(x.shape, (kz, ka, kr), stride, padding)
    y = torch.empty((B, Cout, Zo, Ao, Ro), dtype=x.dtype, device=x.device)
    rc = lib.calo_int8_conv3d(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        B, Cin, Z, A, R, Cout, kz, ka, kr, *triple(stride), *triple(padding),
        int(cylindrical), Zo, Ao, Ro, float(inv_sx), int(x.dtype == torch.bfloat16),
        cuda_build.stream_of(x.device),
    )
    cuda_build.raise_on(rc, KERNEL.name, x)
    return y


def int8_conv3d_forward(x, wq, scale, bias, inv_sx, stride, padding, cylindrical):
    """Q1's wrapper: launches the kernel on CUDA tensors, counted in
    ``int8_conv3d.launches``; the result carries no gradient."""
    _check(x, wq, scale, bias, stride, padding, cylindrical)
    lib = KERNEL.library(x)
    with cuda_build.on_device(x):
        y = launch(lib, x, wq, scale, bias, inv_sx, stride, padding, cylindrical)
    int8_conv3d.launches += 1
    return y


_Int8Conv3d = cuda_build.forward_only(
    int8_conv3d_forward, "int8_conv3d's kernel (Q1)", "ops/quant.py",
    "the float convolution (int8 runs only while sampling)")


def int8_conv3d(x, wq, scale, bias, inv_sx: float, stride=1, padding=0,
                cylindrical: bool = False):
    """W8A8 conv of x (B, Cin, Z, A, R) with int8 wq (Cout, Cin, kz, ka, kr):
    Q1 on the card, ``int8_conv3d_reference`` on the CPU."""
    if x.device.type == "cpu":
        return int8_conv3d_reference(x, wq, scale, bias, inv_sx, stride, padding, cylindrical)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3d: unsupported device {x.device}")
    return _Int8Conv3d.apply(x, wq, scale, bias, inv_sx, stride, padding, cylindrical)


int8_conv3d.launches = 0  # kernel launches since the last reset


def quantize_act(x, inv_sx: float):
    """clip(rint(x * inv_sx), -127, 127) as int8, the product in f32."""
    return torch.clamp(torch.round(x.float() * inv_sx), -127, 127).to(torch.int8)


def int8_sums(x, wq, inv_sx: float, stride=1, padding=0, cylindrical: bool = False):
    """The s32 sums of the convolution, (B, Cout, Zo, Ao, Ro) int32: x
    quantized, padded (phi circularly where cylindrical, the rest with
    zeros), unfolded to im2col and multiplied with wq in float64, exact."""
    B, Cin = x.shape[:2]
    Cout, _, kz, ka, kr = wq.shape
    sz, sa, sr = triple(stride)
    pz, pa, pr = triple(padding)
    xq = quantize_act(x, inv_sx)
    if cylindrical:
        if pa:
            xq = F.pad(xq, (0, 0, pa, pa, 0, 0), mode="circular")
        xq = F.pad(xq, (pr, pr, 0, 0, pz, pz))
    else:
        xq = F.pad(xq, (pr, pr, pa, pa, pz, pz))
    cols = xq.unfold(2, kz, sz).unfold(3, ka, sa).unfold(4, kr, sr)  # (B, Cin, Zo, Ao, Ro, k..)
    Zo, Ao, Ro = cols.shape[2:5]
    cols = cols.permute(0, 2, 3, 4, 1, 5, 6, 7).reshape(B * Zo * Ao * Ro, -1)
    wmat = wq.reshape(Cout, -1).double().t()
    step = max(1, _REFERENCE_CHUNK // cols.shape[1])
    acc = torch.cat([(cols[i:i + step].double() @ wmat).to(torch.int32)
                     for i in range(0, cols.shape[0], step)])
    return acc.reshape(B, Zo, Ao, Ro, Cout).permute(0, 4, 1, 2, 3).contiguous()


def int8_conv3d_reference(x, wq, scale, bias, inv_sx: float, stride=1, padding=0,
                          cylindrical: bool = False):
    """Q1's plain version: ``int8_sums`` dequantized as the kernel does,
    float(sum) * scale, plus bias, each in f32, cast to x's dtype."""
    acc = int8_sums(x, wq, inv_sx, stride, padding, cylindrical)
    y = acc.float() * scale.view(1, -1, 1, 1, 1)
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1, 1)
    return y.to(x.dtype)
