"""The W8A8 int8 3D convolution of the sampling path, on the card: Q1.

``int8_conv3d`` replaces the XLA s8 x s8 -> s32 convolution of
``calodiffusion_tpu/ops/quant.py::int8_conv3d`` (and the stride-1 core of
its ``int8_conv3d_transpose``).  PyTorch has no int8 ``conv3d`` on CUDA, so
on a CUDA tensor it runs Q1, the hand-written kernels of
``csrc/int8_conv3d.cu`` (x quantized once into a padded channels-last int8
copy, then an implicit GEMM on the s8 tensor cores, wgmma, with the weights
resident in shared memory), or raises; on a CPU tensor its plain version
``int8_conv3d_reference``.  Launches are counted in
``int8_conv3d.launches``, one a convolution.

Both take activations ``x`` (B, Cin, Z, A, R) in bf16 or f32, in any
strides (NCDHW, or the channels-last view K1 leaves), int8 weights ``wq``
(Cout, Cin, kz, ka, kr), the f32 per-output-channel dequantization scale
``scale`` = sw * sx, an optional f32 ``bias`` and the f32 reciprocal
``inv_sx`` of the static activation scale, and return
``cast(float(sum q(x) wq) * scale + bias)`` in x's dtype, with q(x) =
clip(rint(x * inv_sx), -127, 127) (round half to even).  The f32 results of
the two agree bit for bit: the s32 sums are exact in both and the
dequantization takes the same two roundings.  ``wq`` may be an
``Int8Weights``, which keeps the weights in the order the kernel reads them
(``kernel_weights``) once it has made them: a caller that keeps one a
weight version reorders them once.  Forward only, as the JAX package's int8
path, which training never reaches: on the card a call that would need a
gradient raises.

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
_STRIDES = [ctypes.c_longlong] * 5
KERNEL = cuda_build.DtypeKernel("int8_conv3d", {
    "calo_int8_conv3d": [_PTR] + _STRIDES + [_PTR] * 5 + [_INT] * 19
                        + [ctypes.c_float, _INT, _INT, _PTR],
    "calo_int8_quantize_pad": [_PTR] + _STRIDES + [_PTR] + [_INT] * 9
                              + [ctypes.c_float, _INT, _PTR],
    "calo_int8_conv3d_plan": [_INT] * 20 + [ctypes.POINTER(_INT)]})
# the GEMM's plans (the kernel's Mode): picked by shape, or forced by a test
PLANS = {"auto": 0, "window": 1, "gather": 2, "stream": 3}
PLAN_NAMES = {v: k for k, v in PLANS.items()}
# the plain version's float64 im2col products, a chunk of rows at a time
_REFERENCE_CHUNK = 1 << 26


def output_spatial(x_shape, kernel, stride, padding) -> tuple[int, int, int]:
    """(Zo, Ao, Ro) of a convolution of x (B, C, Z, A, R) with symmetric
    padding (the cylindrical wrap pads phi by the same amount)."""
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(x_shape[2:], kernel, triple(stride), triple(padding)))


def padded_channels(cin: int) -> int:
    """Cin rounded up to a multiple of 32: the channels of Q1's int8 copy of
    x and of its weights' image."""
    return -(-cin // 32) * 32


def kernel_weights(wq):
    """wq (Cout, Cin, kz, ka, kr) in the order Q1's GEMM reads it: (Cout, kz,
    ka, kr, Cp) int8, contiguous, the channels zero-padded to
    ``padded_channels(Cin)``; the order of an exact integer sum changes
    nothing."""
    cin = wq.shape[1]
    return F.pad(wq.permute(0, 2, 3, 4, 1), (0, padded_channels(cin) - cin)).contiguous()


class Int8Weights:
    """Int8 weights ``wq`` (Cout, Cin, kz, ka, kr) and, made at Q1's first
    launch with them and kept, ``kernel_weights(wq)``."""

    __slots__ = ("wq", "_kernel")

    def __init__(self, wq):
        self.wq, self._kernel = wq, None

    @classmethod
    def of(cls, wq) -> "Int8Weights":
        """``wq`` itself if it is an ``Int8Weights``, else one holding it."""
        return wq if isinstance(wq, cls) else cls(wq)

    def kernel(self):
        """``kernel_weights(wq)``, made once."""
        if self._kernel is None:
            self._kernel = kernel_weights(self.wq)
        return self._kernel


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
    cuda_build.check_tensor("wq", wq, wq.shape, torch.int8, dev)
    cuda_build.check_tensor("scale", scale, (Cout,), torch.float32, dev)
    if bias is not None:
        cuda_build.check_tensor("bias", bias, (Cout,), torch.float32, dev)


def padded_copy(x, padding):
    """An empty int8 (B, Zp, Ap, Rp, Cp) for Q1's quantized copy of x."""
    B, Cin, Z, A, R = x.shape
    pz, pa, pr = triple(padding)
    return torch.empty((B, Z + 2 * pz, A + 2 * pa, R + 2 * pr, padded_channels(Cin)),
                       dtype=torch.int8, device=x.device)


def launch_quantize(lib, x, inv_sx: float, padding=0, cylindrical: bool = False):
    """Q1's first kernel alone: x quantized into its padded channels-last
    int8 copy (B, Zp, Ap, Rp, Cp), zeros in the pads and past Cin, phi
    wrapped where cylindrical."""
    xq = padded_copy(x, padding)
    rc = lib.calo_int8_quantize_pad(x.data_ptr(), *x.stride(), xq.data_ptr(), *x.shape,
                                    *triple(padding), int(cylindrical), float(inv_sx),
                                    int(x.dtype == torch.bfloat16),
                                    cuda_build.stream_of(x.device))
    cuda_build.raise_on(rc, KERNEL.name, x)
    return xq


def kernel_plan(lib, x_shape, w_shape, stride=1, padding=0, cylindrical: bool = False,
                plan: str = "auto") -> dict:
    """The plan Q1's GEMM takes for a convolution on the current device
    (``lib``'s plan entry; nothing launched): ``mode`` ("window", "gather",
    or "stream": the gather with the weights streamed, where they do not fit
    resident), the channel tile ``NT``, the row tiles of 128 a CTA ``MW``
    and the CTA's ``smem_bytes``; ``plan`` forces a mode as in ``launch``."""
    B, Cin, Z, A, R = x_shape
    Cout, _, kz, ka, kr = w_shape
    Zo, Ao, Ro = output_spatial(x_shape, (kz, ka, kr), stride, padding)
    out = (_INT * 4)()
    rc = lib.calo_int8_conv3d_plan(B, Cin, Z, A, R, Cout, kz, ka, kr, *triple(stride),
                                   *triple(padding), int(cylindrical), Zo, Ao, Ro, PLANS[plan],
                                   out)
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: {KERNEL.name} has no plan for x {x_shape}, "
                           f"w {w_shape} (CUDA error {rc})")
    return dict(mode=PLAN_NAMES[out[0]], NT=out[1], MW=out[2], smem_bytes=out[3])


def launch(lib, x, wq, scale, bias, inv_sx: float, stride=1, padding=0,
           cylindrical: bool = False, plan: str = "auto"):
    """Allocate Q1's output and its int8 copy of x and call ``lib``'s entry
    on checked inputs; ``wq``: a tensor or an ``Int8Weights``; ``plan``:
    one of ``PLANS`` (the tests force each)."""
    weights = Int8Weights.of(wq)
    B, Cin, Z, A, R = x.shape
    Cout, _, kz, ka, kr = weights.wq.shape
    wk = weights.kernel()
    cuda_build.check_tensor("wk", wk, (Cout, kz, ka, kr, padded_channels(Cin)), torch.int8,
                            x.device)
    Zo, Ao, Ro = output_spatial(x.shape, (kz, ka, kr), stride, padding)
    xq = padded_copy(x, padding)
    y = torch.empty((B, Cout, Zo, Ao, Ro), dtype=x.dtype, device=x.device)
    rc = lib.calo_int8_conv3d(
        x.data_ptr(), *x.stride(), xq.data_ptr(), wk.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        B, Cin, Z, A, R, Cout, kz, ka, kr, *triple(stride), *triple(padding),
        int(cylindrical), Zo, Ao, Ro, float(inv_sx), PLANS[plan],
        int(x.dtype == torch.bfloat16), cuda_build.stream_of(x.device),
    )
    cuda_build.raise_on(rc, KERNEL.name, x)
    return y


_FORWARD_ONLY = cuda_build.forward_only_message(
    "int8_conv3d's kernel (Q1)", "ops/quant.py",
    "the float convolution (int8 runs only while sampling)")


def int8_conv3d_forward(x, wq, scale, bias, inv_sx, stride, padding, cylindrical):
    """Q1's wrapper: launches the kernels on CUDA tensors, counted in
    ``int8_conv3d.launches``; the result carries no gradient, and a call
    that would need one raises."""
    weights = Int8Weights.of(wq)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias)):
        raise ValueError(_FORWARD_ONLY)
    _check(x, weights.wq, scale, bias, stride, padding, cylindrical)
    lib = KERNEL.library(x)
    with cuda_build.on_device(x):
        y = launch(lib, x, weights, scale, bias, inv_sx, stride, padding, cylindrical)
    int8_conv3d.launches += 1
    return y


def int8_conv3d(x, wq, scale, bias, inv_sx: float, stride=1, padding=0,
                cylindrical: bool = False):
    """W8A8 conv of x (B, Cin, Z, A, R) with int8 wq (Cout, Cin, kz, ka, kr),
    a tensor or an ``Int8Weights``: Q1 on the card,
    ``int8_conv3d_reference`` on the CPU."""
    if x.device.type == "cpu":
        return int8_conv3d_reference(x, Int8Weights.of(wq).wq, scale, bias, inv_sx, stride,
                                     padding, cylindrical)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3d: unsupported device {x.device}")
    return int8_conv3d_forward(x, wq, scale, bias, inv_sx, stride, padding, cylindrical)


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
