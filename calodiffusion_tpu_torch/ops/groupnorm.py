"""Fused GroupNorm + SiLU on channels-last activations.

``groupnorm_silu`` replaces ``calodiffusion_tpu/ops/pallas_groupnorm.py``
(same entry and channels-last ``(B, ..., C)`` layout).  On a CUDA tensor it
runs K5, the hand-written CUDA kernel ``csrc/groupnorm_silu.cu`` that
replaces ``_gn_silu_kernel``, or raises; on a CPU tensor its plain version
``gn_silu_reference``.  The JAX entry's ``force`` is not a parameter here:
the card always runs the kernel.

K5 is forward only, as in the JAX package: a backward through it raises and
says so.  The JAX kernel takes its variance in one pass, E[x^2] - mean^2
(pallas_groupnorm.py:44); K5 takes centred sums within chunks of a sample
and merges them (Chan's formula), as accurate as the two passes of the
plain version and the GroupNorm module.  Three launches (statistics,
merge, apply) and an f32 scratch of the chunks' partials and the samples'
statistics, which the wrapper allocates.

Bound on the card: device-memory bytes, x read once and the output written
once.
"""

from __future__ import annotations

import ctypes
import math

import torch

from calodiffusion_tpu_torch.ops import cuda_build

MAX_C = 384  # the kernel's widest row: its threads a block take a row's 16-byte vectors
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = cuda_build.DtypeKernel("groupnorm_silu", {
    "calo_groupnorm_silu_chunks": [_INT] * 3,
    "calo_groupnorm_silu_forward": [_PTR] * 5 + [_INT] * 5 + [ctypes.c_float, _INT, _INT, _PTR],
})


def _check(x, scale, bias, groups):
    if x.dim() < 2:
        raise ValueError(f"x must be (B, ..., C), got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if C > MAX_C or groups < 1 or C % groups or x.numel() == 0:
        raise ValueError(f"the kernel takes C <= {MAX_C} divisible by groups and a non-empty "
                         f"x, got shape {tuple(x.shape)}, groups {groups}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32, got {x.dtype}")
    per_vector = 16 // x.element_size()
    if C % per_vector:
        raise ValueError(f"the kernel reads 16-byte vectors: C must be a multiple of "
                         f"{per_vector} in {x.dtype}, got {C}")
    cuda_build.check_tensor("x", x, x.shape, x.dtype, x.device)
    cuda_build.check_tensor("scale", scale, (C,), torch.float32, x.device)
    cuda_build.check_tensor("bias", bias, (C,), torch.float32, x.device)
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector loads)")


def launch(lib, x, scale, bias, groups: int, eps: float, apply_silu: bool, steps: int = 0):
    """Allocate K5's output and its scratch and call ``lib``'s entry on
    checked inputs.  ``steps`` (1-8) sets the rows of a chunk, that many
    16-byte vectors a thread; 0 takes the kernel's own."""
    B, C = x.shape[0], x.shape[-1]
    S = math.prod(x.shape[1:-1])
    out = torch.empty_like(x)
    chunks = lib.calo_groupnorm_silu_chunks(S, C, steps)
    # the chunks' (mean, M2) partials, then each sample's (mean, rsqrt(var + eps)), per group
    part = torch.empty((max(chunks, 0) + 1) * B * groups * 2, dtype=torch.float32,
                       device=x.device)
    rc = lib.calo_groupnorm_silu_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(), part.data_ptr(), B, S,
        C, groups, int(x.dtype == torch.bfloat16), float(eps), int(apply_silu), steps,
        cuda_build.stream_of(x.device),
    )
    cuda_build.raise_on(rc, KERNEL.name, x)
    return out


def groupnorm_silu_forward(x, scale, bias, groups: int = 8, eps: float = 1e-5,
                           apply_silu: bool = True):
    """K5's wrapper: launches the kernel on CUDA tensors, counted in
    ``groupnorm_silu.launches``; the result carries no gradient."""
    _check(x, scale, bias, groups)
    lib = KERNEL.library(x)
    with cuda_build.on_device(x):
        out = launch(lib, x, scale, bias, groups, eps, apply_silu)
    groupnorm_silu.launches += 1
    return out


_GroupNormSiLU = cuda_build.forward_only(
    groupnorm_silu_forward, "groupnorm_silu's kernel (K5)", "pallas_groupnorm.py",
    "the GroupNorm module or gn_silu_reference")


def groupnorm_silu(x, scale, bias, groups: int = 8, eps: float = 1e-5,
                   apply_silu: bool = True):
    """silu(groupnorm(x)) over channels-last x (B, ..., C), bf16 or f32 on
    the card; scale and bias (C,) f32.  Statistics per sample and group
    over all positions and the group's channels, eps inside the rsqrt."""
    if x.device.type == "cpu":
        return gn_silu_reference(x, scale, bias, groups, eps, apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    return _GroupNormSiLU.apply(x, scale, bias, groups, eps, apply_silu)


groupnorm_silu.launches = 0  # kernel launches since the last reset


def gn_silu_reference(x, scale, bias, groups: int = 8, eps: float = 1e-5,
                      apply_silu: bool = True):
    """K5's plain version, the JAX package's ``_gn_silu_reference``
    (pallas_groupnorm.py:92-105): f32 statistics (two-pass variance), the
    affine and SiLU in f32, cast back to x's dtype."""
    xf = x.float()
    C = x.shape[-1]
    xg = xf.reshape(*x.shape[:-1], groups, C // groups)
    axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape) * scale + bias
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)
