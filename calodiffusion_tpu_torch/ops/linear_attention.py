"""Fused attention block ``x + GN1(LinearAttention(GN1(x)))``.

``fused_attention_block`` replaces the Pallas kernel
``calodiffusion_tpu/ops/pallas_linear_attention.py::_block_kernel`` (entry
``fused_attention_block``, same signature and ``(B, N, C)`` layout) with the
hand-written CUDA kernel ``csrc/linear_attention_block.cu``.

On a CUDA tensor the wrapper launches that kernel or raises; on a CPU tensor
it runs ``attention_block_reference``, the plain PyTorch version of the same
function that the tests and ``chip_smoke.py`` hold the kernel against.

Bound on the card: device-memory bytes.  The function reads x once and
writes the output once (2 * B * N * C elements); its matrix products are
about 6 * 1024 FLOPs per position, far below the tensor cores' rate per
byte.  See the source for the kernel's design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

DIM_HEAD = 32
_KERNEL = "linear_attention_block"
_SUPPORTED_C = (32, 64)


@functools.cache
def _library() -> ctypes.CDLL:
    from calodiffusion_tpu_torch.ops import cuda_build

    lib = cuda_build.load(_KERNEL)
    fn = lib.calo_attention_block_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_attention_block(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                          gn_post_scale, gn_post_bias, dim_head: int = DIM_HEAD,
                          eps: float = 1e-5):
    """x + GN1(LinearAttention(GN1(x))).  x: (B, N, C) bf16 or f32;
    w_qkv: (C, 3*32) and w_out: (32, C) in x's dtype; GroupNorm affines and
    b_out: (C,) f32.  heads = 1, dim_head = 32."""
    if x.device.type == "cpu":
        return attention_block_reference(
            x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
            gn_post_scale, gn_post_bias, dim_head, eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    if dim_head != DIM_HEAD:
        raise ValueError(f"the kernel takes dim_head {DIM_HEAD}, got {dim_head}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got shape {tuple(x.shape)}")
    B, N, C = x.shape
    if C not in _SUPPORTED_C or N < 1 or B < 1:
        raise ValueError(f"the kernel takes C in {_SUPPORTED_C} and B, N >= 1, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32, got {x.dtype}")
    dev = x.device
    _check("x", x, (B, N, C), x.dtype, dev)
    _check("w_qkv", w_qkv, (C, 3 * DIM_HEAD), x.dtype, dev)
    _check("w_out", w_out, (DIM_HEAD, C), x.dtype, dev)
    for name, t in (("gn_pre_scale", gn_pre_scale), ("gn_pre_bias", gn_pre_bias),
                    ("b_out", b_out), ("gn_post_scale", gn_post_scale),
                    ("gn_post_bias", gn_post_bias)):
        _check(name, t, (C,), torch.float32, dev)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (vector loads)")

    lib = _library()
    y_scr = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.calo_attention_block_forward(
            x.data_ptr(), gn_pre_scale.data_ptr(), gn_pre_bias.data_ptr(),
            w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
            gn_post_scale.data_ptr(), gn_post_bias.data_ptr(),
            y_scr.data_ptr(), out.data_ptr(), B, N, C,
            int(x.dtype == torch.bfloat16), float(eps), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{_KERNEL} kernel launch failed with CUDA error {rc} "
            f"(B, N, C = {B}, {N}, {C}; {x.dtype})"
        )
    fused_attention_block.launches += 1
    return out


fused_attention_block.launches = 0  # kernel launches since the last reset


# ---------------------------------------------------------------------------
# Plain PyTorch version: the same casts as the JAX package's
# attention_block_reference (pallas_linear_attention.py:776-795)
# ---------------------------------------------------------------------------

def group_norm1_reference(x, scale, bias, eps: float = 1e-5):
    """GroupNorm(num_groups=1) over (B, N, C): f32 statistics over (N, C)
    per sample, per-channel affine, cast back to x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * scale + bias).to(x.dtype)


def linear_attention_reference(x, w_qkv, w_out, b_out, dim_head: int = DIM_HEAD):
    """LinearAttention (heads = 1) of (B, N, C) x with its 1x1 convs as
    matrices: w_qkv (C, 3*D), w_out (D, C), b_out (C,)."""
    D = dim_head
    qkv = torch.einsum("bnc,ck->bnk", x, w_qkv.to(x.dtype))
    q, k, v = qkv.split(D, dim=-1)
    q = torch.softmax(q.float(), dim=-1).to(x.dtype)
    k = torch.softmax(k.float(), dim=1).to(x.dtype)
    q = q * (D ** -0.5)
    ctx = torch.einsum("bnd,bne->bde", k, v)
    out = torch.einsum("bde,bnd->bne", ctx, q)
    y = torch.einsum("bne,ec->bnc", out, w_out.to(x.dtype))
    return y + b_out.to(x.dtype)


def attention_block_reference(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out,
                              b_out, gn_post_scale, gn_post_bias,
                              dim_head: int = DIM_HEAD, eps: float = 1e-5):
    """Plain x + GN1(LinearAttention(GN1(x)))."""
    xn = group_norm1_reference(x, gn_pre_scale, gn_pre_bias, eps)
    y = linear_attention_reference(xn, w_qkv, w_out, b_out, dim_head)
    y = group_norm1_reference(y, gn_post_scale, gn_post_bias, eps)
    return x + y
