"""Softmax attention over the flattened voxel grid, blockwise on the card.

``blockwise_attention`` replaces ``calodiffusion_tpu/ops/pallas_attention.py``
(same entry and ``(B, H, N, D)`` layout).  On a CUDA tensor it runs K4, the
hand-written CUDA kernel ``csrc/blockwise_attention.cu`` that replaces
``_attention_kernel``, at every N, or raises; on a CPU tensor the dense
formulation ``dense_attention``, K4's plain version.  The JAX entry's
dense branch for N <= 2048 (pallas_attention.py:98-102), which leaves the
work to XLA, is not carried over, just as the port's K1 and K3 run at every
N.  The TPU kernel's tile sizes (``block_q``/``block_k``) are not
parameters here: K4 tiles by its own.

K4 is forward only, as in the JAX package, which defines no VJP for it: a
backward through it raises and says so.  On the CPU autograd
differentiates the dense formulation.

Bound on the card: at D = 32 one exponential per score against 4 D FLOPs of
the two products, so the special-function units bound the bf16 work and
the CUDA cores' f32 rate the f32 work (``chip_smoke.py`` computes both).
"""

from __future__ import annotations

import ctypes

import torch

from calodiffusion_tpu_torch.ops import cuda_build

HEAD_DIM = 32
_PTR = ctypes.c_void_p
KERNEL = cuda_build.DtypeKernel(
    "blockwise_attention", "calo_blockwise_attention_forward",
    [_PTR] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, _PTR])


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    B, H, N, D = q.shape
    if D != HEAD_DIM or min(B, H, N) < 1:
        raise ValueError(f"the kernel takes D = {HEAD_DIM} and B, H, N >= 1, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        cuda_build.check_tensor(name, t, q.shape, q.dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector loads)")


def launch(lib, q, k, v):
    """Allocate K4's output and call ``lib``'s entry on checked inputs."""
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    rc = lib.calo_blockwise_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, N, D,
        int(q.dtype == torch.bfloat16), D ** -0.5, cuda_build.stream_of(q.device),
    )
    cuda_build.raise_on(rc, KERNEL.name, q)
    return out


def blockwise_attention_forward(q, k, v):
    """K4's wrapper: launches the kernel on CUDA tensors, counted in
    ``blockwise_attention.launches``; the result carries no gradient."""
    _check(q, k, v)
    lib = KERNEL.library(q)
    with cuda_build.on_device(q):
        out = launch(lib, q, k, v)
    blockwise_attention.launches += 1
    return out


_BlockwiseAttention = cuda_build.forward_only(
    blockwise_attention_forward, "blockwise_attention's kernel (K4)", "pallas_attention.py",
    "dense_attention (the plain version, which blockwise_attention runs on CPU tensors)")


def blockwise_attention(q, k, v):
    """Softmax attention over (B, H, N, D) tensors, scale D^-1/2: K4 (D =
    32, bf16 or f32, forward only) on the card, the dense formulation on
    the CPU."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"blockwise_attention: unsupported device {q.device}")
    return _BlockwiseAttention.apply(q, k, v)


blockwise_attention.launches = 0  # kernel launches since the last reset


def dense_attention(q, k, v, q_rows: int | None = None):
    """K4's plain version, the JAX package's ``_dense_attention``
    (pallas_attention.py:70-77): f32 scores of the scaled q against k, max
    subtracted, softmax, times v, cast to q's dtype.  ``q_rows`` computes it
    over chunks of that many query rows, to bound the score tensor's memory
    at large N."""
    scale = q.shape[-1] ** -0.5
    if q_rows is not None and q.shape[2] > q_rows:
        return torch.cat([dense_attention(q[:, :, i:i + q_rows], k, v)
                          for i in range(0, q.shape[2], q_rows)], dim=2)
    qf = q.float() * scale
    s = torch.einsum("bhnd,bhmd->bhnm", qf, k.float())
    s = s - s.amax(dim=-1, keepdim=True).detach()
    attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float())
    return out.to(q.dtype)
