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

The entry is differentiable everywhere, as the JAX entry is on its CPU
oracle (jax.grad of ``_dense_attention``, pallas_attention.py:70-77; its
Pallas kernel defines no VJP).  On the card K4's forward also writes each
row's log-sum-exp, and its backward is a second hand-written kernel,
``csrc/blockwise_attention_bwd.cu`` (FlashAttention-2's backward, dq, dk
and dv in q's dtype), counted in ``blockwise_attention.backward_launches``:
two deterministic passes (dq over query tiles, then dk/dv over key tiles,
no atomics), in bf16 on Hopper's machinery (128-row CTAs of two consumer
warpgroups and a TMA producer, every product a ``wgmma``; ``hopper.cuh``),
in f32 on the CUDA cores.  The C entry encodes the TMA tensor maps of q,
k, v and dO itself, so this wrapper passes the same pointers in both
dtypes.  On the CPU autograd differentiates the dense formulation;
``attention_backward_reference`` is the backward's plain version.

Bound on the card: at D = 32 one exponential per score against 4 D FLOPs of
the forward's two products, so the special-function units bound the bf16
forward and the CUDA cores' f32 rate the f32 work; the backward's 10 D FLOPs
a score put its bf16 bound on the tensor cores (``chip_smoke.py`` computes
each).
"""

from __future__ import annotations

import ctypes

import torch

from calodiffusion_tpu_torch.ops import cuda_build

HEAD_DIM = 32
SCRATCH_ROWS = 128  # the backward's (2, B*H, N') scratch: N rounded up to this
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
KERNEL = cuda_build.DtypeKernel("blockwise_attention", {
    "calo_blockwise_attention_forward": [_PTR] * 5 + [_INT] * 4 + [ctypes.c_float, _PTR]})
BACKWARD_KERNEL = cuda_build.DtypeKernel("blockwise_attention_bwd", {
    "calo_blockwise_attention_backward": [_PTR] * 10 + [_INT] * 5 + [ctypes.c_float, _PTR]})


def _check(q, k, v, **more):
    """Raise unless q, k, v (and ``more``: out, dout) are (B, H, N, 32) bf16
    or f32 contiguous 16-byte-aligned tensors of one shape and dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, N, D), got shape {tuple(q.shape)}")
    B, H, N, D = q.shape
    if D != HEAD_DIM or min(B, H, N) < 1:
        raise ValueError(f"the kernel takes D = {HEAD_DIM} and B, H, N >= 1, "
                         f"got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        cuda_build.check_tensor(name, t, q.shape, q.dtype, q.device)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (vector loads)")


def launch(lib, q, k, v, with_lse: bool = False):
    """Allocate K4's output (and with ``with_lse`` the rows' log-sum-exp,
    f32 (B, H, N)) and call ``lib``'s entry on checked inputs; returns out,
    or (out, lse)."""
    B, H, N, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, H, N, dtype=torch.float32, device=q.device) if with_lse else None
    rc = lib.calo_blockwise_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B * H, N, D,
        int(q.dtype == torch.bfloat16), D ** -0.5, cuda_build.stream_of(q.device),
    )
    cuda_build.raise_on(rc, KERNEL.name, q)
    return (out, lse) if with_lse else out


def launch_backward(lib, q, k, v, out, lse, dout):
    """Allocate dq, dk, dv and the backward's scratch and call ``lib``'s
    entry on checked inputs."""
    B, H, N, D = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    npad = -(-N // SCRATCH_ROWS) * SCRATCH_ROWS
    stats = torch.empty(2, B * H, npad, dtype=torch.float32, device=q.device)
    rc = lib.calo_blockwise_attention_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        B * H, N, npad, D, int(q.dtype == torch.bfloat16), D ** -0.5,
        cuda_build.stream_of(q.device),
    )
    cuda_build.raise_on(rc, BACKWARD_KERNEL.name, q)
    return dq, dk, dv


def blockwise_attention_forward(q, k, v, with_lse: bool = False):
    """K4's wrapper: launches the kernel on CUDA tensors, counted in
    ``blockwise_attention.launches``; the result carries no gradient."""
    _check(q, k, v)
    lib = KERNEL.library(q)
    with cuda_build.on_device(q):
        result = launch(lib, q, k, v, with_lse)
    blockwise_attention.launches += 1
    return result


def blockwise_attention_backward(q, k, v, out, lse, dout):
    """K4's backward's wrapper: dq, dk, dv of ``blockwise_attention`` at
    the output gradient ``dout``, from the forward's ``out`` and ``lse``;
    counted in ``blockwise_attention.backward_launches``."""
    _check(q, k, v, out=out, dout=dout)
    cuda_build.check_tensor("lse", lse, q.shape[:3], torch.float32, q.device)
    lib = BACKWARD_KERNEL.library(q)
    with cuda_build.on_device(q):
        grads = launch_backward(lib, q, k, v, out, lse, dout)
    blockwise_attention.backward_launches += 1
    return grads


class _BlockwiseAttention(torch.autograd.Function):
    """K4 forward, its backward kernel backward.  The forward writes the
    rows' log-sum-exp only when an input needs a gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        if not any(ctx.needs_input_grad):
            return blockwise_attention_forward(q, k, v)
        out, lse = blockwise_attention_forward(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # a view at an odd offset: the kernel reads 16-byte vectors
            dout = dout.clone()
        return blockwise_attention_backward(q, k, v, out, lse, dout)


def blockwise_attention(q, k, v):
    """Softmax attention over (B, H, N, D) tensors, scale D^-1/2: K4 (D =
    32, bf16 or f32) and its backward kernel on the card, the dense
    formulation on the CPU."""
    if q.device.type == "cpu":
        return dense_attention(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"blockwise_attention: unsupported device {q.device}")
    return _BlockwiseAttention.apply(q, k, v)


blockwise_attention.launches = 0  # forward kernel launches since the last reset
blockwise_attention.backward_launches = 0  # backward kernel launches since the last reset


def dense_attention(q, k, v, q_rows: int | None = None):
    """K4's plain version, the JAX package's ``_dense_attention``
    (pallas_attention.py:70-77): f32 scores of the scaled q against k, max
    subtracted, softmax, times v, cast to q's dtype.  ``q_rows`` computes it
    over chunks of that many query rows, to bound the score tensor's memory
    at large N; its gradient is then ``attention_backward_reference`` over
    the same chunks."""
    if q_rows is not None and q.shape[2] > q_rows:
        return _ChunkedDenseAttention.apply(q, k, v, q_rows)
    scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    s = torch.einsum("bhnd,bhmd->bhnm", qf, k.float())
    s = s - s.amax(dim=-1, keepdim=True).detach()
    attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bhmd->bhnd", attn, v.float())
    return out.to(q.dtype)


class _ChunkedDenseAttention(torch.autograd.Function):
    """dense_attention over chunks of query rows, whose backward keeps one
    chunk's scores at a time (autograd of the chunks would keep them all)."""

    @staticmethod
    def forward(ctx, q, k, v, q_rows):
        ctx.save_for_backward(q, k, v)
        ctx.q_rows = q_rows
        return torch.cat([dense_attention(q[:, :, i:i + q_rows], k, v)
                          for i in range(0, q.shape[2], q_rows)], dim=2)

    @staticmethod
    def backward(ctx, dout):
        return (*attention_backward_reference(*ctx.saved_tensors, dout, ctx.q_rows), None)


def attention_backward_reference(q, k, v, dout, q_rows: int | None = None):
    """K4's backward's plain version: dq, dk, dv of ``dense_attention`` at
    the output gradient ``dout``, by autograd of the dense formulation in
    f32 (what autograd computes inside it before casting each gradient to
    its input's dtype), over chunks of ``q_rows`` query rows (all at None):
    the chunks' dk and dv are summed in f32 and cast once."""
    N = q.shape[2]
    rows = q_rows or N
    with torch.enable_grad():
        kf, vf = (t.detach().float().requires_grad_(True) for t in (k, v))
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        dq = []
        for i in range(0, N, rows):
            qc = q[:, :, i:i + rows].detach().float().requires_grad_(True)
            gq, gk, gv = torch.autograd.grad(dense_attention(qc, kf, vf), (qc, kf, vf),
                                             dout[:, :, i:i + rows].float())
            dq.append(gq)
            dk += gk
            dv += gv
    return torch.cat(dq, dim=2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_lse_reference(q, k):
    """The rows' log-sum-exp of K4's scaled f32 scores, (B, H, N) f32: what
    its forward writes for the backward."""
    return torch.logsumexp(torch.einsum("bhnd,bhmd->bhnm", q.float() * q.shape[-1] ** -0.5,
                                        k.float()), dim=-1)
