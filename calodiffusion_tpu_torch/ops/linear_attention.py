"""Linear attention on the card: the fused attention block
``x + GN1(LinearAttention(GN1(x)))``, forward and backward, and
LinearAttention alone.

Three hand-written CUDA kernels replace the Pallas kernels of
``calodiffusion_tpu/ops/pallas_linear_attention.py`` (same entries,
signatures and ``(B, N, C)`` layout):

- K1, the block's forward (``_block_kernel``): ``csrc/linear_attention_block.cu``,
  through ``fused_attention_block``;
- K2, the block's backward (``_block_bwd_kernel``):
  ``csrc/linear_attention_block_bwd.cu``, through ``attention_block_backward``;
- K3, LinearAttention alone (``_kernel``): ``csrc/linear_attention.cu``, which
  is K1's source built without its GroupNorms and residual, through
  ``fused_linear_attention``.

All three spread a sample over a thread-block cluster of G CTAs (up to 8
for K1 and K3, 16 for K2), keep its share on chip, run their products on
the tensor cores in bf16 and merge every sum over the cluster in rank
order.  Each library's plan entry picks G and what stays in shared memory
from the sizes alone (``kernel_plan``); where no G holds a sample, part of
it lives in a device scratch from the wrapper or is re-read from device
memory.  ``cluster`` and ``smem_limit`` force a G or a smaller shared
memory (the tests reach the merges and the off-chip plans that way).

On a CUDA tensor each entry is a ``torch.autograd.Function``: the block's
forward launches K1 and its backward K2; LinearAttention's forward launches
K3 and its backward is autograd of ``linear_attention_reference``
recomputed from the saved inputs, as the JAX custom VJP is
(``_fused_bwd``).  A kernel that cannot launch raises.  On a CPU tensor an
entry runs its plain PyTorch version, and autograd differentiates that.
The tests and ``chip_smoke.py`` hold K1 against ``attention_block_reference``,
K2 against ``attention_block_backward_reference`` (autograd of the plain
version) and K3 against ``linear_attention_reference``.

Bound on the card: device-memory bytes.  The block's forward and K3 read x
once and write their output once (2 * B * N * C elements), the backward
reads x and g once and writes dx once (3 * B * N * C); their matrix
products are a few thousand FLOPs per position, far below the tensor
cores' rate per byte.  See the sources for the kernels' designs and their
times on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from calodiffusion_tpu_torch.ops import cuda_build

DIM_HEAD = 32
FORWARD_KERNEL = "linear_attention_block"
BACKWARD_KERNEL = "linear_attention_block_bwd"
LINEAR_KERNEL = "linear_attention"
_SUPPORTED_C = (32, 64)
_PTR = ctypes.c_void_p
_PTRS = ctypes.POINTER(ctypes.c_void_p)
_INT = ctypes.c_int
# C entries and argument types of each kernel's library
_ENTRIES = {
    FORWARD_KERNEL: [("calo_attention_block_forward",
                      [_PTR] * 10 + [_INT] * 4 + [ctypes.c_float, _INT, _INT, _PTR]),
                     ("calo_attention_block_plan", [_INT] * 5 + [ctypes.POINTER(_INT)])],
    BACKWARD_KERNEL: [("calo_attention_block_backward",
                       [_PTR] * 8 + [_PTRS, _PTR, _PTRS] + [_INT] * 4
                       + [ctypes.c_float, _INT, _INT, _PTR]),
                      ("calo_attention_block_backward_plan",
                       [_INT] * 5 + [ctypes.POINTER(_INT)])],
    LINEAR_KERNEL: [("calo_linear_attention_forward", [_PTR] * 5 + [_INT] * 6 + [_PTR]),
                    ("calo_linear_attention_plan", [_INT] * 5 + [ctypes.POINTER(_INT)])],
}
# each kernel's plan entry and the names of what it returns
_PLANS = {
    FORWARD_KERNEL: ("calo_attention_block_plan",
                     ("G", "P", "x_resident", "y_resident", "smem_bytes")),
    BACKWARD_KERNEL: ("calo_attention_block_backward_plan",
                      ("G", "P", "x_resident", "g_resident", "y_resident", "dxn_resident",
                       "smem_bytes")),
    LINEAR_KERNEL: ("calo_linear_attention_plan",
                    ("G", "P", "x_resident", "y_resident", "smem_bytes")),
}


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Declare the argument and result types of ``lib``'s entries for kernel ``name``."""
    for entry, argtypes in _ENTRIES[name]:
        cuda_build.bind(lib, entry, argtypes)
    return lib


def variant(dtype, C: int) -> tuple[str, str]:
    """The macros of the kernels' build for compute dtype ``dtype`` and C
    channels: each library holds one (dtype, C) instantiation."""
    return (*cuda_build.dtype_variant(dtype), f"CALO_C={C}")


# every (kernel, variant) a caller may launch
BUILDS = tuple((name, variant(dtype, C))
               for name in (FORWARD_KERNEL, BACKWARD_KERNEL, LINEAR_KERNEL)
               for dtype in (torch.bfloat16, torch.float32) for C in _SUPPORTED_C)


@functools.cache
def _library(name: str, dtype, C: int) -> ctypes.CDLL:
    return bind(cuda_build.load(name, variant(dtype, C)), name)


def _kernel_library(name: str, x) -> ctypes.CDLL:
    """The library of kernel ``name`` for x's (dtype, C); x must be on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got {x.device}")
    return _library(name, x.dtype, x.shape[-1])


def build_all() -> None:
    """Build every variant of the three kernels at once (one nvcc each)."""
    cuda_build.build_all(BUILDS)


def _check_x(x, w_qkv, w_out, b_out, dim_head):
    """x, the projections and b_out as the kernels take them; returns (B, N, C)."""
    if dim_head != DIM_HEAD:
        raise ValueError(f"the kernels take dim_head {DIM_HEAD}, got {dim_head}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got shape {tuple(x.shape)}")
    B, N, C = x.shape
    if C not in _SUPPORTED_C or N < 1 or B < 1:
        raise ValueError(f"the kernels take C in {_SUPPORTED_C} and B, N >= 1, "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernels take bf16 or f32, got {x.dtype}")
    dev = x.device
    cuda_build.check_tensor("x", x, (B, N, C), x.dtype, dev)
    cuda_build.check_tensor("w_qkv", w_qkv, (C, 3 * DIM_HEAD), x.dtype, dev)
    cuda_build.check_tensor("w_out", w_out, (DIM_HEAD, C), x.dtype, dev)
    cuda_build.check_tensor("b_out", b_out, (C,), torch.float32, dev)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (vector loads)")
    return B, N, C


def _check_block(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale,
                 gn_post_bias, dim_head):
    """Shapes, dtypes and layout the block kernels take; returns (B, N, C)."""
    B, N, C = _check_x(x, w_qkv, w_out, b_out, dim_head)
    for name, t in (("gn_pre_scale", gn_pre_scale), ("gn_pre_bias", gn_pre_bias),
                    ("gn_post_scale", gn_post_scale), ("gn_post_bias", gn_post_bias)):
        cuda_build.check_tensor(name, t, (C,), torch.float32, x.device)
    return B, N, C


def kernel_plan(lib, name: str, N: int, C: int, dtype, cluster: int = 0,
                smem_limit: int = 0) -> dict:
    """Where kernel ``name`` (K1, K2 or K3; ``lib``'s plan entry) keeps a
    sample of N positions: the cluster size ``G`` (CTAs a sample), the
    positions ``P`` a CTA holds, which of its tensors stay in shared memory
    (``*_resident``; otherwise device memory) and the ``smem_bytes`` a CTA
    takes.  ``cluster`` 0 lets the kernel choose G (the smallest that holds
    the sample on chip: of 1, 2, 4, 8 for K1 and K3, up to 16 for K2);
    ``smem_limit`` 0 is the card's limit a block."""
    entry, keys = _PLANS[name]
    return dict(zip(keys, _plan(lib, entry, len(keys), N, C, dtype == torch.bfloat16, cluster,
                                smem_limit)))


@functools.lru_cache(maxsize=256)
def _plan(lib, entry, n, N, C, is_bf16, cluster, smem_limit) -> tuple:
    plan = (ctypes.c_int * n)()
    rc = getattr(lib, entry)(N, C, int(is_bf16), cluster, smem_limit, plan)
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: {entry} has no launch plan for N={N}, C={C}, "
                           f"{'bf16' if is_bf16 else 'f32'}, cluster {cluster} "
                           f"(CUDA error {rc})")
    return tuple(plan)


def launch_forward(lib, x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                   gn_post_scale, gn_post_bias, eps: float, cluster: int = 0,
                   smem_limit: int = 0):
    """Allocate K1's output (and, where the plan keeps y in device memory,
    its scratch) and call ``lib``'s forward entry on checked inputs; returns
    the block's output.  ``cluster`` and ``smem_limit`` as in ``kernel_plan``."""
    B, N, C = x.shape
    plan = kernel_plan(lib, FORWARD_KERNEL, N, C, x.dtype, cluster, smem_limit)
    y_scr = None
    if not plan["y_resident"]:
        y_scr = torch.empty((B, plan["G"] * plan["P"] * C), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    rc = lib.calo_attention_block_forward(
        x.data_ptr(), gn_pre_scale.data_ptr(), gn_pre_bias.data_ptr(),
        w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
        gn_post_scale.data_ptr(), gn_post_bias.data_ptr(),
        None if y_scr is None else y_scr.data_ptr(), out.data_ptr(), B, N, C,
        int(x.dtype == torch.bfloat16), float(eps), cluster, smem_limit,
        cuda_build.stream_of(x.device),
    )
    cuda_build.raise_on(rc, FORWARD_KERNEL, x)
    return out


def cluster_plan(x, cluster: int = 0, name: str = FORWARD_KERNEL) -> dict:
    """The ``kernel_plan`` of kernel ``name`` (K1 by default) for a
    (B, N, C) tensor ``x`` on the card."""
    lib = _kernel_library(name, x)
    with cuda_build.on_device(x):
        return kernel_plan(lib, name, x.shape[1], x.shape[2], x.dtype, cluster)


def launch_backward(lib, x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                    gn_post_scale, g, eps: float, cluster: int = 0, smem_limit: int = 0):
    """Allocate K2's outputs (and, where the plan keeps y or dxn in device
    memory, their scratch) and call ``lib``'s backward entry on checked
    inputs; sums the per-sample weight gradients over the batch, as the
    Pallas wrapper does (pallas_linear_attention.py:741-752), and returns
    (dx, d gn_pre_scale, d gn_pre_bias, d w_qkv, d w_out, d b_out,
    d gn_post_scale, d gn_post_bias) in their inputs' dtypes.  ``cluster``
    and ``smem_limit`` as in ``kernel_plan``."""
    B, N, C = x.shape
    D = DIM_HEAD
    dev, f32 = x.device, torch.float32
    plan = kernel_plan(lib, BACKWARD_KERNEL, N, C, x.dtype, cluster, smem_limit)
    scratch = [None if plan[f"{name}_resident"] else
               torch.empty((B, plan["G"] * plan["P"] * C), dtype=f32, device=dev)
               for name in ("y", "dxn")]
    dx = torch.empty_like(x)
    dg1, db1, dbo, dg2, db2 = (torch.empty((B, C), dtype=f32, device=dev) for _ in range(5))
    dwq, dwk, dwv = (torch.empty((B, C, D), dtype=f32, device=dev) for _ in range(3))
    dwo = torch.empty((B, D, C), dtype=f32, device=dev)
    grads = (dg1, db1, dwq, dwk, dwv, dwo, dbo, dg2, db2)
    scratch_ptrs = (ctypes.c_void_p * 2)(*(None if t is None else t.data_ptr() for t in scratch))
    grad_ptrs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in grads))
    rc = lib.calo_attention_block_backward(
        x.data_ptr(), g.data_ptr(), gn_pre_scale.data_ptr(), gn_pre_bias.data_ptr(),
        w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), gn_post_scale.data_ptr(),
        scratch_ptrs, dx.data_ptr(), grad_ptrs, B, N, C,
        int(x.dtype == torch.bfloat16), float(eps), cluster, smem_limit,
        cuda_build.stream_of(dev),
    )
    cuda_build.raise_on(rc, BACKWARD_KERNEL, x)
    d_w_qkv = torch.cat([dwq.sum(0), dwk.sum(0), dwv.sum(0)], dim=1).to(w_qkv.dtype)
    return (dx, dg1.sum(0), db1.sum(0), d_w_qkv, dwo.sum(0).to(w_out.dtype),
            dbo.sum(0), dg2.sum(0), db2.sum(0))


def attention_block_forward(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                            gn_post_scale, gn_post_bias, dim_head: int = DIM_HEAD,
                            eps: float = 1e-5):
    """K1's wrapper: launches the forward kernel on CUDA tensors, counted
    in ``fused_attention_block.launches``; the result carries no gradient."""
    _check_block(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale,
                 gn_post_bias, dim_head)
    lib = _kernel_library(FORWARD_KERNEL, x)
    with cuda_build.on_device(x):
        out = launch_forward(lib, x, gn_pre_scale, gn_pre_bias,
                             w_qkv, w_out, b_out, gn_post_scale, gn_post_bias, eps)
    fused_attention_block.launches += 1
    return out


def attention_block_backward(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                             gn_post_scale, gn_post_bias, g, dim_head: int = DIM_HEAD,
                             eps: float = 1e-5):
    """K2's wrapper: the gradients of ``x + GN1(LinAttn(GN1(x)))`` with
    respect to its eight inputs, given ``g`` = dL/d out in x's dtype and
    layout.  On CUDA tensors it launches the backward kernel or raises
    (launches counted in ``attention_block_backward.launches``); on CPU
    tensors it runs ``attention_block_backward_reference``."""
    if x.device.type == "cpu":
        return attention_block_backward_reference(
            x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale,
            gn_post_bias, g, dim_head, eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"attention_block_backward: unsupported device {x.device}")
    _check_block(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale,
                 gn_post_bias, dim_head)
    cuda_build.check_tensor("g", g, x.shape, x.dtype, x.device)
    if g.data_ptr() % 16:
        raise ValueError("g must be 16-byte aligned (vector loads)")
    lib = _kernel_library(BACKWARD_KERNEL, x)
    with cuda_build.on_device(x):
        grads = launch_backward(lib, x, gn_pre_scale, gn_pre_bias,
                                w_qkv, w_out, b_out, gn_post_scale, g, eps)
    attention_block_backward.launches += 1
    return grads


attention_block_backward.launches = 0  # kernel launches since the last reset


class _FusedAttentionBlock(torch.autograd.Function):
    """K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                gn_post_scale, gn_post_bias, dim_head, eps):
        ctx.dim_head, ctx.eps = dim_head, eps
        ctx.save_for_backward(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                              gn_post_scale, gn_post_bias)
        return attention_block_forward(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out,
                                       b_out, gn_post_scale, gn_post_bias, dim_head, eps)

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        g = g.to(x.dtype).contiguous()
        if g.data_ptr() % 16:  # a view into a larger buffer: realign
            g = g.clone()
        grads = attention_block_backward(*ctx.saved_tensors, g, ctx.dim_head, ctx.eps)
        return (*grads, None, None)


def fused_attention_block(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out,
                          gn_post_scale, gn_post_bias, dim_head: int = DIM_HEAD,
                          eps: float = 1e-5):
    """x + GN1(LinearAttention(GN1(x))).  x: (B, N, C) bf16 or f32;
    w_qkv: (C, 3*32) and w_out: (32, C) in x's dtype; GroupNorm affines and
    b_out: (C,) f32.  heads = 1, dim_head = 32.  Differentiable: on the card
    the forward is K1 and the backward K2."""
    args = (x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale, gn_post_bias)
    if x.device.type == "cpu":
        return attention_block_reference(*args, dim_head, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attention_block: unsupported device {x.device}")
    return _FusedAttentionBlock.apply(*args, dim_head, eps)


fused_attention_block.launches = 0  # forward kernel launches since the last reset


def launch_linear(lib, x, w_qkv, w_out, b_out, cluster: int = 0, smem_limit: int = 0):
    """Allocate K3's output and call ``lib``'s entry on checked inputs;
    ``cluster`` and ``smem_limit`` as in ``kernel_plan``."""
    B, N, C = x.shape
    out = torch.empty_like(x)
    rc = lib.calo_linear_attention_forward(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), b_out.data_ptr(), out.data_ptr(),
        B, N, C, int(x.dtype == torch.bfloat16), cluster, smem_limit,
        cuda_build.stream_of(x.device),
    )
    cuda_build.raise_on(rc, LINEAR_KERNEL, x)
    return out


def linear_attention_forward(x, w_qkv, w_out, b_out, dim_head: int = DIM_HEAD):
    """K3's wrapper: launches the kernel on CUDA tensors, counted in
    ``fused_linear_attention.launches``; the result carries no gradient."""
    _check_x(x, w_qkv, w_out, b_out, dim_head)
    lib = _kernel_library(LINEAR_KERNEL, x)
    with cuda_build.on_device(x):
        out = launch_linear(lib, x, w_qkv, w_out, b_out)
    fused_linear_attention.launches += 1
    return out


class _FusedLinearAttention(torch.autograd.Function):
    """K3 forward; backward = autograd of the plain version, recomputed from
    the saved inputs (the JAX custom VJP, pallas_linear_attention.py:186-196)."""

    @staticmethod
    def forward(ctx, x, w_qkv, w_out, b_out, dim_head):
        ctx.dim_head = dim_head
        ctx.save_for_backward(x, w_qkv, w_out, b_out)
        return linear_attention_forward(x, w_qkv, w_out, b_out, dim_head)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = linear_attention_reference(*inputs, ctx.dim_head)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def fused_linear_attention(x, w_qkv, w_out, b_out, dim_head: int = DIM_HEAD):
    """LinearAttention (heads = 1) with its 1x1 convs as matrices.  x:
    (B, N, C) bf16 or f32; w_qkv: (C, 3*32) and w_out: (32, C) in x's dtype;
    b_out: (C,) f32.  Returns (B, N, C) in x's dtype.  Differentiable: on the
    card the forward is K3, the backward autograd of the plain version."""
    if x.device.type == "cpu":
        return linear_attention_reference(x, w_qkv, w_out, b_out, dim_head)
    if x.device.type != "cuda":
        raise ValueError(f"fused_linear_attention: unsupported device {x.device}")
    return _FusedLinearAttention.apply(x, w_qkv, w_out, b_out, dim_head)


fused_linear_attention.launches = 0  # kernel launches since the last reset


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
    matrices: w_qkv (C, 3*D), w_out (D, C), b_out (C,); K3's plain version
    (pallas_linear_attention.py:211-223)."""
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


def attention_block_backward_reference(x, gn_pre_scale, gn_pre_bias, w_qkv, w_out,
                                       b_out, gn_post_scale, gn_post_bias, g,
                                       dim_head: int = DIM_HEAD, eps: float = 1e-5):
    """Plain backward: autograd of ``attention_block_reference`` at the
    given inputs with output gradient ``g``; the eight input gradients."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(True) for t in (
            x, gn_pre_scale, gn_pre_bias, w_qkv, w_out, b_out, gn_post_scale, gn_post_bias)]
        out = attention_block_reference(*inputs, dim_head, eps)
        return torch.autograd.grad(out, inputs, g)
