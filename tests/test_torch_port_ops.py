"""calodiffusion_tpu_torch ops against the JAX package on the CPU: the
cylindrical convolutions, and the fused attention block's plain version
against the JAX Pallas kernel (interpret mode) and its XLA reference.
Inputs are made with numpy from a seed and fed to both sides."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.ops import conv as jconv
from calodiffusion_tpu.ops import pallas_linear_attention as jattn
from calodiffusion_tpu_torch.ops import conv as tconv
from calodiffusion_tpu_torch.ops import linear_attention as tattn


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _to_ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _from_ncdhw(t):
    return np.moveaxis(t.numpy(), 1, -1)


# every (kernel, stride, padding, output_padding) that the U-Net's block
# convs, res convs, downsample_module and upsample_module produce
_FWD = [((3, 3, 3), (1, 1, 1), 1), ((1, 1, 1), (1, 1, 1), 0)] + [
    ((3, 4, 4), (zs, 2, 2), 1) for zs in (1, 2)
]
_TRANSPOSE = [
    ((4 if ez else 3, 4, 4), (zs, 2, 2), 1, (0, ea, er))
    for zs, ez, ea, er in itertools.product((1, 2), (0, 1), (0, 1), (0, 1))
]


@pytest.mark.parametrize("cylindrical", [False, True])
@pytest.mark.parametrize("kernel,stride,padding", _FWD)
def test_conv3d_matches_jax(kernel, stride, padding, cylindrical):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 8, 5, 3)).astype(np.float32)
    w = rng.standard_normal((*kernel, 3, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal((4,)).astype(np.float32)
    jop = jconv.cylindrical_conv3d if cylindrical else jconv.conv3d
    top = tconv.cylindrical_conv3d if cylindrical else tconv.conv3d
    want = np.asarray(jop(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          stride=stride, padding=padding))
    got = top(_to_ncdhw(x), torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2)).copy()),
              torch.from_numpy(b), stride=stride, padding=padding)
    np.testing.assert_allclose(_from_ncdhw(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cylindrical", [False, True])
@pytest.mark.parametrize("kernel,stride,padding,output_padding", _TRANSPOSE)
def test_conv3d_transpose_matches_jax(kernel, stride, padding, output_padding,
                                      cylindrical):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 4, 3, 3)).astype(np.float32)
    w = rng.standard_normal((*kernel, 3, 4)).astype(np.float32) * 0.2
    b = rng.standard_normal((4,)).astype(np.float32)
    jop = jconv.cylindrical_conv3d_transpose if cylindrical else jconv.conv3d_transpose
    top = tconv.cylindrical_conv3d_transpose if cylindrical else tconv.conv3d_transpose
    want = np.asarray(jop(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                          padding=padding, output_padding=output_padding))
    # flax (kz, ka, kr, Cin, Cout) -> torch ConvTranspose (Cin, Cout, kz, ka, kr), no flip
    got = top(_to_ncdhw(x), torch.from_numpy(np.transpose(w, (3, 4, 0, 1, 2)).copy()),
              torch.from_numpy(b), stride=stride, padding=padding,
              output_padding=output_padding)
    assert _from_ncdhw(got).shape == want.shape
    np.testing.assert_allclose(_from_ncdhw(got), want, rtol=0, atol=1e-5)


def _block_inputs(B, N, C, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        rng.standard_normal((B, N, C)).astype(f),
        (1.0 + 0.1 * rng.standard_normal(C)).astype(f),
        (0.1 * rng.standard_normal(C)).astype(f),
        (0.2 * rng.standard_normal((C, 96))).astype(f),
        (0.2 * rng.standard_normal((32, C))).astype(f),
        (0.1 * rng.standard_normal(C)).astype(f),
        (1.0 + 0.1 * rng.standard_normal(C)).astype(f),
        (0.1 * rng.standard_normal(C)).astype(f),
    )


def _jax_args(args, dtype):
    x, gps, gpb, wqkv, wout, bout, gos, gob = (jnp.asarray(a) for a in args)
    return (x.astype(dtype), gps, gpb, wqkv.astype(dtype), wout.astype(dtype),
            bout, gos, gob)


def _torch_args(args, dtype):
    x, gps, gpb, wqkv, wout, bout, gos, gob = (torch.from_numpy(a) for a in args)
    return (x.to(dtype), gps, gpb, wqkv.to(dtype), wout.to(dtype), bout, gos, gob)


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("N", [96, 1024, 6480])  # 6480 = 12*512 + 336: masked tail
def test_attention_block_plain_matches_jax_f32(N, C):
    args = _block_inputs(2, N, C)
    ja = _jax_args(args, jnp.float32)
    kernel = np.asarray(jattn.fused_attention_block(*ja, interpret=True))
    ref = np.asarray(jattn.attention_block_reference(*ja))
    got = tattn.attention_block_reference(*_torch_args(args, torch.float32)).numpy()
    # f32 throughout: only the order of the f32 sums differs
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("C", [32, 64])
def test_attention_block_plain_matches_jax_bf16(C):
    args = _block_inputs(2, 6480, C, seed=1)
    ja = _jax_args(args, jnp.bfloat16)
    kernel = np.asarray(jattn.fused_attention_block(*ja, interpret=True), np.float32)
    ref = np.asarray(jattn.attention_block_reference(*ja), np.float32)
    got = tattn.attention_block_reference(*_torch_args(args, torch.bfloat16)).float().numpy()
    # Same casts as the JAX reference, so against it only the rounding of
    # bf16 products and sums differs: within 2 bf16 ulps of |out| < 8.
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.0625)
    # The Pallas kernel (like the CUDA one) keeps q/k projections and the
    # softmax numerators in f32 where the plain version rounds them to bf16
    # first; the post-GN term then differs by a few bf16 ulps of itself.
    np.testing.assert_allclose(got, kernel, rtol=0, atol=0.125)


def test_wrapper_on_cpu_runs_the_plain_version():
    args = _torch_args(_block_inputs(2, 96, 32, seed=2), torch.float32)
    before = tattn.fused_attention_block.launches
    got = tattn.fused_attention_block(*args)
    assert tattn.fused_attention_block.launches == before
    torch.testing.assert_close(got, tattn.attention_block_reference(*args), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    args = [a.to("meta") for a in _torch_args(_block_inputs(1, 8, 32), torch.float32)]
    with pytest.raises(ValueError, match="unsupported device"):
        tattn.fused_attention_block(*args)


# ---------------------------------------------------------------------------
# The backward: autograd of the plain version against the Pallas backward
# kernel (interpret mode), and the autograd wiring of the kernel wrappers
# ---------------------------------------------------------------------------

def _cotangent(B, N, C, seed):
    return np.random.default_rng(seed).standard_normal((B, N, C)).astype(np.float32)


@pytest.mark.parametrize("B,N,C", [(2, 700, 32), (1, 300, 64), (3, 1, 32)])
def test_attention_block_backward_plain_matches_jax_pallas(B, N, C):
    """All eight input gradients of the plain backward against jax.vjp of the
    JAX fused_attention_block with its Pallas backward kernel (K2) in
    interpret mode, f32, at the JAX package's own bound: 3e-3 in max-norm
    relative error (tests/test_pallas_linear_attention.py:115-137), set by
    the f32 roundoff both carry through the GroupNorm-backward cancellations."""
    args = _block_inputs(B, N, C, seed=N + C)
    g = _cotangent(B, N, C, seed=N)
    _, vjp = jax.vjp(lambda *a: jattn.fused_attention_block(*a, interpret=True),
                     *_jax_args(args, jnp.float32))
    want = vjp(jnp.asarray(g))
    got = tattn.attention_block_backward_reference(*_torch_args(args, torch.float32),
                                                   torch.from_numpy(g))
    assert len(got) == len(want) == 8
    for i, (a, w) in enumerate(zip(got, want)):
        a, w = a.numpy(), np.asarray(w)
        assert a.shape == w.shape
        err = np.abs(a - w).max() / (np.abs(w).max() + 1e-30)
        assert err < 3e-3, f"gradient {i}: max-norm relative error {err:.2e}"


def test_wrapper_on_cpu_is_differentiable():
    """On CPU tensors the block is the plain version, which autograd
    differentiates; the backward wrapper runs the plain backward."""
    args = [a.requires_grad_(True) for a in _torch_args(_block_inputs(2, 96, 32, seed=3),
                                                        torch.float32)]
    out = tattn.fused_attention_block(*args)
    assert out.grad_fn is not None
    g = torch.from_numpy(_cotangent(2, 96, 32, seed=4))
    before = tattn.attention_block_backward.launches
    want = tattn.attention_block_backward(*[a.detach() for a in args], g)
    assert tattn.attention_block_backward.launches == before
    got = torch.autograd.grad(out, args, g)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_autograd_function_runs_the_kernels_and_returns_every_gradient(monkeypatch):
    """The autograd.Function that carries the block on the card: its forward
    calls K1's wrapper, its backward K2's, with g made contiguous, and it
    hands each gradient to its input.  The wrappers are replaced by the plain
    versions here, which have the kernels' signatures (no card)."""
    calls = []

    def forward(*a):
        calls.append("K1")
        return tattn.attention_block_reference(*a)

    def backward(*a):
        calls.append("K2")
        assert a[8].is_contiguous()
        return tattn.attention_block_backward_reference(*a)

    monkeypatch.setattr(tattn, "attention_block_forward", forward)
    monkeypatch.setattr(tattn, "attention_block_backward", backward)
    args = [a.requires_grad_(True) for a in _torch_args(_block_inputs(2, 64, 32, seed=5),
                                                        torch.float32)]
    out = tattn._FusedAttentionBlock.apply(*args, 32, 1e-5)
    assert out.grad_fn is not None and calls == ["K1"]
    g = torch.from_numpy(_cotangent(2, 32, 64, seed=6)).transpose(1, 2)  # not contiguous
    got = torch.autograd.grad(out, args, g)
    assert calls == ["K1", "K2"]
    want = tattn.attention_block_backward_reference(*[a.detach() for a in args],
                                                    g.contiguous())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
