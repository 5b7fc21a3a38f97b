"""calodiffusion_tpu_torch's CUDA kernels against their plain versions on
the card.  A CUDA kernel has no CPU mode, so every test here needs a card
and skips without one.  The file imports no JAX, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so run it
there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch.models import nn_modules
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.ops import attention as tatt
from calodiffusion_tpu_torch.ops import groupnorm as tgn
from calodiffusion_tpu_torch.ops import linear_attention as tattn
from calodiffusion_tpu_torch.ops.tolerances import (K1_TOL, K2_TOL, K3_TOL, K4_TOL, K4B_TOL,
                                                    K5_TOL)
from calodiffusion_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config_dataset2.json"

pytestmark = pytest.mark.gpu

# the shapes of the main path (B = 4 here), and ragged N: one position, a
# partial tile, one past a whole tile of 256
SHAPES = [(4, 6480, 32), (4, 736, 64), (4, 736, 32), (4, 96, 32), (4, 96, 64), (3, 1, 32),
          (1, 257, 64), (2, 300, 32)]


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _block_args(B, N, C, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt).contiguous()

    return (t(rng.standard_normal((B, N, C)), dtype),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(0.2 * rng.standard_normal((C, 96)), dtype),
            t(0.2 * rng.standard_normal((32, C)), dtype),
            t(0.1 * rng.standard_normal(C)),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES)
def test_attention_block_kernel_matches_plain(B, N, C, dtype):
    args = _block_args(B, N, C, dtype, seed=B + N + C)
    before = tattn.fused_attention_block.launches
    got = tattn.fused_attention_block(*args)
    torch.cuda.synchronize()
    assert tattn.fused_attention_block.launches == before + 1
    assert got.shape == (B, N, C) and got.dtype == dtype
    want = tattn.attention_block_reference(*args).float()
    atol, rtol = K1_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("C,N", [(32, 6480), (64, 736), (32, 736), (32, 96), (64, 96)])
@pytest.mark.parametrize("cluster", [1, 8])
def test_attention_block_kernel_at_forced_cluster_sizes(C, N, cluster, dtype):
    """K1 with its cluster size forced to 1 (one CTA a sample, x and y off
    chip where they do not fit) and to the largest, 8 (the merge over
    distributed shared memory, empty CTAs at N = 96), at every ds2 (C, N)."""
    args = _block_args(4, N, C, dtype, seed=N + C + cluster)
    plan = tattn.cluster_plan(args[0], cluster)
    assert plan["G"] == cluster
    lib = tattn._kernel_library(tattn.FORWARD_KERNEL, args[0])
    got = tattn.launch_forward(lib, *args, 1e-5, cluster=cluster)
    torch.cuda.synchronize()
    want = tattn.attention_block_reference(*args).float()
    atol, rtol = K1_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_attention_block_keeps_ds2_samples_on_chip():
    """At ds2's shapes the bf16 kernel holds each sample's x and y in its
    cluster's shared memory: no device scratch."""
    for C, N, G in ((32, 6480, 8), (64, 736, 2), (32, 736, 1), (32, 96, 1), (64, 96, 1)):
        plan = tattn.cluster_plan(torch.empty(1, N, C, device="cuda", dtype=torch.bfloat16))
        assert (plan["G"], plan["x_resident"], plan["y_resident"]) == (G, 1, 1), (C, N, plan)


def test_attention_block_kernel_rejects_what_it_does_not_take():
    x, *rest = _block_args(2, 64, 32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention_block(x.transpose(0, 1).contiguous().transpose(0, 1), *rest)
    with pytest.raises(TypeError, match="dtype"):
        tattn.fused_attention_block(x.bfloat16(), *rest)
    x48, *rest48 = _block_args(2, 64, 48, torch.float32, seed=0)
    with pytest.raises(ValueError, match="C in"):
        tattn.fused_attention_block(x48, *rest48)


def test_denoise_on_card_matches_cpu():
    """The same weights in f32: the card (kernels, cuDNN) against the CPU
    (plain versions), within the weight-transfer bound of docs/DESIGN.md:32.
    The ds2 config at its widths (the kernel takes C in {32, 64})."""
    cfg = dict(load_config(str(CONFIG)), PRECISION="f32")
    cpu = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = CaloDiffusion(cfg)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    x, E, layers = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((2, 1, 45, 16, 9)), rng.uniform(0.1, 1.0, (2, 1)),
        rng.standard_normal((2, 46))))
    sigma = torch.full((2, 1, 1, 1, 1), 0.7)
    before = tattn.fused_attention_block.launches
    with torch.no_grad():
        want = cpu.denoise(x, E=E, sigma=sigma, layers=layers)
        got = card.denoise(x.cuda(), E=E.cuda(), sigma=sigma.cuda(), layers=layers.cuda())
    assert tattn.fused_attention_block.launches == before + 7
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES)
def test_attention_block_backward_kernel_matches_plain(B, N, C, dtype):
    args = _block_args(B, N, C, dtype, seed=B + N + C + 1)
    g = torch.from_numpy(np.random.default_rng(N).standard_normal((B, N, C)).astype(np.float32))
    g = g.to("cuda", dtype)
    before = tattn.attention_block_backward.launches
    got = tattn.attention_block_backward(*args, g)
    torch.cuda.synchronize()
    assert tattn.attention_block_backward.launches == before + 1
    want = tattn.attention_block_backward_reference(*args, g)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        a, w = a.double(), w.double()
        err = ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= K2_TOL[dtype], f"gradient {i}: max-norm relative error {err:.3g}"


def _check_backward(got, want, dtype):
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.shape == w.shape and a.dtype == w.dtype, i
        a, w = a.double(), w.double()
        err = ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
        assert err <= K2_TOL[dtype], f"gradient {i}: max-norm relative error {err:.3g}"


@pytest.mark.parametrize("C,N", [(32, 6480), (64, 736), (32, 736), (32, 96), (64, 96)])
@pytest.mark.parametrize("cluster,dtype", [(1, torch.bfloat16), (8, torch.bfloat16),
                                           (16, torch.bfloat16), (1, torch.float32),
                                           (8, torch.float32)])
def test_attention_block_backward_kernel_at_forced_cluster_sizes(C, N, cluster, dtype):
    """K2 with its cluster size forced to 1 (one CTA a sample, part of it in
    device memory where it does not fit), 8 and, in bf16, 16 (the
    non-portable cluster; empty CTAs at N = 96), at every ds2 (C, N)."""
    args = _block_args(2, N, C, dtype, seed=N + C + cluster + 1)
    g = torch.from_numpy(np.random.default_rng(N + 1).standard_normal((2, N, C)).astype(np.float32))
    g = g.to("cuda", dtype)
    plan = tattn.cluster_plan(args[0], cluster, name=tattn.BACKWARD_KERNEL)
    assert plan["G"] == cluster
    lib = tattn._kernel_library(tattn.BACKWARD_KERNEL, args[0])
    got = tattn.launch_backward(lib, *args[:7], g, 1e-5, cluster=cluster)
    torch.cuda.synchronize()
    _check_backward(got, tattn.attention_block_backward_reference(*args, g), dtype)


def test_attention_block_backward_keeps_ds2_samples_on_chip():
    """At ds2's shapes the bf16 backward holds each sample's x, g, y and dxn
    in its cluster's shared memory: no device scratch."""
    for C, N, G in ((32, 6480, 16), (64, 736, 4), (32, 736, 2), (32, 96, 1), (64, 96, 1)):
        plan = tattn.cluster_plan(torch.empty(1, N, C, device="cuda", dtype=torch.bfloat16),
                                  name=tattn.BACKWARD_KERNEL)
        assert plan["G"] == G, (C, N, plan)
        assert all(plan[f"{k}_resident"] for k in ("x", "g", "y", "dxn")), (C, N, plan)


def test_fused_attention_block_differentiates_through_the_kernels():
    """With grad on and inputs that require it, the output carries a
    grad_fn whose backward is K2; under no_grad it carries none."""
    args = [a.requires_grad_(True) for a in _block_args(2, 300, 32, torch.float32, seed=1)]
    k1, k2 = tattn.fused_attention_block.launches, tattn.attention_block_backward.launches
    out = tattn.fused_attention_block(*args)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, args, g)
    assert tattn.fused_attention_block.launches == k1 + 1
    assert tattn.attention_block_backward.launches == k2 + 1
    want = tattn.attention_block_backward_reference(*[a.detach() for a in args], g)
    for a, w in zip(got, want):
        assert ((a - w).abs().max() / w.abs().max()).item() <= K2_TOL[torch.float32]
    with torch.no_grad():
        assert tattn.fused_attention_block(*args).grad_fn is None


def test_train_step_gradients_on_card_match_cpu():
    """One f32 train step from the same weights, batch, noise and sigma draws:
    the loss and every parameter gradient, card (K1, K2, cuDNN) against CPU
    (plain versions); bounds and their reasons in chip_smoke.py."""
    cfg = dict(load_config(str(CONFIG)), PRECISION="f32")
    rng = np.random.default_rng(2)
    data, noise = (rng.standard_normal((2, 1, 45, 16, 9)).astype(np.float32) for _ in range(2))
    E, layers = rng.uniform(0.1, 1.0, (2, 1)).astype(np.float32), rng.standard_normal(
        (2, 46)).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)
    state = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    out = []
    for dev in ("cuda", "cpu"):
        m = CaloDiffusion(cfg, device=dev)
        m.load_state_dict(state)
        t = [torch.from_numpy(a).to(dev) for a in (data, E, noise, layers, rnd)]
        loss = m.compute_loss(t[0], t[1], noise=t[2], layers=t[3], rnd_normal=t[4])
        loss.backward()
        out.append((loss.item(), {k: p.grad.cpu().double() for k, p in m.named_parameters()}))
    (l_card, g_card), (l_cpu, g_cpu) = out
    assert abs(l_card - l_cpu) <= 1e-3 * abs(l_cpu)
    G = max(g.abs().max().item() for g in g_cpu.values())
    for k, g in g_cpu.items():
        err = ((g_card[k] - g).abs().max() / (g.abs().max() + 1e-3 * G)).item()
        assert err <= 5e-3, f"{k}: {err:.3g}"


# ---------------------------------------------------------------------------
# K3, K4, K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", SHAPES + [(2, 40500, 32)])
def test_linear_attention_kernel_matches_plain(B, N, C, dtype):
    x, _, _, w_qkv, w_out, b_out, _, _ = _block_args(B, N, C, dtype, seed=B + N + C + 2)
    before = tattn.fused_linear_attention.launches
    got = tattn.fused_linear_attention(x, w_qkv, w_out, b_out)
    torch.cuda.synchronize()
    assert tattn.fused_linear_attention.launches == before + 1
    assert got.shape == (B, N, C) and got.dtype == dtype
    want = tattn.linear_attention_reference(x, w_qkv, w_out, b_out).float()
    atol, rtol = K3_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("C,N", [(32, 40500), (32, 6480), (64, 736)])
@pytest.mark.parametrize("cluster", [1, 8])
def test_linear_attention_kernel_at_forced_cluster_sizes(C, N, cluster, dtype):
    """K3 with its cluster size forced to 1 and 8, on dataset 3's grid
    (x re-read from device memory) and at ds2's largest shapes."""
    x, _, _, w_qkv, w_out, b_out, _, _ = _block_args(2, N, C, dtype, seed=N + C + cluster + 2)
    plan = tattn.cluster_plan(x, cluster, name=tattn.LINEAR_KERNEL)
    assert plan["G"] == cluster and not plan["y_resident"]
    lib = tattn._kernel_library(tattn.LINEAR_KERNEL, x)
    got = tattn.launch_linear(lib, x, w_qkv, w_out, b_out, cluster=cluster)
    torch.cuda.synchronize()
    want = tattn.linear_attention_reference(x, w_qkv, w_out, b_out).float()
    atol, rtol = K3_TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_linear_attention_module_backward_through_k3():
    """LinearAttention(32) on the card: the forward launches K3 once, and the
    loss and every gradient match the same module with K3's entry replaced by
    the plain version (f32, 1e-4: N = 540 sums ctx over far fewer positions
    than chip_smoke.py's ds3 check, whose K3_GRAD_TOL_F32 states its reasons)."""
    m = nn_modules.LinearAttention(32, generator=torch.Generator().manual_seed(0)).cuda()
    x = torch.randn(2, 32, 9, 10, 6, generator=torch.Generator().manual_seed(1))
    x = x.cuda().requires_grad_(True)
    grads = []
    for entry in (tattn.fused_linear_attention, tattn.linear_attention_reference):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(nn_modules, "fused_linear_attention", entry)
            m.zero_grad(set_to_none=True)
            x.grad = None
            before = tattn.fused_linear_attention.launches
            (m(x) ** 2).mean().backward()
            launched = tattn.fused_linear_attention.launches - before
        assert launched == (entry is tattn.fused_linear_attention)
        grads.append([x.grad] + [p.grad for p in m.parameters()])
    for a, w in zip(*grads):
        assert ((a - w).abs().max() / w.abs().max()).item() <= 1e-4


def _qkv(B, H, N, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(B, H, N, 32, generator=g).to("cuda", dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", [(1, 2, 1), (2, 1, 100), (1, 2, 736), (1, 8, 4096),
                                   (2, 1, 2500)])
def test_blockwise_attention_kernel_matches_plain(B, H, N, dtype):
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N)
    before = tatt.blockwise_attention.launches
    got = tatt.blockwise_attention(q, k, v)
    torch.cuda.synchronize()
    assert tatt.blockwise_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    atol, rtol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), tatt.dense_attention(q, k, v).float(),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", [(1, 1, 13), (1, 2, 4097), (1, 8, 4096)])
@pytest.mark.parametrize("q_gain", [1, 8])
def test_blockwise_attention_kernel_ragged_and_peaked(B, H, N, q_gain, dtype):
    """N under one 16-key step and one past a 64-key tile; q scaled by 8, a
    peaked softmax where a few keys carry the weight."""
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N + q_gain)
    q = (q.float() * q_gain).to(dtype)
    got = tatt.blockwise_attention(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = K4_TOL[dtype]
    torch.testing.assert_close(got.float(), tatt.dense_attention(q, k, v).float(),
                               atol=atol, rtol=rtol)


def _max_norm_rel(got, want):
    """max |got - want| / max |want| of each pair, in float64."""
    return [((a.double() - w.double()).abs().max() / w.double().abs().max()).item()
            for a, w in zip(got, want)]


def _plain_rows(B, H, N):
    """Query rows a chunk of the plain gradient takes: ~0.5 GB of f32 scores."""
    return max(1, (1 << 27) // (B * H * N))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,H,N", [(1, 2, 1), (1, 2, 64), (2, 1, 100), (1, 2, 128), (2, 1, 129),
                                   (1, 2, 736), (1, 8, 4096), (1, 2, 4097), (1, 2, 8192),
                                   (4, 4, 8190)])
@pytest.mark.parametrize("q_gain", [1, 8])
def test_blockwise_attention_backward_kernel_matches_plain(B, H, N, q_gain, dtype):
    """K4's backward (from its forward's out and lse) against
    attention_backward_reference, max-norm relative within K4B_TOL; where the
    plain gradient is zero (N = 1), relative to dv's largest entry.  N = 64
    and 128: one streamed tile, one 128-row CTA; 129: a ragged CTA and a
    ring stage partly past N; 8192: many trips round the ring; (4, 4, 8190):
    a grid of 192-row CTAs that fills a 132-SM card four times over, so the
    bf16 kernel takes its large-grid plan, ragged in its last CTA."""
    q, k, v = _qkv(B, H, N, dtype, seed=B + H + N + q_gain)
    q = (q.float() * q_gain).to(dtype)
    dout = _qkv(B, H, N, dtype, seed=N + 7)[0]
    before = tatt.blockwise_attention.backward_launches
    out, lse = tatt.blockwise_attention_forward(q, k, v, with_lse=True)
    got = tatt.blockwise_attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert tatt.blockwise_attention.backward_launches == before + 1
    want = tatt.attention_backward_reference(q, k, v, dout, _plain_rows(B, H, N))
    floor = want[2].double().abs().max()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype == dtype, name
        scale = w.double().abs().max()
        err = ((a.double() - w.double()).abs().max() / (scale if scale > 0 else floor)).item()
        assert err <= K4B_TOL[dtype], f"{name}: max-norm relative error {err:.3g}"
    again = tatt.blockwise_attention_backward(q, k, v, out, lse, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_blockwise_attention_dispatch_and_backward():
    """On the card K4 runs at every N, below the JAX entry's dense limit of
    2048 too, and a backward through the entry launches K4's backward kernel
    once, its gradients within K4B_TOL of the plain ones."""
    for n, seed in ((736, 0), (2049, 1)):
        q, k, v = (t.requires_grad_(True) for t in _qkv(1, 2, n, torch.float32, seed=seed))
        f0, b0 = tatt.blockwise_attention.launches, tatt.blockwise_attention.backward_launches
        out = tatt.blockwise_attention(q, k, v)
        assert tatt.blockwise_attention.launches == f0 + 1
        g = torch.randn_like(out)
        got = torch.autograd.grad(out, (q, k, v), g)
        assert tatt.blockwise_attention.backward_launches == b0 + 1
        want = tatt.attention_backward_reference(q, k, v, g)
        assert max(_max_norm_rel(got, want)) <= K4B_TOL[torch.float32]


def test_attention_module_on_card_matches_cpu():
    """Attention(32, heads=4) in f32 on a 45 x 50 x 2 grid (N = 4500: K4 on
    the card, the dense formulation on the CPU)."""
    cpu = nn_modules.Attention(32, heads=4, cylindrical=True,
                               generator=torch.Generator().manual_seed(0))
    card = nn_modules.Attention(32, heads=4, cylindrical=True).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 32, 45, 50, 2, generator=torch.Generator().manual_seed(1))
    before = tatt.blockwise_attention.launches
    with torch.no_grad():
        got, want = card(x.cuda()), cpu(x)
    assert tatt.blockwise_attention.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=2e-4, rtol=0)


def test_attention_module_backward_on_card_matches_cpu():
    """Attention(32, heads=4) in f32 on a 45 x 50 x 2 grid: the input's and
    every parameter's gradient of mean(out^2), card (K4 and its backward
    kernel, cuDNN with TF32 off) against CPU (autograd of the dense
    formulation), max-norm relative: K4B_TOL[f32] through two 1x1 convs."""
    cpu = nn_modules.Attention(32, heads=4, cylindrical=True,
                               generator=torch.Generator().manual_seed(0))
    card = nn_modules.Attention(32, heads=4, cylindrical=True).cuda()
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 32, 45, 50, 2, generator=torch.Generator().manual_seed(2))
    grads = []
    for m, xx in ((card, x.cuda()), (cpu, x.clone())):
        xx.requires_grad_(True)
        b0 = tatt.blockwise_attention.backward_launches
        (m(xx) ** 2).mean().backward()
        assert tatt.blockwise_attention.backward_launches == b0 + (m is card)
        grads.append([xx.grad.cpu()] + [p.grad.cpu() for p in m.parameters()])
    errs = _max_norm_rel(*grads)
    assert max(errs) <= K4B_TOL[torch.float32], errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape,groups", [((4, 45, 16, 9, 32), 8), ((4, 23, 8, 4, 64), 8),
                                          ((2, 5, 4, 3, 96), 8), ((3, 7, 7, 32), 4),
                                          ((2, 1, 16), 8)])
def test_groupnorm_silu_kernel_matches_plain(shape, groups, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    C = shape[-1]
    x = (torch.randn(*shape, generator=g) + 0.5).to("cuda", dtype)
    scale = (1.0 + 0.1 * torch.randn(C, generator=g)).cuda()
    bias = (0.1 * torch.randn(C, generator=g)).cuda()
    before = tgn.groupnorm_silu.launches
    got = tgn.groupnorm_silu(x, scale, bias, groups=groups)
    torch.cuda.synchronize()
    assert tgn.groupnorm_silu.launches == before + 1 and got.dtype == dtype
    atol, rtol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), tgn.gn_silu_reference(x, scale, bias, groups).float(),
                               atol=atol, rtol=rtol)


def test_groupnorm_silu_refuses_a_backward():
    x = torch.randn(2, 40, 32, device="cuda", requires_grad=True)
    out = tgn.groupnorm_silu(x, torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))
    with pytest.raises(NotImplementedError, match="forward only"):
        out.sum().backward()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("steps", [1, 2, 4, 8])
def test_groupnorm_silu_kernel_chunk_sizes(steps, dtype):
    """K5 with 1-8 rows a thread in a chunk at ds3 level 0's N (B = 2): up
    to 844 chunks of a sample merged; the same output bit for bit twice."""
    x, scale, bias = _gn_inputs((2, 45, 50, 18, 32), dtype, seed=steps)
    lib = tgn.KERNEL.library(x)
    got = tgn.launch(lib, x, scale, bias, 8, 1e-5, True, steps)
    again = tgn.launch(lib, x, scale, bias, 8, 1e-5, True, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    atol, rtol = K5_TOL[dtype]
    torch.testing.assert_close(got.float(), tgn.gn_silu_reference(x, scale, bias, 8).float(),
                               atol=atol, rtol=rtol)


def _gn_inputs(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    C = shape[-1]
    return ((torch.randn(*shape, generator=g) + 0.5).to("cuda", dtype),
            (1.0 + 0.1 * torch.randn(C, generator=g)).cuda(),
            (0.1 * torch.randn(C, generator=g)).cuda())
