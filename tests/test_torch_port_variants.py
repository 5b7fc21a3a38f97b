"""calodiffusion_tpu_torch's attention variants against the JAX package on
the CPU: LinearAttention alone (K3's plain version), blockwise softmax
attention (K4's), GroupNorm + SiLU (K5's), and the LinearAttention,
Attention and PreNormResidual modules that call them.  Inputs and weights
are made with numpy from a seed and fed to both sides; the JAX kernels run
as the JAX package's own tests run them (interpret mode)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models import nn_modules as jnn
from calodiffusion_tpu.ops import pallas_attention as jatt
from calodiffusion_tpu.ops import pallas_groupnorm as jgn
from calodiffusion_tpu.ops import pallas_linear_attention as jla
from calodiffusion_tpu_torch.models import nn_modules as tnn
from calodiffusion_tpu_torch.ops import attention as tatt
from calodiffusion_tpu_torch.ops import groupnorm as tgn
from calodiffusion_tpu_torch.ops import linear_attention as tla
from calodiffusion_tpu_torch.tools.jax_import import module_params_to_state_dict

# the weight-transfer bound of docs/DESIGN.md:32
MODULE_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads: the Tier-1 run shares the cores
    between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


def _linear_inputs(B, N, C, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, N, C)).astype(f),
            (0.2 * rng.standard_normal((C, 96))).astype(f),
            (0.2 * rng.standard_normal((32, C))).astype(f),
            (0.1 * rng.standard_normal(C)).astype(f))


def _jax_linear(args, dtype):
    x, wqkv, wout, bout = (jnp.asarray(a) for a in args)
    return x.astype(dtype), wqkv.astype(dtype), wout.astype(dtype), bout


def _torch_linear(args, dtype):
    x, wqkv, wout, bout = (torch.from_numpy(a) for a in args)
    return x.to(dtype), wqkv.to(dtype), wout.to(dtype), bout


# ---------------------------------------------------------------------------
# K3: LinearAttention alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [16, 32, 64, 96])
@pytest.mark.parametrize("N", [700, 1024])  # 700 = 512 + 188: masked tail
def test_linear_attention_plain_matches_jax_f32(N, C):
    args = _linear_inputs(2, N, C, seed=N + C)
    ja = _jax_linear(args, jnp.float32)
    kernel = np.asarray(jla.fused_linear_attention(*ja, interpret=True))
    ref = np.asarray(jla.linear_attention_reference(*ja))
    got = tla.linear_attention_reference(*_torch_linear(args, torch.float32)).numpy()
    # tests/test_pallas_linear_attention.py:36-38
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_linear_attention_plain_matches_jax_bf16():
    args = _linear_inputs(2, 2048, 32, seed=1)
    ja = _jax_linear(args, jnp.bfloat16)
    kernel = np.asarray(jla.fused_linear_attention(*ja, interpret=True), np.float32)
    ref = np.asarray(jla.linear_attention_reference(*ja), np.float32)
    got = tla.linear_attention_reference(*_torch_linear(args, torch.bfloat16)).float().numpy()
    # tests/test_pallas_linear_attention.py:41-48
    np.testing.assert_allclose(got, kernel, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=3e-2)


def test_linear_attention_gradients_match_jax():
    """All four input gradients of sum(y^2): autograd of the port's entry on
    the CPU against jax.grad through the JAX entry's custom VJP with the
    Pallas forward in interpret mode (tests/test_pallas_linear_attention.py:63-81)."""
    args = _linear_inputs(2, 700, 32, seed=3)
    want = jax.grad(lambda *a: jnp.sum(jla.fused_linear_attention(*a, interpret=True) ** 2),
                    argnums=(0, 1, 2, 3))(*_jax_linear(args, jnp.float32))
    ta = [t.requires_grad_(True) for t in _torch_linear(args, torch.float32)]
    (tla.fused_linear_attention(*ta) ** 2).sum().backward()
    for t, w in zip(ta, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5)


def test_linear_attention_entry_on_cpu_runs_the_plain_version():
    args = _torch_linear(_linear_inputs(2, 96, 32, seed=4), torch.float32)
    before = tla.fused_linear_attention.launches
    got = tla.fused_linear_attention(*args)
    assert tla.fused_linear_attention.launches == before
    torch.testing.assert_close(got, tla.linear_attention_reference(*args), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tla.fused_linear_attention(*(a.to("meta") for a in args))


def _swap_in_plain(monkeypatch, module, launch_name, plain):
    """Run a kernel wrapper on CPU tensors with its launch replaced by the
    plain version (no card): the wrapper's checks and counter run as on the
    card."""
    if module is tla:
        monkeypatch.setattr(tla, "_kernel_library", lambda *a: None)
    else:  # K4, K5: one library a dtype
        monkeypatch.setattr(module.KERNEL, "library", lambda *a: None)
    monkeypatch.setattr(module, launch_name, lambda lib, *a: plain(*a))


def test_k3_autograd_function_launches_the_kernel_and_returns_every_gradient(monkeypatch):
    """The autograd.Function that carries K3 on the card: its forward goes
    through K3's wrapper (one launch counted), its backward is autograd of the
    plain version recomputed from the saved inputs, and each gradient
    reaches its input."""
    _swap_in_plain(monkeypatch, tla, "launch_linear", tla.linear_attention_reference)
    args = [a.requires_grad_(True)
            for a in _torch_linear(_linear_inputs(2, 300, 64, seed=5), torch.float32)]
    before = tla.fused_linear_attention.launches
    out = tla._FusedLinearAttention.apply(*args, 32)
    assert tla.fused_linear_attention.launches == before + 1
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, args, g)
    assert tla.fused_linear_attention.launches == before + 1
    plain = [a.detach().requires_grad_(True) for a in args]
    want = torch.autograd.grad(tla.linear_attention_reference(*plain), plain, g)
    for a, w in zip(got, want):
        assert a is not None
        torch.testing.assert_close(a, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K4: blockwise softmax attention
# ---------------------------------------------------------------------------

def _qkv(B, H, N, seed, D=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, H, N, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n,block,force", [
    (256, 64, False),   # N <= 2048: the JAX entry's dense dispatch
    (640, 128, True),   # N % block != 0: the kernel's padded rows and masked keys
    (2500, 512, True),  # past the JAX entry's dense limit
])
def test_blockwise_attention_matches_jax(n, block, force):
    """The port's entry on the CPU (the dense formulation) against the JAX
    entry at the given block sizes and dispatch, and against its dense
    formulation."""
    q, k, v = _qkv(1, 2, n, seed=n)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kernel = np.asarray(jatt.blockwise_attention(jq, jk, jv, block_q=block, block_k=block,
                                                 force=force))
    dense = np.asarray(jatt._dense_attention(jq, jk, jv, 32 ** -0.5))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tatt.blockwise_attention(tq, tk, tv)
    # tests/test_pallas_attention.py:32-33
    np.testing.assert_allclose(got.numpy(), kernel, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), dense, atol=2e-5, rtol=1e-4)
    chunked = tatt.dense_attention(tq, tk, tv, q_rows=96)
    torch.testing.assert_close(chunked, got, atol=1e-6, rtol=0)


@pytest.mark.parametrize("device,n,kernel", [
    ("cuda", 1, True), ("cuda", 736, True), ("cuda", 2048, True), ("cuda", 40500, True),
    ("cpu", 736, False),
])
def test_blockwise_attention_dispatch(monkeypatch, device, n, kernel):
    """A CUDA tensor takes K4 at every N: the JAX entry's dense branch at
    N <= 2048 is not carried over.  A CPU tensor takes the plain version."""
    monkeypatch.setattr(tatt, "_BlockwiseAttention", SimpleNamespace(apply=lambda *a: "K4"))
    monkeypatch.setattr(tatt, "dense_attention", lambda *a: "plain")
    q = SimpleNamespace(device=torch.device(device), shape=(1, 4, n, 32))
    assert tatt.blockwise_attention(q, q, q) == ("K4" if kernel else "plain")


@pytest.mark.parametrize("module,launch_name,plain,call", [
    (tgn, "launch", tgn.gn_silu_reference,
     lambda x: tgn._GroupNormSiLU.apply(x, torch.ones(32), torch.zeros(32), 8, 1e-5, True)),
], ids=["K5"])
def test_k4_k5_refuse_a_backward(monkeypatch, module, launch_name, plain, call):
    """K5 is forward only, as in the JAX package: the forward launches the
    kernel (swapped for the plain version here), and a backward through it
    raises and says so, rather than differentiating the plain version
    quietly.  (K4 has a backward kernel: the test below.)"""
    _swap_in_plain(monkeypatch, module, launch_name, plain)
    counter = module.groupnorm_silu
    x = torch.randn(1, 2, 40, 32, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    before = counter.launches
    out = call(x)
    assert counter.launches == before + 1 and out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="forward only"):
        out.sum().backward()


def test_k4_autograd_function_launches_both_kernels_and_returns_every_gradient(monkeypatch):
    """The autograd.Function that carries K4 on the card, its kernels'
    launches swapped for their plain versions: the forward goes through K4's
    wrapper asking for the rows' log-sum-exp (one forward launch counted),
    the backward through its backward kernel's wrapper (one backward launch
    counted), and dq, dk and dv reach q, k and v as autograd of the plain
    version gives them.  When no input needs a gradient the forward asks no
    lse."""
    asked = []

    def forward(lib, q, k, v, with_lse=False):
        asked.append(with_lse)
        out = tatt.dense_attention(q, k, v)
        return (out, tatt.attention_lse_reference(q, k)) if with_lse else out

    monkeypatch.setattr(tatt.KERNEL, "library", lambda *a: None)
    monkeypatch.setattr(tatt.BACKWARD_KERNEL, "library", lambda *a: None)
    monkeypatch.setattr(tatt, "launch", forward)
    monkeypatch.setattr(tatt, "launch_backward", lambda lib, q, k, v, out, lse, dout:
                        tatt.attention_backward_reference(q, k, v, dout))
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(1, 2, 40, seed=7))
    f0, b0 = tatt.blockwise_attention.launches, tatt.blockwise_attention.backward_launches
    out = tatt._BlockwiseAttention.apply(q, k, v)
    assert (tatt.blockwise_attention.launches, tatt.blockwise_attention.backward_launches,
            asked) == (f0 + 1, b0, [True])
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape).astype(np.float32))
    got = torch.autograd.grad(out, (q, k, v), g)
    assert (tatt.blockwise_attention.launches,
            tatt.blockwise_attention.backward_launches) == (f0 + 1, b0 + 1)
    plain = [t.detach().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(tatt.dense_attention(*plain), plain, g)
    for a, w in zip(got, want):
        assert a is not None and a.shape == w.shape
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    with torch.no_grad():  # q, k, v from a module's projection need no gradient here
        tatt._BlockwiseAttention.apply(q.detach(), k.detach(), v.detach())
    assert asked == [True, False]


# ---------------------------------------------------------------------------
# K5: GroupNorm + SiLU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,groups,silu", [
    ((2, 5, 4, 3, 16), 8, True),     # tests/test_pallas_groupnorm.py:17-21
    ((3, 45, 16, 9, 32), 8, True),
    ((2, 7, 7, 32), 4, True),
    ((2, 5, 4, 3, 96), 8, True),     # C = 96
    ((2, 9, 4, 3, 64), 8, False),    # no SiLU
])
def test_groupnorm_silu_matches_jax(shape, groups, silu):
    rng = np.random.default_rng(shape[-1] + groups)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    kernel = np.asarray(jgn.groupnorm_silu(jx, js, jb, groups=groups, apply_silu=silu,
                                           force=True))
    ref = np.asarray(jgn._gn_silu_reference(jx, js, jb, groups, 1e-5, silu))
    before = tgn.groupnorm_silu.launches
    got = tgn.groupnorm_silu(*(torch.from_numpy(a) for a in (x, scale, bias)), groups=groups,
                             apply_silu=silu).numpy()
    assert tgn.groupnorm_silu.launches == before
    # atol of tests/test_pallas_groupnorm.py:31; plus 1e-5 relative: torch
    # and XLA take the f32 group sums (up to 25,920 terms) in other orders,
    # which moves an output near |y| = 4.5 by about 20 f32 ulps
    np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The modules, with their parameters carried across from JAX
# ---------------------------------------------------------------------------

def _random_params(module, x, seed):
    """numpy params for a flax module: kernels at torch's default bound,
    GroupNorm scales near 1, biases small."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(jmodule, tmodule, name, shape, seed):
    """(JAX output, port module loaded with the same params, x) at a
    channels-last x of ``shape``."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    params = _random_params(jmodule, jnp.asarray(x), seed)
    tmodule.load_state_dict(module_params_to_state_dict(params, name))
    want = np.asarray(jmodule.apply(params, jnp.asarray(x)))
    return want, params, x


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


SHAPE = (2, 5, 6, 7, 32)  # (B, Z, A, R, C)


@pytest.mark.parametrize("heads", [1, 4])
def test_linear_attention_module_matches_jax(heads):
    jm = jnn.LinearAttention(heads=heads)
    tm = tnn.LinearAttention(32, heads=heads)
    want, _, x = _pair(jm, tm, "LinearAttention", SHAPE, seed=heads)
    with torch.no_grad():
        got = tm(_ncdhw(x))
    np.testing.assert_allclose(_ndhwc(got), want, rtol=0, atol=MODULE_ATOL)


@pytest.mark.parametrize("fn", ["LinearAttention", "Attention"])
@pytest.mark.parametrize("heads", [1, 4])
def test_prenorm_residual_matches_jax(fn, heads):
    jfn = getattr(jnn, fn)(heads=heads)
    tfn = getattr(tnn, fn)(32, heads=heads)
    jm, tm = jnn.PreNormResidual(jfn), tnn.PreNormResidual(32, tfn)
    want, _, x = _pair(jm, tm, f"PreNormResidual({fn})", SHAPE, seed=10 + heads)
    fused = tla.fused_attention_block
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnn, "fused_attention_block",
                   lambda *a, **k: calls.append(1) or fused(*a, **k))
        with torch.no_grad():
            got = tm(_ncdhw(x))
    # the heads-1 LinearAttention block is one fused block, as in CondUnet
    assert len(calls) == (fn == "LinearAttention" and heads == 1)
    np.testing.assert_allclose(_ndhwc(got), want, rtol=0, atol=MODULE_ATOL)


def test_linear_attention_prenorm_without_residual_matches_jax_cpu_branch():
    """prenorm without residual: GroupNorm, attention, post-GroupNorm and no
    residual, the JAX CPU branch (nn_modules.py:529-532, :599-603)."""
    jm, tm = jnn.LinearAttention(), tnn.LinearAttention(32)
    x = np.random.default_rng(20).standard_normal(SHAPE).astype(np.float32)
    params = _random_params(jm, jnp.asarray(x), 20)
    tm.load_state_dict(module_params_to_state_dict(params, "LinearAttention"))
    rng = np.random.default_rng(21)
    sc, bi = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32), \
        (0.1 * rng.standard_normal(32)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x), prenorm=(jnp.asarray(sc), jnp.asarray(bi))))
    with torch.no_grad():
        got = tm(_ncdhw(x), prenorm=(torch.from_numpy(sc), torch.from_numpy(bi)))
    np.testing.assert_allclose(_ndhwc(got), want, rtol=0, atol=MODULE_ATOL)


@pytest.mark.parametrize("cylindrical", [False, True])
def test_attention_module_matches_jax(cylindrical):
    """Attention on a (B, C, Z, A, R) grid; N = 45 * 4 * 3 = 540 (the dense
    formulation on both sides: the JAX entry's dispatch below N = 2048, the
    port's CPU version; K4's arithmetic is held to the dense one above)."""
    jm = jnn.Attention(heads=4, cylindrical=cylindrical)
    tm = tnn.Attention(32, heads=4, cylindrical=cylindrical)
    want, _, x = _pair(jm, tm, "Attention", (2, 45, 4, 3, 32), seed=30 + cylindrical)
    with torch.no_grad():
        got = tm(_ncdhw(x))
    assert got.shape == (2, 32, 45, 4, 3)
    np.testing.assert_allclose(_ndhwc(got), want, rtol=0, atol=MODULE_ATOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_linear_attention_module_gradients_match_jax(heads):
    """Loss and every parameter gradient of mean(out^2) against
    jax.value_and_grad of the JAX module in a training trace (its
    heads-first conv formulation, nn_modules.py:538-565)."""
    jm = jnn.LinearAttention(heads=heads)
    tm = tnn.LinearAttention(32, heads=heads)
    x = np.random.default_rng(40 + heads).standard_normal(SHAPE).astype(np.float32)
    params = _random_params(jm, jnp.asarray(x), 40 + heads)
    tm.load_state_dict(module_params_to_state_dict(params, "LinearAttention"))
    with jla.training_trace():
        loss_j, grads_j = jax.jit(jax.value_and_grad(
            lambda p: jnp.mean(jm.apply(p, jnp.asarray(x)) ** 2)))(params)
    loss_t = (tm(_ncdhw(x)) ** 2).mean()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = module_params_to_state_dict(jax.tree_util.tree_map(np.array, grads_j),
                                       "LinearAttention")
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        scale = float(w.abs().max()) + 1e-12
        err = float((got[k] - w).abs().max()) / scale
        assert err < 2e-4, f"{k}: max-norm relative error {err:.2e}"


@pytest.mark.parametrize("cylindrical", [False, True])
def test_attention_module_gradients_match_jax(cylindrical):
    """Attention(32, heads=4) on the CPU (autograd of the dense formulation):
    the loss mean(out^2), the input's and every parameter's gradient against
    jax.value_and_grad of the JAX module (its dense branch, which the JAX
    entry takes on the CPU at every N).  f32 on both sides, sums in other
    orders: loss 1e-5 relative, gradients 2e-4 max-norm relative, as the
    LinearAttention gradients above."""
    jm = jnn.Attention(heads=4, cylindrical=cylindrical)
    tm = tnn.Attention(32, heads=4, cylindrical=cylindrical)
    x = np.random.default_rng(50 + cylindrical).standard_normal((2, 45, 4, 3, 32))
    x = x.astype(np.float32)
    params = _random_params(jm, jnp.asarray(x), 50 + cylindrical)
    tm.load_state_dict(module_params_to_state_dict(params, "Attention"))
    loss_j, (grads_j, gx_j) = jax.jit(jax.value_and_grad(
        lambda p, xx: jnp.mean(jm.apply(p, xx) ** 2), argnums=(0, 1)))(params, jnp.asarray(x))
    xt = _ncdhw(x).requires_grad_(True)
    loss_t = (tm(xt) ** 2).mean()
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    want = module_params_to_state_dict(jax.tree_util.tree_map(np.array, grads_j), "Attention")
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    got["x"], want["x"] = torch.from_numpy(_ndhwc(xt.grad).copy()), torch.from_numpy(
        np.asarray(gx_j))
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / (float(w.abs().max()) + 1e-12)
        assert err < 2e-4, f"{k}: max-norm relative error {err:.2e}"
