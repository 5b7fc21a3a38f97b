"""The sampler zoo through the network: the port's samplers on its
CaloDiffusion against the JAX package's on its own, at the tiny dataset-2
configuration of tests/test_torch_port_model.py (block and mid attention,
f32), weights made with numpy from a seed and carried across by
tools/jax_import.params_to_state_dict; the Bespoke theta trainer against
the JAX trainer; the --debug trajectory plots."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.ops import linear_attention as tla
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.samplers import misc as tmisc
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from tests.test_torch_port_model import DENOISE_ATOL, _cfg, random_params
from tests.utils_test import fake_batch

# DPMAdaptive with its PID gains at zero (fixed steps of H_INIT, each
# accepted): with the controller on, its step sizes follow the last bits of
# each package's arithmetic (tests/test_torch_port_samplers.py)
FIXED_STEP = {"P_COEFF": 0.0, "I_COEFF": 0.0, "D_COEFF": 0.0, "H_INIT": 2.0}

# (sampler, steps, SAMPLER_OPTIONS, network evaluations)
CASES = [
    ("Euler", 4, {}, 4),
    ("Heun", 3, {}, 5),
    ("Restart", 4, {"RESTART_LIST": {"0": [3, 1, 1.0, 2.0]}}, 4 + 4),
    ("DPM", 4, {}, 4),
    ("DPMAdaptive", 4, FIXED_STEP, 12),
    ("DPMPP2MSDE", 4, {"ETA": 1.0}, 3),
    ("Consistency", 3, {}, 3),
]


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


class JaxNet:
    """The JAX model for the JAX samplers, its denoise compiled once: called
    from each sampler's program through a host callback, so that no
    sampler compiles the U-Net into its own program, or (``callback=False``,
    for the theta trainer, which differentiates through it) called directly.
    Everything else is the JAX model's own (nsteps, the loss tables the
    samplers rebuild)."""

    def __init__(self, jm, params, callback=True):
        self.jm, self.callback = jm, callback
        self._denoise = jax.jit(
            lambda x, E, s, lay: jm.denoise(params, x, E=E, sigma=s, layers=lay))

    def __getattr__(self, name):
        return getattr(self.jm, name)

    def denoise(self, params, x, E=None, sigma=None, layers=None):
        if not self.callback:
            return self._denoise(x, E, sigma, layers)
        return jax.pure_callback(lambda *a: np.asarray(self._denoise(*a)),
                                 jax.ShapeDtypeStruct(x.shape, jnp.float32), x, E, sigma, layers)


@pytest.fixture(scope="module")
def pair():
    cfg = _cfg()
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return cfg, jm, params, tm, JaxNet(jm, params)


class Counted:
    """Wraps the port's model, counting its network evaluations."""

    def __init__(self, model):
        self.model, self.evals = model, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def denoise(self, *a, **kw):
        self.evals += 1
        return self.model.denoise(*a, **kw)


def _tables(loss):
    return [np.asarray(getattr(loss, k)) for k in
            ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "posterior_variance")]


@pytest.mark.parametrize("name,steps,options,evals", CASES, ids=[c[0] for c in CASES])
def test_sampler_through_the_network_matches_jax(pair, name, steps, options, evals):
    """The same start, energies, layers and noise table; the JAX sampler
    compiled once (its network evaluations through JaxNet).  Each
    evaluation differs by up to DENOISE_ATOL, so the state may by
    evaluations x DENOISE_ATOL.  DPM and Consistency rebuild
    the model's loss tables as the JAX package's do."""
    cfg, jm, params, tm, net = pair
    cfg = dict(cfg, SAMPLER_OPTIONS=options)
    start, E, layers = fake_batch(cfg, batch=2, seed=2)
    table = np.random.default_rng(3).standard_normal((64, *start.shape)).astype(np.float32)
    js, ts = jax_get_sampler(name)(cfg), get_sampler(name)(cfg)
    js.set_noise_table(table)
    ts.set_noise_table(table)
    tm.loss_function.update_step(tm.nsteps)
    jm.loss_function.update_step(jm.nsteps)
    want = np.asarray(js(net, params, jnp.asarray(start), jnp.asarray(E),
                         jnp.asarray(layers), steps, 0, jax.random.PRNGKey(0), False))
    counted = Counted(tm)
    with torch.inference_mode():
        got = ts(counted, torch.from_numpy(start), torch.from_numpy(E),
                 torch.from_numpy(layers), steps, 0, None, False)
    assert counted.evals == evals
    assert ts.noise_draws == js.noise_draws
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=evals * DENOISE_ATOL)
    for a, b in zip(_tables(tm.loss_function), _tables(jm.loss_function)):
        np.testing.assert_array_equal(a, b)
    if name == "DPM":
        assert tm.loss_function.n_steps == jm.loss_function.n_steps == steps


def _patched_normals(monkeypatch, sigmas):
    """Both packages' per-step sigma draws in the theta trainer replaced by
    the rows of ``sigmas``, in order (positive: the "log" time embed of
    this config is NaN at a negative sigma in both packages)."""
    jax_rows, torch_rows = iter(sigmas), iter(sigmas)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(next(jax_rows)).reshape(shape))
    monkeypatch.setattr(tmisc, "randn",
                        lambda shape, gen, dev: torch.from_numpy(next(torch_rows)).reshape(shape))


def test_bespoke_trainer_and_theta_file_match_jax(pair, tmp_path, monkeypatch):
    """Two Adam iterations of the theta trainer on one batch, with the same
    sigmas, give the JAX trainer's theta within 1e-5; the network's weights
    get no .grad.  Then the theta file the JAX trainer wrote samples the
    same in the port."""
    cfg, jm, params, tm, net = pair
    steps, iters = 3, 2
    data, E, layers = fake_batch(cfg, batch=2, seed=4)
    rng = np.random.default_rng(5)
    sigmas = np.abs(rng.standard_normal((iters * steps, 2))).astype(np.float32) + 0.1
    opts = {"MAX_ITER": iters, "LR": 1e-2}
    loader = [(E, layers, data)]

    _patched_normals(monkeypatch, sigmas)
    jpath = tmp_path / "jax" / "bns.npy"
    jtheta = jax_get_sampler("BespokeNonStationary")(
        dict(cfg, SAMPLER_OPTIONS=dict(opts, SAMPLER_PATH=str(jpath)))
    ).train(JaxNet(jm, params, callback=False), params, loader, steps)
    tpath = tmp_path / "torch" / "bns.npy"
    ttheta = get_sampler("BespokeNonStationary")(
        dict(cfg, SAMPLER_OPTIONS=dict(opts, SAMPLER_PATH=str(tpath)))
    ).train(tm, loader, steps)
    monkeypatch.undo()

    assert not np.allclose(jtheta, 1.0)
    np.testing.assert_allclose(ttheta, jtheta, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.load(tpath), ttheta)
    assert all(p.grad is None for p in tm.parameters())

    # sampling from the JAX-written file, the same sigma table on both sides
    scfg = dict(cfg, SAMPLER_OPTIONS={"SAMPLER_PATH": str(jpath)})
    start, E2, lay2 = fake_batch(cfg, batch=2, seed=6)
    table = np.abs(rng.standard_normal((steps, 2))).astype(np.float32) + 0.1
    js, ts = (jax_get_sampler("BespokeNonStationary")(scfg),
              get_sampler("BespokeNonStationary")(scfg))
    js.set_noise_table(table)
    ts.set_noise_table(table)
    want = js(net, params, jnp.asarray(start), jnp.asarray(E2),
              jnp.asarray(lay2), steps, 0, jax.random.PRNGKey(0), False)
    with torch.inference_mode():
        got = ts(tm, torch.from_numpy(start), torch.from_numpy(E2), torch.from_numpy(lay2),
                 steps, 0, None, False)
    np.testing.assert_array_equal(ts.theta, np.load(jpath))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=steps * DENOISE_ATOL)


def test_bespoke_trainer_backpropagates_through_the_block_function(pair, monkeypatch):
    """On the card the attention blocks are _FusedAttentionBlock (K1
    forward, K2 backward).  Routed through it here, with its launches
    swapped for the plain versions: the trainer runs the blocks' forward 7
    times a denoise and their backward 7 times each denoise theta reaches
    (all but the first, which sees only the data)."""
    cfg, _, _, tm, _ = pair
    calls = {"forward": 0, "backward": 0}

    def forward(*a):
        calls["forward"] += 1
        return tla.attention_block_reference(*a)

    def backward(*a):
        calls["backward"] += 1
        return tla.attention_block_backward_reference(*a)

    monkeypatch.setattr(tla, "attention_block_forward", forward)
    monkeypatch.setattr(tla, "attention_block_backward", backward)
    from calodiffusion_tpu_torch.models import nn_modules

    monkeypatch.setattr(nn_modules, "fused_attention_block",
                        lambda *a, **k: tla._FusedAttentionBlock.apply(*a, 32, 1e-5))
    steps, iters = 3, 2
    data, E, layers = fake_batch(cfg, batch=2, seed=7)
    rng = np.random.default_rng(8)
    monkeypatch.setattr(tmisc, "randn", lambda shape, gen, dev: torch.from_numpy(
        np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1))
    sampler = get_sampler("BespokeNonStationary")(dict(cfg, SAMPLER_OPTIONS={"MAX_ITER": iters}))
    theta = sampler.train(tm, [(E, layers, data)], steps)
    assert np.isfinite(theta).all() and not np.allclose(theta, 1.0)
    assert calls == {"forward": 7 * steps * iters, "backward": 7 * (steps - 1) * iters}


def test_adam_matches_optax():
    """torch.optim.Adam(lr, eps=1e-8) takes optax.adam(lr)'s steps."""
    import optax

    rng = np.random.default_rng(9)
    grads = rng.standard_normal((5, 2, 4)).astype(np.float32)
    opt = optax.adam(1e-2)
    p = jnp.ones((2, 4), jnp.float32)
    state = opt.init(p)
    t = torch.ones((2, 4), requires_grad=True)
    topt = torch.optim.Adam([t], lr=1e-2, eps=1e-8)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state)
        p = optax.apply_updates(p, updates)
        t.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,with_x0", [(12, True), (3, False)])
def test_debug_plot_files_match_jax(tmp_path, n, with_x0):
    """_debug_sample_plot writes the JAX package's file names, for samplers
    with and without an x0 trajectory."""
    rng = np.random.default_rng(10)
    xs = rng.standard_normal((n, 2, 1, 4, 2, 3)).astype(np.float32)
    x0s = rng.standard_normal(xs.shape).astype(np.float32) if with_x0 else None
    batch = rng.standard_normal((2, 1, 4, 2, 3)).astype(np.float32)
    stub = SimpleNamespace(config={"CHECKPOINT_NAME": "dbg"})
    JaxModel._debug_sample_plot(stub, xs, x0s, batch, plot_folder=str(tmp_path / "jax"))
    CaloDiffusion._debug_sample_plot(stub, xs, x0s, batch, plot_folder=str(tmp_path / "torch"))
    want = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == want
    assert len(want) == (2 if with_x0 else 1) * len(
        {0, n // 4, n // 2, 3 * n // 4, 9 * n // 10, max(n - 10, 0), max(n - 5, 0), n - 1})


@pytest.mark.parametrize("name", ["Heun", "Restart"])
def test_generate_debug_plots_the_first_batch(pair, tmp_path, monkeypatch, name):
    """generate(debug=True) plots the first batch's trajectory into
    ./plots/ (Heun: x and x0 at each checkpoint step) or, for a sampler
    that returns no trajectory (Restart), plots nothing; showers as
    without debug."""
    cfg, _, _, tm, _ = pair
    monkeypatch.chdir(tmp_path)
    cfg = dict(cfg, SAMPLER_OPTIONS={"RESTART_LIST": {"0": [2, 1, 1.0, 2.0]}})
    loader = [(fake_batch(cfg, 2, s)[1], fake_batch(cfg, 2, s)[2], fake_batch(cfg, 2, s)[0])
              for s in (11, 12)]
    sampler = get_sampler(name)(cfg)
    showers, energies = tm.generate(loader, 3, generator=torch.Generator().manual_seed(0),
                                    sampler=sampler, debug=True)
    assert showers.shape == (4, 6480) and np.isfinite(showers).all()
    files = sorted(os.listdir("plots")) if os.path.isdir("plots") else []
    if name == "Heun":  # 3 steps: frames 0, 1 and 2 of gen and x0
        assert files == sorted(f"tiny_ds2_norm_voxels_{t}_step{j}.png"
                               for t in ("gen", "x0") for j in range(3))
    else:
        assert files == []
