"""The port's sampler zoo against the JAX package's on the CPU, with no
network: both packages sample with the closed-form denoiser of unit-Gaussian
data, D(x, sigma) = x / (1 + sigma^2) (the one tests/test_samplers.py
uses), from the same seeded start and the same injected noise table."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models.losses import hybrid_weight as jax_hybrid_weight
from calodiffusion_tpu.samplers import SAMPLER_REGISTRY as JAX_REGISTRY
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu_torch.models.losses import hybrid_weight
from calodiffusion_tpu_torch.samplers import SAMPLER_REGISTRY, get_sampler


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

CFG = {
    "NOISE_SCHED": "log",
    "NSTEPS": 400,
    "SAMPLER_OPTIONS": {},
    "CONSIS_NSTEPS": 100,
}
BATCH, DIM = 4, 32
# tied entries: 0.59 and 0.6 cast to the same step index at 10 steps
TIED_RESTART = {"0": [3, 2, 1.09, 1.92], "1": [3, 1, 0.59, 1.09],
                "2": [2, 1, 0.6, 1.09]}


class JaxDummy:
    """The JAX sampler protocol's model with the closed-form denoiser; counts
    its evaluations as they run (inside a scan or while_loop too)."""

    def __init__(self, nsteps):
        self.nsteps = nsteps
        self.loss_function = jax_hybrid_weight(CFG, nsteps, "l2")
        self._evals = 0

    def _count(self):
        self._evals += 1

    @property
    def evals(self):
        jax.effects_barrier()
        return self._evals

    def denoise(self, params, x, E=None, sigma=None, layers=None):
        jax.debug.callback(self._count)
        return x / (1.0 + sigma**2)


class TorchDummy:
    """The port's sampler protocol's model with the same denoiser; counts
    its evaluations and keeps the largest |x| it was given (the scale the
    sampler's state reaches)."""

    device = torch.device("cpu")

    def __init__(self, nsteps):
        self.nsteps = nsteps
        self.loss_function = hybrid_weight(CFG, nsteps, "l2")
        self.evals = 0
        self.scale = 0.0

    def denoise(self, x, E=None, sigma=None, layers=None):
        self.evals += 1
        self.scale = max(self.scale, float(x.abs().max()))
        return x / (1.0 + sigma**2)


def _config(options=None, **top):
    return dict(CFG, SAMPLER_OPTIONS=dict(options or {}), **top)


# DPMAdaptive with its PID gains at zero: the step-size factor is 1, every
# try is accepted, and the step is H_INIT until the clamp at t_end
FIXED_STEP = {"P_COEFF": 0.0, "I_COEFF": 0.0, "D_COEFF": 0.0, "H_INIT": 1.0}

# (case id, sampler, steps, SAMPLER_OPTIONS, top-level config keys, network
# evaluations).  The counts follow from each solver: t_steps has steps + 1
# entries (Karras ladder and 0), the discrete cosine ladder `steps`
# entries; Heun and DPM2 evaluate twice a step but the last; DPM++ 2S and
# SDE twice an interval; Restart adds K * (n - 1) * 2 a restart config;
# DPMAdaptive three a try at order 3, two at order 2 (9 tries of 1.0 over
# the 8.4 units of log-sigma of the 10-step ladder).
CASES = [
    ("DDim", "DDim", 5, {}, {}, 5),
    ("DDPM", "DDPM", 5, {}, {}, 5),
    ("DPM-6", "DPM", 6, {}, {}, 6),
    ("DPM-7", "DPM", 7, {}, {}, 7),
    ("DPM-8", "DPM", 8, {}, {}, 8),
    ("DPMAdaptive-fixed-step", "DPMAdaptive", 10, FIXED_STEP, {}, 27),
    ("DPMAdaptive-fixed-step-order2", "DPMAdaptive", 10, dict(FIXED_STEP, ORDER=2), {},
     18),
    ("DPMPP2S", "DPMPP2S", 5, {}, {}, 8),
    ("DPMPPSDE", "DPMPPSDE", 5, {}, {}, 8),
    ("DPMPPSDE-eta1", "DPMPPSDE", 5, {"ETA": 1.0}, {}, 8),
    ("DPMPP2M", "DPMPP2M", 5, {}, {}, 4),
    ("DPMPP2MSDE", "DPMPP2MSDE", 5, {}, {}, 4),
    ("DPMPP2MSDE-eta1", "DPMPP2MSDE", 5, {"ETA": 1.0}, {}, 4),
    ("DPMPP2MSDE-midpoint-eta1", "DPMPP2MSDE", 5, {"ETA": 1.0, "SOLVER": "midpoint"}, {},
     4),
    ("DPMPP3MSDE", "DPMPP3MSDE", 5, {}, {}, 4),
    ("DPMPP3MSDE-eta1", "DPMPP3MSDE", 6, {"ETA": 1.0}, {}, 5),
    ("LMS", "LMS", 6, {}, {}, 6),
    ("LMS-order2", "LMS", 5, {"ORDER": 2}, {}, 5),
    ("Euler", "Euler", 5, {}, {}, 5),
    ("Euler-noisy", "Euler", 5, {}, {"NOISY_SAMPLE": True}, 5),
    ("Euler-org-schedule", "Euler", 6, {"ORG_SCHEDULE": True}, {}, 5),
    ("Heun", "Heun", 5, {}, {}, 9),
    ("Heun-noisy", "Heun", 5, {}, {"NOISY_SAMPLE": True}, 9),
    ("DPM2", "DPM2", 5, {}, {}, 9),
    ("DPM2-noisy", "DPM2", 5, {}, {"NOISY_SAMPLE": True}, 9),
    ("Restart", "Restart", 10, {}, {}, 10 + 66),
    ("Restart-tied-noisy", "Restart", 10, {"RESTART_LIST": TIED_RESTART},
     {"NOISY_SAMPLE": True}, 10 + 8 + 4 + 2),
    ("Consistency-3", "Consistency", 3, {}, {}, 3),
    ("Consistency-5", "Consistency", 5, {}, {}, 5),
]


def _inputs(seed=0, rows=256):
    rng = np.random.default_rng(seed)
    start = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    E = np.ones((BATCH, 1), np.float32)
    table = rng.standard_normal((rows, BATCH, DIM)).astype(np.float32)
    return start, E, table


def _close(got, want, scale=None):
    """Both packages compute in f32; their sums, fused multiply-adds and
    exp/expm1 round differently in the last bit (XLA's exp is not correctly
    rounded on ~10 % of f32 inputs), a few ulps a step over a few steps:
    atol 1e-5 * (1 + |x|), far above that and far below any difference in
    a solver's algebra.  |x| is the state, elementwise, unless ``scale``
    gives the largest magnitude the state took on the way: DPM's order-3
    segments subtract terms of that size (its first segment spans ~4 units
    of log-sigma, e^h ~ 70), so the last bit of a step scalar is carried at
    that scale to a state 10-1000x smaller."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all() and np.isfinite(got).all()
    x = np.abs(want) if scale is None else scale
    bad = np.abs(got - want) > 1e-5 * (1 + x)
    assert not bad.any(), f"max diff {np.abs(got - want).max()} at |x| {np.max(x)}"


def _scale(name, tm):
    """The tolerance's |x| for ``name``: the state's largest magnitude for
    DPM's f32 order-3 segments, else the state elementwise."""
    return tm.scale if name == "DPM" else None


def _run_pair(name, steps, options, top, table, start, E, debug=False):
    cfg = _config(options, **top)
    js, ts = jax_get_sampler(name)(cfg), get_sampler(name)(cfg)
    js.set_noise_table(table)
    ts.set_noise_table(table)
    jm, tm = JaxDummy(steps), TorchDummy(steps)
    want = js(jm, None, jnp.asarray(start), jnp.asarray(E), None, steps, 0,
              jax.random.PRNGKey(0), debug)
    got = ts(tm, torch.from_numpy(start), torch.from_numpy(E), None, steps, 0,
             torch.Generator().manual_seed(0), debug)
    return js, ts, jm, tm, want, got


def test_registry_has_the_jax_samplers_in_order():
    assert list(SAMPLER_REGISTRY) == list(JAX_REGISTRY)
    assert len(SAMPLER_REGISTRY) == 16
    with pytest.raises(ValueError, match="is not supported; pick from"):
        get_sampler("Karras")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sampler_matches_jax(case):
    """Trajectory, noise rows consumed and network evaluations."""
    _, name, steps, options, top, evals = case
    start, E, table = _inputs()
    js, ts, jm, tm, want, got = _run_pair(name, steps, options, top, table, start, E)
    _close(got.numpy(), want, _scale(name, tm))
    assert ts.noise_draws == js.noise_draws
    assert tm.evals == jm.evals == evals


def _zoo():
    import chip_smoke

    return chip_smoke.ZOO


@pytest.mark.parametrize("i", range(13))
def test_card_run_evaluations(i):
    """chip_smoke.py's zoo run checks each sampler's network evaluations
    against its ZOO table: the same samplers, steps and options give those
    counts here, and the JAX package's samplers make as many (DPMAdaptive's
    count depends on the data: three a try)."""
    zoo = _zoo()
    assert len(zoo) == 13 and [z[0] for z in zoo] == [
        n for n in SAMPLER_REGISTRY if n not in ("DDim", "DDPM", "BespokeNonStationary")]
    name, steps, options, evals = zoo[i]
    start, E, table = _inputs(seed=5)
    js, ts, jm, tm, want, got = _run_pair(name, steps, options, {}, table, start, E)
    assert ts.noise_draws == js.noise_draws
    if name == "DPMAdaptive":
        assert evals is None and tm.evals == 3 * sum(ts.last_steps)
    else:
        assert tm.evals == jm.evals == evals
        _close(got.numpy(), want, _scale(name, tm))


@pytest.mark.parametrize("name,steps", [("Euler", 4), ("Heun", 4), ("LMS", 4),
                                        ("DPM", 7), ("DPMPP2S", 4), ("DPMPP2M", 4),
                                        ("Consistency", 3)])
def test_debug_trajectories_match_jax(name, steps):
    """The (x, xs, x0s) a sampler returns for --debug's plots."""
    start, E, table = _inputs(seed=1)
    *_, tm, want, got = _run_pair(name, steps, {}, {}, table, start, E, debug=True)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            _close(g.numpy(), w, _scale(name, tm))


@pytest.mark.parametrize("name", ["DPM", "DPMAdaptive", "DPMPP2M", "Consistency"])
def test_loss_table_side_effects_match_jax(name):
    """DPM-family samplers rebuild the model's loss tables at num_steps and
    keep them; Consistency rebuilds them at CONSIS_NSTEPS and restores them."""
    start, E, table = _inputs(seed=2)
    cfg = _config()
    jm, tm = JaxDummy(400), TorchDummy(400)
    get_sampler(name)(cfg)(tm, torch.from_numpy(start), torch.from_numpy(E), None, 6, 0,
                           torch.Generator().manual_seed(0))
    jax_get_sampler(name)(cfg)(jm, None, jnp.asarray(start), jnp.asarray(E), None, 6, 0,
                               jax.random.PRNGKey(0))
    tl, jl = tm.loss_function, jm.loss_function
    assert tl.n_steps == jl.n_steps == (400 if name == "Consistency" else 6)
    for attr in ("sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "posterior_variance"):
        np.testing.assert_array_equal(np.asarray(getattr(tl, attr)),
                                      np.asarray(getattr(jl, attr)))


def test_bespoke_with_a_theta_file_matches_jax(tmp_path):
    """theta from a .npy file, sigmas from the injected table (one row of B
    a step), sample_offset skipping the first step."""
    rng = np.random.default_rng(3)
    theta = (1.0 + 0.1 * rng.standard_normal((2, 6))).astype(np.float32)
    np.save(tmp_path / "bns.npy", theta)
    cfg = _config({"SAMPLER_PATH": str(tmp_path / "bns.npy")})
    start, E, _ = _inputs(seed=3)
    sig = np.abs(rng.standard_normal((5, BATCH))).astype(np.float32)
    js, ts = jax_get_sampler("BespokeNonStationary")(cfg), get_sampler("BespokeNonStationary")(cfg)
    js.set_noise_table(sig)
    ts.set_noise_table(sig)
    tm = TorchDummy(6)
    want = js(JaxDummy(6), None, jnp.asarray(start), jnp.asarray(E), None, 6, 1,
              jax.random.PRNGKey(0), True)
    got = ts(tm, torch.from_numpy(start), torch.from_numpy(E), None, 6, 1, None, True)
    _close(got[0].numpy(), want[0])
    _close(got[1].numpy(), want[1])
    assert got[2] is None and want[2] is None
    assert ts.noise_draws == js.noise_draws == 5 and tm.evals == 5


def test_bespoke_load_theta_errors_match_jax(tmp_path):
    for options, err in (({"TRAIN_SAMPLER": True, "SAMPLER_PATH": str(tmp_path / "t.npy")},
                          RuntimeError),
                         ({}, ValueError)):
        for get in (get_sampler, jax_get_sampler):
            with pytest.raises(err):
                get("BespokeNonStationary")(_config(options)).load_theta(4)
    # no SAMPLER_PATH: <data_folder>/bns_sampler.npy
    np.save(tmp_path / "bns_sampler.npy", np.ones((2, 4), np.float32))
    s = get_sampler("BespokeNonStationary")(_config(flags={"data_folder": str(tmp_path)}))
    s.load_theta(4)
    np.testing.assert_array_equal(s.theta, np.ones((2, 4), np.float32))


SAMPLERS_GAUSSIAN = [
    "DDim", "DDPM", "DPM", "DPMPP2S", "DPMPPSDE", "DPMPP2M", "DPMPP2MSDE",
    "DPMPP3MSDE", "Euler", "Heun", "DPM2", "LMS", "Restart",
]


@pytest.mark.parametrize("name", SAMPLERS_GAUSSIAN)
def test_sampler_preserves_gaussian(name):
    """The port's copy of tests/test_samplers.py's check: with the
    Bayes-optimal denoiser for N(0, 1) data, a consistent sampler's output
    is N(0, 1) again.  Random draws from the generator (no table), so the
    draws the JAX package takes outside any table are covered in law."""
    num_steps = 40
    model = TorchDummy(num_steps)
    sampler = get_sampler(name)(_config())
    gen = torch.Generator().manual_seed(0)
    start = torch.randn(64, 256, generator=gen)
    out = sampler(model, start, torch.ones(64, 1), None, num_steps, 0,
                  torch.Generator().manual_seed(1), False).numpy()
    assert out.shape == (64, 256) and np.isfinite(out).all()
    mean, std = float(out.mean()), float(out.std())
    assert abs(mean) < 0.1, f"{name}: mean {mean}"
    assert 0.8 < std < 1.25, f"{name}: std {std}"


@pytest.mark.parametrize("name,options", [("DPM", {"ETA": 1.0}), ("DPMAdaptive", {"ETA": 1.0}),
                                          ("DPMPP2S", {"ETA": 1.0})])
def test_generator_draws_match_jax_in_law(name, options):
    """The branches that draw from the generator even with a table set (the
    JAX package draws there from its PRNG, so no table can pair the draws):
    from the same start, the port's output has the JAX output's mean and
    spread.  16,384 values a side: the spread's sampling error is ~0.6 %;
    allow 3 %, and 0.02 on the mean."""
    num_steps = 40
    cfg = _config(dict(options, R_TOL=0.001, A_TOL=1e-4))
    start = np.random.default_rng(4).standard_normal((64, 256)).astype(np.float32)
    E = np.ones((64, 1), np.float32)
    want = np.asarray(jax_get_sampler(name)(cfg)(
        JaxDummy(num_steps), None, jnp.asarray(start), jnp.asarray(E), None, num_steps, 0,
        jax.random.PRNGKey(1)))
    got = get_sampler(name)(cfg)(TorchDummy(num_steps), torch.from_numpy(start),
                                 torch.from_numpy(E), None, num_steps, 0,
                                 torch.Generator().manual_seed(1)).numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert abs(float(got.mean()) - float(want.mean())) < 0.02
    assert abs(float(got.std()) / float(want.std()) - 1) < 0.03
    assert not np.allclose(got, want)  # the draws did happen


def test_dpm_adaptive_controller_matches_jax_on_an_exact_step():
    """The PID controller on (all three gains): from x = 0 every error
    estimate is exactly 0 in both packages, so each try's factor is the
    same function of the same history and both take the same steps.
    From a random start the estimate at large sigma is rounding noise
    (the solvers are exact there on this problem), so the step sizes, the
    accepted/rejected count and the output follow the last bits of each
    package's arithmetic and are not compared."""
    cfg = _config({"P_COEFF": 0.2, "I_COEFF": 0.7, "D_COEFF": 0.1, "H_INIT": 0.05})
    start = np.zeros((BATCH, DIM), np.float32)
    E = np.ones((BATCH, 1), np.float32)
    jm, tm = JaxDummy(10), TorchDummy(10)
    want = jax_get_sampler("DPMAdaptive")(cfg)(jm, None, jnp.asarray(start), jnp.asarray(E),
                                               None, 10, 0, jax.random.PRNGKey(0))
    sampler = get_sampler("DPMAdaptive")(cfg)
    got = sampler(tm, torch.from_numpy(start), torch.from_numpy(E), None, 10, 0, None)
    assert tm.evals == jm.evals == 3 * sum(sampler.last_steps)
    assert sampler.last_steps[1] == 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class JaxTanhDummy(JaxDummy):
    def denoise(self, params, x, E=None, sigma=None, layers=None):
        jax.debug.callback(self._count)
        return x / (1.0 + sigma**2) + 0.5 * jnp.tanh(x / sigma)


class TorchTanhDummy(TorchDummy):
    def denoise(self, x, E=None, sigma=None, layers=None):
        self.evals += 1
        return x / (1.0 + sigma**2) + 0.5 * torch.tanh(x / sigma)


@pytest.mark.parametrize("options", [{}, {"R_TOL": 0.01, "A_TOL": 1e-3}, {"ORDER": 2},
                                     {"P_COEFF": 0.2, "I_COEFF": 0.7, "D_COEFF": 0.1}],
                         ids=["default", "tight", "order2", "pid"])
def test_dpm_adaptive_controller_takes_the_jax_steps(options):
    """The PID controller on, from a random start, with a denoiser whose
    solvers are not exact (x / (1 + sigma^2) + tanh(x / sigma) / 2), so
    that the accept decisions follow real error estimates: both packages
    make as many tries (accepted and rejected).  The step sizes still
    differ in their last bits (the first estimates are rounding noise), and
    the outputs by what the solver's own tolerance allows: R_TOL relative
    to (1 + |x|)."""
    cfg = _config(options)
    start, E, _ = _inputs(seed=6)
    jm, tm = JaxTanhDummy(10), TorchTanhDummy(10)
    want = np.asarray(jax_get_sampler("DPMAdaptive")(cfg)(
        jm, None, jnp.asarray(start), jnp.asarray(E), None, 10, 0, jax.random.PRNGKey(0)))
    sampler = get_sampler("DPMAdaptive")(cfg)
    got = sampler(tm, torch.from_numpy(start), torch.from_numpy(E), None, 10, 0, None).numpy()
    order = options.get("ORDER", 3)
    assert tm.evals == jm.evals == order * sum(sampler.last_steps)
    assert sampler.last_steps[1] > 0
    r_tol = options.get("R_TOL", 0.05)
    assert np.isfinite(got).all() and (np.abs(got - want) <= r_tol * (1 + np.abs(want))).all()


def test_dpm_adaptive_reports_its_steps():
    sampler = get_sampler("DPMAdaptive")(_config({"R_TOL": 0.01, "A_TOL": 1e-3}))
    model = TorchDummy(10)
    start, E, _ = _inputs()
    out = sampler(model, torch.from_numpy(start), torch.from_numpy(E), None, 10, 0, None)
    accepted, rejected = sampler.last_steps
    assert np.isfinite(out.numpy()).all()
    assert accepted > 0 and rejected > 0 and model.evals == 3 * (accepted + rejected)
