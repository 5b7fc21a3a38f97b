"""calodiffusion_tpu_torch at dataset 3's settings against the JAX package
on the CPU: the full (45, 50, 18) grid of configs/config_dataset3.json with
its "sigma" time embed, cosine noise schedule, "logit-norm" shower map
without layer conditioning, "id" cond embed and DATASET_NUM 3 R/Z images,
at widths [8, 8, 8, 8].  Weights, inputs and noise are made with numpy
from a seed and fed to both sides."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu.utils import preprocessing as jprep
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.utils import preprocessing as tprep
from tests.test_torch_port_model import random_params
from tests.test_torch_int8_family import Int8Runs, check_int8_generate
from tests.utils_test import fake_batch

ROOT = Path(__file__).resolve().parent.parent
# the weight-transfer bound of docs/DESIGN.md:32
DENOISE_ATOL = 2e-4
N_STEPS = 10


def ds3_config(**kw):
    """configs/config_dataset3.json at widths [8, 8, 8, 8], f32."""
    cfg = json.loads((ROOT / "configs" / "config_dataset3.json").read_text())
    cfg.update(LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, PRECISION="f32", BIN_FILE="")
    cfg.update(kw)
    return cfg


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


@pytest.fixture(scope="module")
def pair():
    cfg = ds3_config()
    jm = JaxModel(dict(cfg), n_steps=N_STEPS)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    tm = CaloDiffusion(dict(cfg), n_steps=N_STEPS, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return cfg, jm, params, tm


@pytest.fixture(scope="module")
def jax_denoise(pair):
    """JAX's denoise, compiled once for the three sigmas."""
    _, jm, params, _ = pair
    fn = jax.jit(lambda p, x, E, s: jm.denoise(p, x, E=E, sigma=s, layers=None))
    return lambda x, E, s: np.asarray(fn(params, x, E, s))


def test_ds3_settings_as_shipped(pair):
    cfg, jm, _, tm = pair
    assert (cfg["TIME_EMBED"], cfg["NOISE_SCHED"], cfg["SHOWERMAP"], cfg["COND_EMBED"],
            cfg["DATASET_NUM"]) == ("sigma", "cosine", "logit-norm", "id", 3)
    assert not tm.layer_cond and tm.cond_size == 1
    assert tm.loss_function.discrete_time and jm.loss_function.discrete_time


@pytest.mark.parametrize("sigma", [0.05, 0.7, 5.0])
def test_denoise_matches_jax(pair, jax_denoise, sigma):
    cfg, _, _, tm = pair
    x, E, _ = fake_batch(cfg, batch=2, seed=1)
    sig = np.full((2, 1, 1, 1, 1), sigma, np.float32)
    want = jax_denoise(x, E, sig)
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig))
    assert got.shape == (2, 1, 45, 50, 18)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


def test_ddim_trajectory_matches_jax(pair):
    """4 DDim steps from the same start noise and energies, the cosine
    schedule's discrete sigmas, within the bound the ds2 test uses."""
    cfg, jm, params, tm = pair
    steps = 4
    start, E, _ = fake_batch(cfg, batch=2, seed=2)
    js, ts = jax_get_sampler("DDim")(cfg), get_sampler("DDim")(cfg)
    want = np.asarray(js(jm, params, jnp.asarray(start), jnp.asarray(E), None, steps, 0,
                         jax.random.PRNGKey(0), False))
    with torch.no_grad():
        got = ts(tm, torch.from_numpy(start), torch.from_numpy(E), None, steps, 0, None, False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=steps * DENOISE_ATOL)


def test_loss_with_injected_noise_and_discrete_times_matches_jax(pair):
    """hybrid_weight / l2 with the cosine schedule: sigma from the injected
    discrete times, the same noise on both sides."""
    cfg, jm, params, tm = pair
    data, E, _ = fake_batch(cfg, batch=2, seed=3)
    noise = np.random.default_rng(4).standard_normal(data.shape).astype(np.float32)
    time = np.array([1, N_STEPS - 2])
    want = float(jax.jit(lambda p: jm.compute_loss(
        p, jax.random.PRNGKey(0), data, E, noise=noise, time=time))(params))
    with torch.no_grad():
        got = tm.compute_loss(torch.from_numpy(data), torch.from_numpy(E),
                              noise=torch.from_numpy(noise), time=torch.from_numpy(time)).item()
    assert abs(got - want) <= 2e-4 * abs(want), (got, want)


def test_reverse_norm_and_rz_images_equal_jax():
    cfg = ds3_config()
    rng = np.random.default_rng(5)
    voxels = rng.standard_normal((3, 1, 45, 50, 18)).astype(np.float32)
    E = rng.uniform(0.1, 1.0, (3, 1)).astype(np.float32)
    kw = dict(shape=cfg["SHAPE_FINAL"], emax=cfg["EMAX"], emin=cfg["EMIN"], layerE=None,
              logE=True, binning_file="", max_deposit=cfg["MAXDEP"],
              showerMap=cfg["SHOWERMAP"], dataset_num=3, ecut=float(cfg["ECUT"]))
    want = jprep.reverse_norm(voxels.copy(), E, **kw)
    got = tprep.reverse_norm(voxels.copy(), E, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tprep.create_R_Z_image(3, True, (1, 45, 50, 18)),
                    jprep.create_R_Z_image(3, True, (1, 45, 50, 18))):
        np.testing.assert_array_equal(g, w)


def test_generate_end_to_end_on_cpu(pair):
    """config -> model -> 2-step DDim -> reverse_norm: (n, 40500) showers."""
    cfg, _, _, tm = pair
    loader = [fake_batch(cfg, batch=2, seed=s)[1:] + (None,) for s in (6, 7)]
    showers, energies = tm.generate(loader, 2, generator=torch.Generator().manual_seed(0))
    assert showers.shape == (4, 40500) and energies.shape == (4, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()


# ---------------------------------------------------------------------------
# int8 (W8A8) sampling on the full grid (tests/test_torch_int8_family.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_runs(pair):
    cfg, jm, params, tm = pair
    x, E, _ = fake_batch(cfg, batch=2, seed=20)
    start = fake_batch(cfg, batch=2, seed=21)[0]
    return Int8Runs(cfg, jm, params, tm, x, E, None, np.full((2, 1, 1, 1, 1), 0.7, np.float32),
                    start, seed=22)


def test_int8_calibration_table_matches_jax(int8_runs):
    """No layer conditioning: E alone; JAX's key set with and without the
    transposes, the values within 1e-4."""
    int8_runs.check_tables()


def test_each_conv_of_an_int8_denoise_matches_the_jax_op(int8_runs):
    int8_runs.check_convs()


@pytest.mark.parametrize("what", ["denoise", "ddim"])
def test_int8_call_lies_within_int8_noise_of_jax(int8_runs, what):
    int8_runs.check_within_int8_noise(what)
    assert int8_runs.port[f"{what}_int8"].shape == (2, 1, 45, 50, 18)


def test_int8_generate_calibrates_on_the_first_batch(pair):
    cfg, _, _, tm = pair
    loader = [fake_batch(cfg, batch=1, seed=s)[1:] + (None,) for s in (23, 24)]
    assert check_int8_generate(tm, loader).shape == (2, 40500)
