"""calodiffusion_tpu_torch model, samplers and tools against the JAX
package on the CPU, at a tiny dataset-2 configuration with block and mid
attention on.  Weights, inputs and noise are made with numpy from a seed
and fed to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu.tools.torch_import import torch_state_dict_to_params
from calodiffusion_tpu.utils import preprocessing as jprep
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.utils import preprocessing as tprep
from tests.utils_test import fake_batch, tiny_ds2_config

# the weight-transfer bound of docs/DESIGN.md:32
DENOISE_ATOL = 2e-4


def _cfg(**kw):
    return tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16,
                           BLOCK_ATTN=True, MID_ATTN=True, PRECISION="f32", **kw)


def random_params(shapes, seed):
    """numpy params for a flax tree of ShapeDtypeStructs: kernels at torch's
    default bound, GroupNorm scales near 1."""
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
    cfg = _cfg()
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return cfg, jm, params, tm


@pytest.mark.parametrize("sigma", [0.05, 0.7, 5.0])
def test_denoise_matches_jax(pair, sigma):
    cfg, jm, params, tm = pair
    x, E, layers = fake_batch(cfg, batch=2, seed=1)
    sig = np.full((2, 1, 1, 1, 1), sigma, np.float32)
    want = np.asarray(jax.jit(
        lambda p, x, E, s, lay: jm.denoise(p, x, E=E, sigma=s, layers=lay)
    )(params, x, E, sig, layers))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E),
                         sigma=torch.from_numpy(sig), layers=torch.from_numpy(layers))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


def test_state_dict_reads_back_through_torch_import(pair):
    """Independent weight check: the port's state_dict, read by the JAX
    package's own reference-checkpoint importer, gives the params back."""
    cfg, jm, params, tm = pair
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    template = jax.tree_util.tree_map(np.zeros_like, params)
    back = torch_state_dict_to_params(sd, jm, template)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a, err_msg=str(path))


@pytest.mark.parametrize("name", ["DDim", "DDPM"])
def test_sampler_trajectory_matches_jax(pair, name):
    """4 steps from the same start noise, energies and layers (and, for the
    stochastic DDPM, the same injected noise table)."""
    cfg, jm, params, tm = pair
    steps = 4
    start, E, layers = fake_batch(cfg, batch=2, seed=2)
    table = np.random.default_rng(3).standard_normal((steps, *start.shape)).astype(np.float32)
    js, ts = jax_get_sampler(name)(cfg), get_sampler(name)(cfg)
    js.set_noise_table(table)
    ts.set_noise_table(table)
    want = np.asarray(js(jm, params, jnp.asarray(start), jnp.asarray(E),
                         jnp.asarray(layers), steps, 0, jax.random.PRNGKey(0), False))
    with torch.no_grad():
        got = ts(tm, torch.from_numpy(start), torch.from_numpy(E),
                 torch.from_numpy(layers), steps, 0, None, False)
    assert ts.noise_draws == js.noise_draws
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=steps * DENOISE_ATOL)


def test_reverse_norm_and_rz_images_equal_jax():
    cfg = _cfg()
    rng = np.random.default_rng(4)
    voxels = rng.standard_normal((3, 1, 45, 16, 9)).astype(np.float32)
    E = rng.uniform(0.1, 1.0, (3, 1)).astype(np.float32)
    layerE = rng.standard_normal((3, 46)).astype(np.float32)
    kw = dict(shape=cfg["SHAPE_FINAL"], emax=cfg["EMAX"], emin=cfg["EMIN"],
              layerE=layerE, logE=True, binning_file="", max_deposit=cfg["MAXDEP"],
              showerMap=cfg["SHOWERMAP"], dataset_num=2, ecut=float(cfg["ECUT"]))
    want = jprep.reverse_norm(voxels.copy(), E, **kw)
    got = tprep.reverse_norm(voxels.copy(), E, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tprep.create_R_Z_image(2, True, (1, 45, 16, 9)),
                    jprep.create_R_Z_image(2, True, (1, 45, 16, 9))):
        np.testing.assert_array_equal(g, w)


def test_generate_end_to_end_on_cpu(pair):
    """config -> model -> DDim -> reverse_norm -> showers; microbatched
    sampling equals one batch."""
    cfg, _, _, tm = pair
    loader = [fake_batch(cfg, batch=4, seed=s)[1:] + (None,) for s in (5, 6)]
    showers, energies = tm.generate(loader, 2, generator=torch.Generator().manual_seed(0))
    assert showers.shape == (8, 6480) and energies.shape == (8, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()

    _, E, lay = fake_batch(cfg, batch=4, seed=7)
    E, lay = torch.from_numpy(E), torch.from_numpy(lay)
    whole = tm.sample(E, lay, 2, torch.Generator().manual_seed(1))
    tm.config["SAMPLE_MICROBATCH"] = 2
    try:
        chunked = tm.sample(E, lay, 2, torch.Generator().manual_seed(1))
    finally:
        del tm.config["SAMPLE_MICROBATCH"]
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-5)


def test_unported_options_raise(pair):
    # M11's options build in both packages: COLD_DIFFU, REMAT, "FCN-orig";
    # a REMAT U-Net from the pair's weights denoises as the JAX package does
    # (remat changes no value; 2e-4)
    cfg, jm, params, _ = pair
    for kw in (dict(COLD_DIFFU=True), dict(REMAT=True),
               dict(SHOWER_EMBED="FCN-orig", NUM_LAYERS_LINEAR=3)):
        JaxModel(_cfg(**kw), n_steps=10)
        CaloDiffusion(_cfg(**kw), n_steps=10, device="cpu")
    tm = CaloDiffusion(_cfg(REMAT=True), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    assert tm.net.unet.remat
    x, E, layers = fake_batch(cfg, batch=2, seed=1)
    sig = np.full((2, 1, 1, 1, 1), 0.7, np.float32)
    want = np.asarray(jax.jit(
        lambda p, x, E, s, lay: jm.denoise(p, x, E=E, sigma=s, layers=lay)
    )(params, x, E, sig, layers))
    got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E),
                     sigma=torch.from_numpy(sig), layers=torch.from_numpy(layers))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=DENOISE_ATOL)
    # the in-model embeds are ported: without their geometry file (BIN_FILE
    # "") both packages raise where they read it
    for kw in (dict(SHOWER_EMBED="NN"), dict(HGCAL=True)):
        for model, extra in ((CaloDiffusion, dict(device="cpu")), (JaxModel, {})):
            with pytest.raises(FileNotFoundError):
                model(_cfg(**kw), **extra)
    # every sampler is ported: an unknown name raises with the JAX wording
    with pytest.raises(ValueError, match="sampler 'Karras' is not supported; pick from"):
        get_sampler("Karras")


def test_entry_point_without_cuda_raises(monkeypatch):
    """No device given and no CUDA present: raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CaloDiffusion(_cfg())
