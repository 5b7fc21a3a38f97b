"""Cold diffusion and the numpy tools of calodiffusion_tpu_torch against the
JAX package on the CPU.

The cold prior (``tools/create_average_showers.py``: per-energy-bin
average and std showers of the loader's preprocessed showers) bit for bit;
the bin lookup and ``gen_cold_image`` bit for bit; a cold train-step loss
and a val loss from injected unit noise and sigma draws within 2e-4
relative (f32, U-Net widths 8; the bound of tests/test_torch_port_train.py's
plain loss: the forward agrees within the 2e-4 weight-transfer bound and
the loss to ~7e-5 relative, measured, with plain noise as with cold); the
cold sampling start; a port-only
train -> sample run of the CLIs with ``COLD_DIFFU``.  The tools
``h5_merge``, ``plot_avg_shower`` and ``plot_evolution`` against the JAX
tools' outputs.  Synthetic showers stand in for Geant4's."""

import json

import h5py
import numpy as np
import pytest
import torch

import jax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.tools import create_average_showers as jcreate
from calodiffusion_tpu.tools import h5_merge as jmerge
from calodiffusion_tpu.tools import plot_avg_shower as jplot_avg
from calodiffusion_tpu_torch import inference as tinf
from calodiffusion_tpu_torch import training as ttrain
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.samplers.base import randn
from calodiffusion_tpu_torch.tools import create_average_showers as tcreate
from calodiffusion_tpu_torch.tools import h5_merge as tmerge
from calodiffusion_tpu_torch.tools import plot_avg_shower as tplot_avg
from calodiffusion_tpu_torch.tools import plot_evolution as tplot_evolution
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_data import make_h5
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config

LOSS_RTOL = 2e-4


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
def workspace(tmp_path_factory):
    """Two ds2 files of 32 synthetic showers, a tiny cold config and its
    prior written by the JAX tool."""
    root = tmp_path_factory.mktemp("cold")
    data = root / "data"
    data.mkdir()
    for i, fname in enumerate(("dataset_2_1.hdf5", "dataset_2_2.hdf5")):
        make_h5(data / fname, 32, 6480, seed=10 + i)
    avg_loc = str(root / "avg_showers.h5")
    cfg = tiny_ds2_config(EVAL=["dataset_2_2.hdf5"], VAL_FILES=["dataset_2_2.hdf5"],
                          BATCH=16, MAXEPOCH=1, NSTEPS=4, LAYER_SIZE_UNET=[8, 8, 8, 8],
                          COND_SIZE_UNET=16, COLD_DIFFU=True, COLD_NOISE=0.5,
                          AVG_SHOWER_LOC=avg_loc, CHECKPOINT_NAME="cold_test", PRECISION="f32")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    avg, std, bins = jcreate.build_average_showers(cfg, str(data) + "/")
    tcreate.write_average_showers(avg_loc, avg, std, bins)
    return root, str(data) + "/", str(cfg_path), cfg


# -- the prior -------------------------------------------------------------------

def test_average_showers_equal_the_jax_tool(workspace):
    """build_average_showers and the in-memory average_showers give the JAX
    tool's arrays bit for bit (100 bins for ds2, 15 for dataset 1); the CLI
    writes them."""
    root, data, cfg_path, cfg = workspace
    want = jcreate.build_average_showers(cfg, data)
    got = tcreate.build_average_showers(cfg, data)
    assert got[0].shape == (100, 1, 45, 16, 9) and got[2].shape == (100,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(1)
    flat = rng.standard_normal((40, 12)).astype(np.float32)
    E = rng.uniform(0.0, 1.0, (40, 1)).astype(np.float32)
    avg, std, bins = tcreate.average_showers(flat, E, 1)
    assert avg.shape == (15, 12) and bins.shape == (15,)
    sel = (np.digitize(E[:, 0], bins) - 1) == 3
    np.testing.assert_array_equal(avg[3], np.mean(flat[sel], axis=0))

    out = str(root / "cli_avg.h5")
    tcreate.main(["-c", cfg_path, "--data_folder", data, "-o", out])
    with h5py.File(out, "r") as f:
        for key, w in zip(("avg_showers", "std_showers", "E_bins"), want):
            np.testing.assert_array_equal(f[key][:], w)


@pytest.fixture(scope="module")
def pair(workspace):
    """The JAX model and the port's from the same weights, each with the
    prior loaded from AVG_SHOWER_LOC."""
    _, _, _, cfg = workspace
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=2)
    jm.init_cold_diffu()
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    tm.init_cold_diffu()
    return jm, params, tm


def test_lookup_and_cold_image_equal_jax(pair):
    """The bin of E (searchsorted left - 1, clipped; energies below the
    first edge, on edges and past the last among them) and the cold image,
    bit for bit."""
    jm, _, tm = pair
    edges = np.asarray(jm._E_bins)
    E = np.concatenate([[-0.5, edges[0], edges[1], edges[50], 0.5, 0.999, 1.0, 1.7],
                        np.random.default_rng(3).uniform(0, 1, 8)]).astype(np.float32)[:, None]
    noise = np.random.default_rng(4).standard_normal((len(E), 1, 45, 16, 9)).astype(np.float32)
    for got, want in zip(tm.lookup_avg_std_shower(torch.from_numpy(E)),
                         jm.lookup_avg_std_shower(E)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for scale in (0.0, 0.5, 1.0):
        got = tm.gen_cold_image(torch.from_numpy(E), scale, torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm.gen_cold_image(E, scale, noise)))


def test_cold_train_and_val_loss_equal_jax(workspace, pair):
    """The trainer's cold noise: a train step's loss (its unit noise through
    gen_cold_image of E's first column) and a val loss, from the same unit
    noise and sigma draws as the JAX loss on the JAX cold image; within
    2e-4 relative."""
    root, _, _, cfg = workspace
    jm, params, tm = pair
    data, E, layers = fake_batch(cfg, batch=3, seed=5)
    rng = np.random.default_rng(6)
    unit = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(3).astype(np.float32)
    cold = jm.gen_cold_image(E[:, :1], cfg["COLD_NOISE"], unit)
    want = float(jm.compute_loss(params, jax.random.PRNGKey(0), data, E, noise=cold,
                                 layers=layers, rnd_normal=rnd))
    mask = np.ones(3, np.float32)
    want_val = float(jm.loss_function(jm.denoise_fn(params), data, E, jax.random.PRNGKey(0),
                                      noise=cold, layers=layers, rnd_normal=rnd, mask=mask))

    trainer = TrainDiffusion(default_flags(checkpoint_folder=str(root / "unused")), dict(cfg),
                             load_data=False, save_model=False, device="cpu")
    trainer.init_model()
    trainer.model.load_state_dict(tm.state_dict())
    assert not trainer.model.has_cold_prior()
    d, e, lay = map(torch.from_numpy, (data, E, layers))
    got = trainer._accumulate_grads(d, e, lay, noise=torch.from_numpy(unit),
                                    rnd_normal=torch.from_numpy(rnd))
    assert trainer.model.has_cold_prior()  # loaded from AVG_SHOWER_LOC on first use
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    got_val = trainer.val_step(d, e, lay, torch.from_numpy(rnd), torch.from_numpy(mask),
                               noise=torch.from_numpy(unit))
    np.testing.assert_allclose(got_val.item(), want_val, rtol=LOSS_RTOL)


def test_cold_sampling_start(pair):
    """sample starts from gen_cold_image(E[:, :1], COLD_NOISE, unit noise)
    before any microbatching: with COLD_NOISE 0 the binned average itself,
    different for energies in different bins."""
    _, _, tm = pair

    def start_of(start, *_):  # a sampler that returns its start
        return start

    E = torch.tensor([[0.1], [0.9], [0.1], [0.55]])
    z = randn((4, 1, 45, 16, 9), torch.Generator().manual_seed(7), "cpu")
    got = tm.sample(E, num_steps=2, generator=torch.Generator().manual_seed(7),
                    sampler=lambda model, start, *a: start_of(start))
    torch.testing.assert_close(got, tm.gen_cold_image(E, 0.5, z), rtol=0, atol=0)
    tm.config["SAMPLE_MICROBATCH"] = 2
    tm.config["COLD_NOISE"] = 0.0
    try:
        got = tm.sample(E, num_steps=2, generator=torch.Generator().manual_seed(7),
                        sampler=lambda model, start, *a: start_of(start))
    finally:
        del tm.config["SAMPLE_MICROBATCH"]
        tm.config["COLD_NOISE"] = 0.5
    avg, _ = tm.lookup_avg_std_shower(E)
    torch.testing.assert_close(got, avg, rtol=0, atol=0)
    assert not torch.equal(avg[0], avg[1])


# -- the CLIs and the tools ----------------------------------------------------------

@pytest.fixture(scope="module")
def cold_run(workspace):
    """The port's train CLI with COLD_DIFFU (one epoch), then its sample CLI
    from the cold prior."""
    root, data, cfg_path, _ = workspace
    trainer = ttrain.main(["-c", cfg_path, "-d", data, "--checkpoint", str(root / "ckpt"),
                           "--seed", "3", "--device", "cpu", "diffusion"])
    model_loc = str(root / "ckpt" / "cold_test_Diffusion" / "final.ckpt")
    gen = str(root / "generated_cold.h5")
    tinf.main(["-c", cfg_path, "-d", data, "--device", "cpu", "--seed", "5", "sample",
               "--sample-steps", "3", "--model-loc", model_loc, "-g", gen, "diffusion"])
    return trainer, model_loc, gen


def test_cold_cli_train_and_sample(cold_run):
    trainer, _, gen = cold_run
    losses = np.loadtxt(f"{trainer.checkpoint_folder}/final_training_losses.txt", ndmin=1)
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert trainer.model.has_cold_prior()
    with h5py.File(gen, "r") as f:
        showers = f["showers"][:]
    assert showers.shape == (32, 6480) and np.isfinite(showers).all() and (showers >= 0).all()


def test_plot_evolution_writes_the_jax_tools_files(workspace, cold_run, tmp_path):
    """The trajectory plots of a trained checkpoint, named as the JAX tool
    names them (evolution_step{j}.png at its five steps)."""
    _, data, cfg_path, _ = workspace
    _, model_loc, _ = cold_run
    out = tmp_path / "evo"
    tplot_evolution.main(["-c", cfg_path, "--model-loc", model_loc, "-d", data,
                          "-o", str(out), "--sample-steps", "8", "--nevts", "16",
                          "--device", "cpu"])
    n = 8  # DDim's trajectory: one state a step
    want = {f"evolution_step{j}.png"
            for j in sorted(set([0, n // 4, n // 2, 3 * n // 4, n - 1]))}
    assert {p.name for p in out.iterdir()} == want


def test_h5_merge_equals_the_jax_tool(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"in{i}.h5"
        with h5py.File(p, "w") as f:
            f.create_dataset("showers", data=np.full((5, 4), i, np.float32))
            f.create_dataset("incident_energies", data=np.full((5, 1), i, np.float32))
        files.append(str(p))
    outs = []
    for tool, name in ((jmerge, "jax.h5"), (tmerge, "port.h5")):
        tool.merge_multiple(str(tmp_path / name), files)
        outs.append(str(tmp_path / name))
    with h5py.File(outs[0], "r") as fj, h5py.File(outs[1], "r") as ft:
        assert list(fj.keys()) == list(ft.keys())
        for key in fj:
            np.testing.assert_array_equal(ft[key][:], fj[key][:])
            assert (ft[key].maxshape, ft[key].compression) == (fj[key].maxshape,
                                                               fj[key].compression)
        assert ft["showers"].shape == (15, 4)


def test_plot_avg_shower_writes_the_jax_tools_files(tmp_path):
    cfg = tiny_ds2_config()
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    rng = np.random.default_rng(8)
    with h5py.File(tmp_path / "showers.h5", "w") as f:
        f.create_dataset("showers", data=rng.exponential(1.0, (8, 6480)).astype(np.float32))
    names = []
    for tool, out in ((jplot_avg, tmp_path / "jax"), (tplot_avg, tmp_path / "port")):
        tool.main(["-c", str(tmp_path / "config.json"), "-i", str(tmp_path / "showers.h5"),
                   "-o", str(out), "--EMin", "0.5"])
        names.append(sorted(p.name for p in out.iterdir()))
    assert names[0] == names[1] and len(names[1]) == 45
