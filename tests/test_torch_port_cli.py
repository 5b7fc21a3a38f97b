"""calodiffusion_tpu_torch's CLIs against the JAX package's on the CPU.

- Their surface: every click option of the JAX ``training.train``,
  ``inference.inference``, ``inference.sample`` and ``inference.plot``, and
  every option of ``plot.plot_parser()``, exists in the port's parser with
  the same default.
- End to end: the port's train CLI, then ``sample ... diffusion`` (2 DDim
  steps) writing an h5, then ``plot`` on it, at tiny widths on tiny
  synthetic data (the recipe of .claude/skills/verify/SKILL.md).
- The output functions on the same arrays: ``write_out``'s h5 datasets,
  ``process_data_dict``/``LoadSamples``' arrays and ``plot_results``'
  separation powers and file names equal the JAX package's.
"""

import argparse
import json
import os

import h5py
import numpy as np
import pytest
import torch

from calodiffusion_tpu import inference as jinf
from calodiffusion_tpu import plot as jplot
from calodiffusion_tpu import training as jtrain
from calodiffusion_tpu.evaluation import plots as jplots
from calodiffusion_tpu.utils.config import dotdict
from calodiffusion_tpu_torch import inference as tinf
from calodiffusion_tpu_torch import plot as tplot
from calodiffusion_tpu_torch import training as ttrain
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from tests.test_torch_port_data import make_h5
from tests.utils_test import tiny_ds2_config


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


# ---------------------------------------------------------------------------
# the CLI surface
# ---------------------------------------------------------------------------

def _subparser(parser, name):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices[name]


def _normal(v):
    return list(v) if isinstance(v, tuple) else v


COMMANDS = {
    "train": (jtrain.train, lambda: ttrain.train_parser()),
    "inference": (jinf.inference, lambda: tinf.inference_parser()),
    "sample": (jinf.sample, lambda: _subparser(tinf.inference_parser(), "sample")),
    "plot": (jinf.plot, lambda: _subparser(tinf.inference_parser(), "plot")),
    "train layer": (jtrain.layer, lambda: _subparser(ttrain.train_parser(), "layer")),
    "train distill": (jtrain.distill, lambda: _subparser(ttrain.train_parser(), "distill")),
    "sample layer": (jinf.layer, lambda: _subparser(
        _subparser(tinf.inference_parser(), "sample"), "layer")),
}


@pytest.mark.parametrize("name", list(COMMANDS))
def test_every_click_option_has_its_flag_and_default(name):
    cmd, port = COMMANDS[name]
    parser = port()
    defaults = cmd.make_context(cmd.name, [], resilient_parsing=True).params
    port_opts = parser._option_string_actions
    for p in cmd.params:
        for opt in p.opts + p.secondary_opts:
            assert opt in port_opts, f"{name}: no {opt}"
            assert _normal(port_opts[opt].default) == _normal(defaults[p.name]), (name, opt)
    extra = {o for o in port_opts if o not in {"-h", "--help"}} - {
        o for p in cmd.params for o in p.opts + p.secondary_opts}
    # the port's own option: the device, as JAX_PLATFORMS is the JAX package's
    assert extra == ({"--device"} if name in ("train", "inference") else set())
    if name in ("train", "inference"):
        assert port_opts["--device"].default == "cuda"
    sub = getattr(cmd, "commands", None)
    if sub:
        choices = next(a for a in parser._actions
                       if isinstance(a, argparse._SubParsersAction)).choices
        assert set(sub) == set(choices)


def test_plot_parser_matches_jax():
    want = {o: a.default for o, a in jplot.plot_parser()._option_string_actions.items()}
    got = {o: a.default for o, a in tplot.plot_parser()._option_string_actions.items()}
    assert got == want


def test_argparse_reads_click_style_command_lines():
    """Flag pairs, repeated -e and the group's options before the
    subcommand, as click reads them; the seed quirk of the JAX CLI."""
    f = tinf.parse_flags(["--no-layer", "--reclean", "--seed", "7", "sample", "--no-int8",
                          "--model-loc", "m.ckpt", "--sample-algo", "DDPM", "diffusion"])
    assert (f.layer_only, f.reclean, f.seed, f.int8, f.model) == (False, True, 7, False,
                                                                  "diffusion")
    assert f.config["SAMPLER"] == "DDPM" and f.config["SEED"] == 7
    assert f.config["QUANT_INT8"] is False and f.config["flags"]["model_loc"] == "m.ckpt"
    assert tinf.parse_flags(["plot"]).plot_extensions == ["png"]
    assert tinf.parse_flags(["plot", "-e", "pdf", "-e", "svg"]).plot_extensions == ["pdf", "svg"]
    seeds = {tinf.parse_flags(["plot"]).seed for _ in range(4)}
    assert all(100 <= s < 10**5 for s in seeds)
    with pytest.raises(ValueError, match="model-loc is required"):
        tinf.parse_flags(["sample", "diffusion"])


# ---------------------------------------------------------------------------
# end to end: train -> sample -> plot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    data.mkdir()
    for i, fname in enumerate(("dataset_2_1.hdf5", "dataset_2_2.hdf5")):
        make_h5(data / fname, 32, 6480, seed=i)
    cfg = tiny_ds2_config(EVAL=["dataset_2_2.hdf5"], VAL_FILES=["dataset_2_2.hdf5"],
                          BATCH=16, MAXEPOCH=1, NSTEPS=4, LAYER_SIZE_UNET=[8, 8, 8, 8],
                          COND_SIZE_UNET=16, CHECKPOINT_NAME="cli_test")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return root, str(data) + "/", str(cfg_path)


@pytest.fixture(scope="module")
def trained(workspace):
    root, data, cfg = workspace
    trainer = ttrain.main(["-c", cfg, "-d", data, "--checkpoint", str(root / "ckpt"),
                           "--seed", "3", "--device", "cpu", "diffusion"])
    return trainer


def test_train_cli_writes_the_jax_trainers_files(workspace, trained):
    root, _, _ = workspace
    folder = root / "ckpt" / "cli_test_Diffusion"
    assert trained.checkpoint_folder == str(folder)
    for name in ("checkpoint", "final"):
        for suffix in (".ckpt", "_state.json", "_training_losses.txt",
                       "_validation_losses.txt"):
            assert (folder / f"{name}{suffix}").exists(), name + suffix
    assert (folder / "best_val.ckpt").exists() and (folder / "config.json").exists()
    losses = (folder / "final_training_losses.txt").read_text().split()
    assert len(losses) == 1 and np.isfinite(float(losses[0]))


@pytest.fixture(scope="module")
def generated(workspace, trained):
    root, data, cfg = workspace
    gen = str(root / "gen_cli" / "generated.h5")
    os.makedirs(os.path.dirname(gen))
    model_loc = str(root / "ckpt" / "cli_test_Diffusion" / "final.ckpt")
    out = tinf.main(["-c", cfg, "-d", data, "--device", "cpu", "--seed", "5", "sample",
                     "--sample-steps", "2", "--model-loc", model_loc, "-g", gen, "diffusion"])
    assert out == gen
    return gen


def test_sample_cli_debug_writes_the_jax_trajectory_plots(workspace, trained, tmp_path,
                                                          monkeypatch):
    """--debug reaches generate: the first batch's trajectory is plotted
    into ./plots/ under the file names JAX's _debug_sample_plot gives a
    trajectory of that length."""
    from types import SimpleNamespace

    from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel

    root, data, cfg = workspace
    monkeypatch.chdir(tmp_path)
    model_loc = str(root / "ckpt" / "cli_test_Diffusion" / "final.ckpt")
    tinf.main(["-c", cfg, "-d", data, "--device", "cpu", "--debug", "sample",
               "--sample-steps", "3", "--sample-algo", "Euler", "--model-loc", model_loc,
               "-g", str(tmp_path / "gen.h5"), "diffusion"])
    traj = np.zeros((3, 2, 1, 45, 16, 9), np.float32)
    JaxModel._debug_sample_plot(SimpleNamespace(config={"CHECKPOINT_NAME": "cli_test"}), traj,
                                traj, traj[0], plot_folder=str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "plots")) == sorted(os.listdir(tmp_path / "jax"))


@pytest.fixture(scope="module")
def cascade(workspace, trained):
    """The layer CLI, then ``sample ... layer`` on its checkpoint and the
    diffusion one (2 DDim steps for the showers, LAYER_STEPS = NSTEPS = 4
    for the layer energies)."""
    root, data, cfg = workspace
    trainer = ttrain.main(["-c", cfg, "-d", data, "--checkpoint", str(root / "ckpt"),
                           "--seed", "4", "--device", "cpu", "layer"])
    gen = str(root / "gen_layer" / "generated.h5")
    os.makedirs(os.path.dirname(gen))
    out = tinf.main(["-c", cfg, "-d", data, "--device", "cpu", "--seed", "6", "sample",
                     "--sample-steps", "2", "--model-loc",
                     str(root / "ckpt" / "cli_test_Diffusion" / "final.ckpt"), "-g", gen,
                     "layer", "--layer-model",
                     str(root / "ckpt" / "cli_test_LayerModel" / "final.ckpt")])
    assert out == gen
    return trainer, gen


def test_layer_cli_trains_the_layer_net_and_samples_the_cascade(workspace, trained, cascade):
    """``layer`` writes the JAX trainer's files under <NAME>_LayerModel with
    the composite weights and whitening statistics, and leaves the base
    U-Net as it initialised it; ``sample ... layer`` writes the h5."""
    root, _, _ = workspace
    trainer, gen = cascade
    folder = root / "ckpt" / "cli_test_LayerModel"
    assert trainer.checkpoint_folder == str(folder)
    for name in ("final.ckpt", "best_val.ckpt", "checkpoint.ckpt", "config.json"):
        assert (folder / name).exists(), name
    arrays, _ = ckpt_io.load_checkpoint(str(folder), "final")
    params = arrays["params"]
    assert {"layer_model.whiten.mean", "layer_model.whiten.std"} <= set(params)
    assert any(k.startswith("base_model.") for k in params)
    assert trainer.model.layer_loss  # trained in layer mode
    fresh = type(trainer)(trainer.flags, trainer.config, load_data=False, save_model=False,
                          device="cpu")
    fresh.init_model()
    for k, v in fresh.model.state_dict().items():
        if k.startswith("base_model."):
            assert torch.equal(params[k], v), k
    with h5py.File(gen, "r") as f:
        showers = f["showers"][:]
        assert showers.shape == (32, 6480) and f["incident_energies"].shape == (32, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()


def test_distill_cli_then_consistency_sampling(workspace, trained, tmp_path):
    """``distill --teacher-loc`` writes <NAME>_Distillation/final.ckpt, a
    plain diffusion checkpoint that ``sample ... diffusion --sample-algo
    Consistency`` samples."""
    root, data, cfg = workspace
    teacher = str(root / "ckpt" / "cli_test_Diffusion" / "final.ckpt")
    trainer = ttrain.main(["-c", cfg, "-d", data, "--checkpoint", str(tmp_path), "--seed", "5",
                           "--device", "cpu", "distill", "--teacher-loc", teacher])
    folder = tmp_path / "cli_test_Distillation"
    assert trainer.checkpoint_folder == str(folder) and trainer.config["TEACHER_LOC"] == teacher
    assert (folder / "final.ckpt").exists()
    gen = str(tmp_path / "gen.h5")
    tinf.main(["-c", cfg, "-d", data, "--device", "cpu", "--seed", "6", "sample",
               "--sample-steps", "2", "--sample-algo", "Consistency", "--model-loc",
               str(folder / "final.ckpt"), "-g", gen, "diffusion"])
    with h5py.File(gen, "r") as f:
        showers = f["showers"][:]
    assert showers.shape == (32, 6480) and np.isfinite(showers).all() and (showers >= 0).all()


def test_sample_cli_writes_the_reference_h5(generated):
    with h5py.File(generated, "r") as f:
        assert sorted(f) == ["incident_energies", "showers"]
        for key, shape in (("showers", (32, 6480)), ("incident_energies", (32, 1))):
            d = f[key]
            assert d.shape == shape and d.compression == "gzip"
            assert d.maxshape == (None, shape[1])
        showers = f["showers"][:]
    assert np.isfinite(showers).all() and (showers >= 0).all()


def test_plot_cli_matches_jax_plot_results(workspace, generated, tmp_path, monkeypatch):
    """The port's plot CLI on the generated file; then JAX's plot_results
    and the port's on the same data_dict: the same separation powers (to
    1e-12) and the same files."""
    _, data, cfg = workspace
    folder = str(tmp_path / "port")
    seps = tinf.main(["-c", cfg, "-d", data, "plot", "-g", generated, "--plot-folder", folder])
    files = sorted(os.listdir(os.path.join(folder, "cli_test")))
    assert files and all(f.endswith(".png") for f in files)
    assert "TotalE_gen_logy.png" not in files and "TotalE_cli_logy.png" in files

    flags = dotdict(data_folder=data, generated=generated, nevts=-1, job_idx=-1, EMin=-1.0,
                    geant_only=False, hgcal=False, plot_reshape=False, layer_only=False,
                    plot_label="", cms=False, plot_extensions=["png"],
                    plot_folder=str(tmp_path / "jax"))
    config = json.load(open(cfg))
    data_dict, energies = tinf.process_data_dict(dotdict(flags), config)
    made = []
    init = jplots.Plot.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(jplots.Plot, "__init__", record)
    jinf.plot_results(dotdict(flags), config, data_dict, energies)
    want = {type(p).__name__: p.last_separations for p in made}
    tflags = dotdict(flags, plot_folder=str(tmp_path / "port2"))
    got = tinf.plot_results(tflags, config, data_dict, energies)
    _assert_same_separations({_PLOT_CLASSES[name]: sep for name, sep in got.items()}, want)
    _assert_same_separations(seps, got)
    jfiles = sorted(os.listdir(tmp_path / "jax" / "cli_test"))
    assert sorted(os.listdir(tmp_path / "port2" / "cli_test")) == jfiles == files


def _assert_same_separations(got, want):
    """Equal keys, values within 1e-12 (NaN where both are: a histogram
    with no entries in its bins)."""
    assert set(got) == set(want)
    for plot, w in want.items():
        g = got[plot]
        assert set(g) == set(w), plot
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-12 or (np.isnan(g[k]) and np.isnan(w[k])), (plot, k)


# plot_results' names of the CaloChallenge plots, and their classes
_PLOT_CLASSES = {
    "Energy per layer": "ELayer", "Energy": "HistEtot", "2D Energy scatter split": "ScatterESplit",
    "Energy Ratio split": "HistERatio", "Layer Sparsity": "SparsityLayer", "Nhits": "HistNhits",
    "VoxelE": "HistVoxelE", "Shower width": "AverageShowerWidth", "Max voxel": "HistMaxELayer",
    "Energy per radius": "AverageER", "Energy per phi": "AverageEPhi",
}


# ---------------------------------------------------------------------------
# the output functions against JAX, on the same arrays
# ---------------------------------------------------------------------------

def _h5_equal(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert sorted(fa) == sorted(fb)
        for k in fa:
            da, db = fa[k], fb[k]
            assert (da.dtype, da.shape, da.maxshape, da.compression) == \
                (db.dtype, db.shape, db.maxshape, db.compression), k
            np.testing.assert_array_equal(da[:], db[:])


@pytest.mark.parametrize("mask_file", [False, True], ids=["no_mask_file", "mask_file"])
def test_write_out_matches_jax(tmp_path, mask_file):
    """First write, an append, and do_mask with and without a mask file."""
    cfg = tiny_ds2_config()
    rng = np.random.default_rng(9)
    gen = [rng.exponential(1.0, (n, 6480)).astype(np.float32) for n in (3, 2)]
    gen[0][:, :100] = 0  # voxels empty in every shower: masked without a mask file
    en = [rng.uniform(1, 100, (n, 1)).astype(np.float32) for n in (3, 2)]
    flags = dotdict(data_folder=str(tmp_path) + "/")
    if mask_file:
        with h5py.File(tmp_path / "dataset_2_2_mask.hdf5", "w") as f:
            f.create_dataset("mask", data=rng.uniform(size=6480) < 0.3)
    for do_mask in (False, True):
        outs = []
        for mod in (jinf, tinf):
            fout = str(tmp_path / f"{mod.__name__}_{do_mask}.h5")
            mod.write_out(fout, flags, cfg, gen[0].copy(), en[0], first_write=True,
                          do_mask=do_mask)
            mod.write_out(fout, flags, cfg, gen[1].copy(), en[1], first_write=False,
                          do_mask=do_mask)
            outs.append(fout)
        _h5_equal(*outs)


@pytest.mark.parametrize("emin", [-1.0, 0.5], ids=["all", "EMin"])
def test_process_data_dict_and_load_samples_match_jax(workspace, generated, emin):
    _, data, cfg = workspace
    config = json.load(open(cfg))
    flags = dict(data_folder=data, generated=generated, nevts=20, job_idx=-1, EMin=emin,
                 geant_only=False, hgcal=False, plot_reshape=False)
    got, got_e = tinf.process_data_dict(dotdict(flags), dict(config))
    want, want_e = jinf.process_data_dict(dotdict(flags), dict(config))
    assert sorted(got) == sorted(want) == ["Geant4", "cli"]
    np.testing.assert_array_equal(got_e, want_e)
    for k in want:
        assert got[k].shape == want[k].shape == (20, 1, 45, 16, 9)
        np.testing.assert_array_equal(got[k], want[k])
    if emin > 0:
        raw, _ = tinf.LoadSamples(generated, dotdict(flags, EMin=-1.0), dict(config))
        assert ((raw > 0) & (raw < emin)).any() and not ((got["cli"] > 0) &
                                                         (got["cli"] < emin)).any()
    assert tinf.name_translate(generated) == jinf.name_translate(generated) == "cli"


# ---------------------------------------------------------------------------
# what the port does not do yet says so
# ---------------------------------------------------------------------------

# every sampler is ported: an unknown --sample-algo raises the JAX
# package's ValueError, before any data or weights are loaded
@pytest.mark.parametrize("argv,error,item", [
    (["sample", "--model-loc", "m.ckpt", "--sample-algo", "Karras", "diffusion"], ValueError,
     "sampler 'Karras' is not supported; pick from"),
], ids=["argv0-M8"])
def test_unported_sample_options_raise(argv, error, item):
    with pytest.raises(error, match=item):
        tinf.main(["--device", "cpu"] + argv)


def test_jax_checkpoint_is_refused_with_a_message(tmp_path):
    """The JAX package's checkpoints are Orbax directories: the message names
    the converter and its command for this checkpoint."""
    (tmp_path / "final.ckpt").mkdir()
    with pytest.raises(ckpt_io.ForeignCheckpointError,
                       match=f"scripts/orbax_to_torch.py .*--folder {tmp_path} --name final"):
        ckpt_io.load_checkpoint(str(tmp_path), "final")


def test_cli_without_a_card_raises(workspace, monkeypatch):
    """No --device and no CUDA: the CLI refuses, naming --device cpu."""
    _, data, cfg = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["-c", cfg, "-d", data, "diffusion"])
