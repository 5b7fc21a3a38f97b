"""The port's CLIs on CMS HGCal (the README's recipe), on a mock HGCal h5 of
the JAX tests' synthetic geometry (91 cells, 4 layers, grid (4, 8, 6)):
train (diffusion, layer, distill), sample (dense and ``--sparse-decoding``),
read back and plot as the JAX package does, the HGCal plots, and
``tools/plot_h5_shower``."""

import json
import os

import h5py
import numpy as np
import pytest
import torch

from calodiffusion_tpu import inference as jinf
from calodiffusion_tpu.evaluation import plots as jplots
from calodiffusion_tpu.utils import hgcal_utils as jh
from calodiffusion_tpu.utils.config import dotdict
from calodiffusion_tpu_torch import inference as tinf
from calodiffusion_tpu_torch import plot as tplot
from calodiffusion_tpu_torch import training as ttrain
from calodiffusion_tpu_torch.evaluation import plots as tplots
from calodiffusion_tpu_torch.tools import plot_h5_shower
from tests.test_torch_port_hgcal import NCELL, _cells, hgcal_config


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
    """The geometry (JAX save_geom), mock HGCal h5 files (gen_info of three
    columns, showers (n, 4, 91)) and a tiny pre-embed config."""
    root = tmp_path_factory.mktemp("hgcal_cli")
    geom = str(root / "geom.pkl")
    jh.save_geom(jh.make_synthetic_geom(nlayers=4, cells_per_ring=6, nrings=5), geom)
    data = root / "data"
    data.mkdir()
    for i, (fname, n) in enumerate((("hgcal_train.h5", 32), ("hgcal_eval.h5", 8))):
        rng = np.random.default_rng(i)
        with h5py.File(data / fname, "w") as f:
            f.create_dataset("gen_info", data=rng.uniform(0.3, 0.9, (n, 3)).astype("<f4"))
            f.create_dataset("showers", data=_cells(n, seed=10 + i, scale=0.01))
    cfg = hgcal_config(geom, FILES=["hgcal_train.h5"], EVAL=["hgcal_eval.h5"], VAL_FILES=[],
                       BATCH=16, MAXEPOCH=1, NSTEPS=4, CHECKPOINT_NAME="hgcal_cli")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    return root, str(data) + "/", str(cfg_path), cfg


@pytest.fixture(scope="module")
def trained(workspace):
    root, data, cfg_path, _ = workspace
    return ttrain.main(["-c", cfg_path, "-d", data, "--checkpoint", str(root / "ckpt"),
                        "--device", "cpu", "--hgcal", "diffusion"])


def _sample(workspace, trained, name, *extra):
    root, data, cfg_path, _ = workspace
    gen = str(root / f"gen_{name}" / "generated.h5")
    os.makedirs(os.path.dirname(gen), exist_ok=True)
    tinf.main(["-c", cfg_path, "-d", data, "--device", "cpu", "--seed", "5", "--hgcal",
               "sample", "--sample-steps", "2", "--model-loc",
               os.path.join(trained.checkpoint_folder, "final.ckpt"), "-g", gen, *extra,
               "diffusion"])
    with h5py.File(gen, "r") as f:
        showers, gen_info = f["showers"][:], f["gen_info"][:]
    assert showers.shape == (8, 4, NCELL) and gen_info.shape == (8, 3)
    assert np.isfinite(showers).all() and (showers >= 0).all()
    return gen, showers, gen_info


def test_train_and_sample_clis_dense_and_sparse(workspace, trained):
    """Train one epoch on the pre-embedded cache; sample dense, then with
    --sparse-decoding and --sparse-per-batch (one seed, the same showers
    twice): the same gen_info, fewer lit cells, every lit cell one the
    decode matrix reaches."""
    root, data, _, cfg = workspace
    for name in ("checkpoint.ckpt", "final.ckpt", "config.json"):
        assert os.path.exists(os.path.join(trained.checkpoint_folder, name))
    assert os.path.exists(data + "hgcal_train.h5.npz")
    _, dense, info = _sample(workspace, trained, "dense")
    _, sparse, sinfo = _sample(workspace, trained, "sparse", "--sparse-decoding")
    _, again, _ = _sample(workspace, trained, "sparse2", "--sparse-decoding")
    _, per_batch, _ = _sample(workspace, trained, "per_batch", "--sparse-decoding",
                              "--sparse-per-batch")
    np.testing.assert_array_equal(sinfo, info)
    assert sparse.tobytes() == again.tobytes()
    assert (sparse > 0).sum() < (dense > 0).sum() and (per_batch > 0).sum() < (dense > 0).sum()
    conv = jh.HGCalConverter(bins=cfg["SHAPE_FINAL"], geom_file=cfg["BIN_FILE"]).init()
    reach = (conv.dec_mat > 1e-6).any(-1)  # (L, ncell)
    assert not (sparse > 0)[:, ~reach].any()


def test_process_data_dict_and_plots_as_jax(workspace, trained, tmp_path):
    """The sampled h5 and the Geant4 eval file read back (the MAX_CELLS
    slice, gen_info[:, 0] as the energy) as the JAX package reads them; the
    plot CLI draws the HGCal suite; RadialEnergyHGCal's ring profile equals
    the JAX package's."""
    root, data, cfg_path, cfg = workspace
    gen, _, _ = _sample(workspace, trained, "plots")
    flags = dotdict(data_folder=data, generated=gen, nevts=-1, job_idx=-1, EMin=-1.0,
                    geant_only=False, hgcal=True, plot_reshape=False, device="cpu",
                    plot_folder=str(tmp_path), plot_extensions=["png"], plot_label="",
                    cms=False, layer_only=False)
    got, got_e = tinf.process_data_dict(flags, dict(cfg))
    want, want_e = jinf.process_data_dict(dotdict(flags), dict(cfg))
    assert sorted(got) == sorted(want) == ["Geant4", "plots"]
    assert got_e.tobytes() == want_e.tobytes() and got_e.shape == (8, 1)
    for k in want:
        assert got[k].shape == (8, 4, NCELL) and got[k].tobytes() == want[k].tobytes()
    profile = tplots.RadialEnergyHGCal(flags, dict(cfg))(got, got_e)
    jflags = dotdict(flags, plot_folder=str(tmp_path / "jax"))
    want_profile = jplots.RadialEnergyHGCal(jflags, dict(cfg))(want, want_e)
    assert sorted(profile) == sorted(want_profile)
    for k in want_profile:
        assert profile[k].shape == (8, 6)
        assert profile[k].tobytes() == want_profile[k].tobytes()

    folder = str(root / "plots")
    seps = tplot.plot(["-c", cfg_path, "-d", data, "-g", gen, "--plot-folder", folder,
                       "--hgcal"])
    assert {"Energy R", "Energy R Center", "Energy Phi Center", "VoxelE"} <= set(seps)
    files = os.listdir(os.path.join(folder, "hgcal_cli"))
    for stem in ("EnergyR", "RCenter", "PhiCenter", "PhiWidthLayer"):
        assert any(f.startswith(stem) and f.endswith(".png") for f in files), stem


@pytest.mark.parametrize("cmd", ["layer", "distill"])
def test_hgcal_layer_and_distill_train(workspace, trained, cmd):
    """training.main layer and distill --hgcal on the pre-embedded cache:
    the cascade's layer net (three gen-info conditions, whitening over the
    5 layer values) and the distilled student, checkpoints written."""
    root, data, cfg_path, _ = workspace
    extra = ["--teacher-loc", os.path.join(trained.checkpoint_folder, "final.ckpt")] \
        if cmd == "distill" else []
    trainer = ttrain.main(["-c", cfg_path, "-d", data, "--checkpoint", str(root / "ckpt"),
                           "--device", "cpu", "--hgcal", cmd, *extra])
    assert os.path.exists(os.path.join(trainer.checkpoint_folder, "final.ckpt"))
    if cmd == "layer":
        assert trainer.model.layer_net.cond_mlp[0].weight.shape[1] == 3
        assert trainer.model.whiten["mean"].shape == (5,)


def test_plot_h5_shower_writes_its_files(workspace, trained, tmp_path):
    root, _, _, cfg = workspace
    gen, _, _ = _sample(workspace, trained, "hex")
    out = tmp_path / "hex"
    plot_h5_shower.main(["-g", cfg["BIN_FILE"], "-i", gen, "-n", "1", "-o", str(out),
                         "--shower-scale", "1.0"])
    assert sorted(os.listdir(out)) == sorted(
        f"{tag}_lay{i}.png" for tag in ("shower0", "avg_shower", "stddev_shower")
        for i in range(4))
