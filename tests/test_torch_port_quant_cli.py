"""The sample CLI of calodiffusion_tpu_torch with ``--int8`` on the CPU
(``--device cpu``, Q1's plain version): ``sample ... diffusion`` and
``sample ... layer`` end to end on a tiny trained workspace, ``--no-int8``
as the float path bit for bit, and the flag written into the config as
the JAX CLI writes it (inference.py:91-100)."""

import json

import h5py
import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch import inference as tinf
from calodiffusion_tpu_torch import training as ttrain
from calodiffusion_tpu_torch.ops import int8_conv
from tests.test_torch_port_data import make_h5
from tests.utils_test import tiny_ds2_config


@pytest.fixture(autouse=True)
def _int8_env(monkeypatch):
    monkeypatch.delenv("CALODIFF_INT8", raising=False)
    monkeypatch.delenv("CALODIFF_INT8_TRANSPOSE", raising=False)


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
    """Tiny ds2 data, a config (widths 8) and its trained U-Net and layer net."""
    root = tmp_path_factory.mktemp("int8_cli")
    data = root / "data"
    data.mkdir()
    for i, fname in enumerate(("dataset_2_1.hdf5", "dataset_2_2.hdf5")):
        make_h5(data / fname, 16, 6480, seed=i)
    cfg = tiny_ds2_config(EVAL=["dataset_2_2.hdf5"], VAL_FILES=["dataset_2_2.hdf5"],
                          BATCH=8, MAXEPOCH=1, NSTEPS=4, LAYER_SIZE_UNET=[8, 8, 8, 8],
                          COND_SIZE_UNET=16, CHECKPOINT_NAME="int8_cli")
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    common = ["-c", str(cfg_path), "-d", str(data) + "/"]
    for model in ("diffusion", "layer"):
        ttrain.main(common + ["--checkpoint", str(root / "ckpt"), "--seed", "3", "--device",
                              "cpu", model])
    return root, common


def _sample(workspace, tmp_path, extra, model="diffusion", seed="5"):
    """Run the sample CLI; returns the h5's showers and the int8 conv calls."""
    root, common = workspace
    tmp_path.mkdir(exist_ok=True)
    gen = str(tmp_path / f"gen_{model}.h5")
    tail = [model] if model == "diffusion" else [
        model, "--layer-model", str(root / "ckpt" / "int8_cli_LayerModel" / "final.ckpt")]
    calls = []
    ref = int8_conv.int8_conv3d_reference

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return ref(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(int8_conv, "int8_conv3d_reference", counted)
        tinf.main(common + ["--device", "cpu", "--seed", seed, "sample", "--sample-steps", "2",
                            "--model-loc",
                            str(root / "ckpt" / "int8_cli_Diffusion" / "final.ckpt"),
                            "-g", gen, *extra, *tail])
    with h5py.File(gen, "r") as f:
        return f["showers"][:], calls


def test_sample_diffusion_with_int8(workspace, tmp_path):
    """Every network call runs the U-Net's 35 quantizable convs int8 (widths
    [8, 8, 8, 8]: 15 ResnetBlocks, 2 downsamples, 3 up-path residuals), 2
    DDim evaluations for each of the 2 batches of 8; the calibration on the
    first batch runs in float."""
    showers, calls = _sample(workspace, tmp_path, ["--int8"])
    assert showers.shape == (16, 6480) and np.isfinite(showers).all() and (showers >= 0).all()
    assert len(calls) == 2 * 2 * 35


def test_sample_layer_with_int8_warns_without_a_fence(workspace, tmp_path, capsys):
    showers, calls = _sample(workspace, tmp_path, ["--int8"], model="layer")
    assert showers.shape == (16, 6480) and np.isfinite(showers).all() and (showers >= 0).all()
    assert len(calls) == 2 * 2 * 35
    assert "WARNING: QUANT_INT8 on the layer cascade without QUANT_INT8_EXCLUDE" in \
        capsys.readouterr().out


def test_no_int8_is_the_float_path(workspace, tmp_path):
    """--no-int8 over a config that sets QUANT_INT8 samples the showers of
    the float path (no flag, no QUANT_INT8) bit for bit, with no int8 conv."""
    root, common = workspace
    plain, calls = _sample(workspace, tmp_path / "a", [])
    cfg = json.loads((root / "config.json").read_text())
    int8_cfg = root / "config_int8.json"
    int8_cfg.write_text(json.dumps(dict(cfg, QUANT_INT8=True)))
    try:
        common[1] = str(int8_cfg)
        off, calls_off = _sample(workspace, tmp_path / "b", ["--no-int8"])
    finally:
        common[1] = str(root / "config.json")
    assert calls == calls_off == []
    np.testing.assert_array_equal(off, plain)


@pytest.mark.parametrize("flag,want", [(["--int8"], True), (["--no-int8"], False), ([], None)])
def test_int8_flag_sets_quant_int8(workspace, flag, want):
    _, common = workspace
    flags = tinf.parse_flags(common + ["sample", "--model-loc", "m.ckpt", *flag, "diffusion"])
    assert flags.config.get("QUANT_INT8") == want
