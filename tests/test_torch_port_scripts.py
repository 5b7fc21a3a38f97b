"""The port's last five JAX-script counterparts on the CPU:
scripts/torch_train_smoke.py, torch_int8_fence_regate.py,
torch_int8_cascade_ablation.py, torch_distill_extend.py and
torch_distill_variant.py against scripts/tpu_*.py.

Each port script runs end to end with ``--device cpu`` at a tiny cut
(widths [8, 8, 8, 8], cond 16, a few events, 1 or 2 DDim steps), on workdirs laid
out as ``torch_fewstep_check.py --distill 1 --workdir`` and
``torch_fidelity_families.py layer --workdir`` leave them (their data drawn
by those scripts' own functions, a teacher, a student and a cascade trained
one epoch each).  The JAX script runs beside it with its trainer, model,
loader and scorer stubbed (the stub scorer returns the port's row, the stub
calibration the port's scale table; its ``docs/`` redirected to the test's
folder), so that the report each writes can be held key for key to the
port's.  The train smoke's data and config are held to the JAX script's,
the fence to the config the JAX script samples with, and ``conv_groups`` to
the JAX function on the U-Net's conv paths.
"""

import argparse
import contextlib
import importlib.util
import json
import math
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_distill_extend as tde  # noqa: E402
import torch_distill_variant as tdv  # noqa: E402
import torch_fewstep_check as tfs  # noqa: E402
import torch_fidelity_families as tfam  # noqa: E402
import torch_int8_cascade_ablation as tca  # noqa: E402
import torch_int8_fence_regate as tfr  # noqa: E402
import torch_train_smoke as tsm  # noqa: E402
from torch_fidelity_check import int8_fence  # noqa: E402

CPU = ["--device", "cpu"]


def _load_jax(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads (the FPD's matrix square roots): the
    Tier-1 run shares the cores between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    """Every harness config at widths [8, 8, 8, 8], cond 16, for the module;
    no plot suite, as on the card's machine (no matplotlib there)."""
    base = tfam.tiny_ds2_config

    def small(**kw):
        return dict(base(**kw), LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfam, "tiny_ds2_config", small)
        mp.setattr(tfs, "tiny_ds2_config", small)
        mp.setitem(sys.modules, "matplotlib", None)
        yield


@pytest.fixture(scope="module")
def workdirs(tiny, tmp_path_factory):
    """A few-step workdir (data, a 1-epoch teacher, a 1-epoch student) and
    a cascade workdir (data, a 1-epoch base and stage 1), as the harnesses
    lay them out."""
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
    from calodiffusion_tpu_torch.utils.config import default_flags

    root = tmp_path_factory.mktemp("scripts")
    few, layer = root / "fewstep", root / "layer"
    few.mkdir()
    layer.mkdir()
    cfg = tfs.fewstep_config(1)
    tfam.write_caches(str(few), tfs.fewstep_showers(64, 24), cfg, "dataset_2_2.hdf5")
    data = str(few) + "/"
    t = TrainDiffusion(default_flags(data_folder=data, checkpoint_folder=str(few / "ckpt"),
                                     seed=1234), cfg, device="cpu")
    t.train()
    teacher = {k: v.detach().clone() for k, v in t.inference_weights().items()}
    TrainDistillation(default_flags(data_folder=data, checkpoint_folder=str(few / "ckpt_cd"),
                                    seed=1234),
                      dict(cfg, MAXEPOCH=1, CHECKPOINT_NAME="fewstep_cd", DISTILL_LR=1e-4),
                      teacher_params=teacher, device="cpu").train()

    opts = tfam.parse(["layer", "--device", "cpu", "--sample-steps", "2"])
    lcfg = tfam.layer_config(opts, 1)
    tfam.write_caches(str(layer), tfam.layer_showers(64, 24), lcfg, "dataset_2_2.hdf5")
    data = str(layer) + "/"
    TrainDiffusion(default_flags(data_folder=data, checkpoint_folder=str(layer / "ckpt"),
                                 seed=1234), dict(lcfg), device="cpu").train()
    TrainLayerModel(default_flags(data_folder=data, checkpoint_folder=str(layer / "ckpt_layer"),
                                  seed=1234), dict(lcfg), device="cpu").train()
    return argparse.Namespace(root=root, fewstep=few, layer=layer, cfg=cfg, lcfg=lcfg)


def _finite_rows(report):
    return all(math.isfinite(v) for row in report.values() for k, v in row.items()
               if k != "source")


# ---------------------------------------------------------------------------
# the train smoke
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def test_train_smoke_data_and_config_match_jax(tmp_path, monkeypatch):
    """The JAX script's h5 files bit for bit, and its config but for the
    checkpoint's name."""
    import calodiffusion_tpu.train.trainer as jtrainer
    import calodiffusion_tpu.utils.jax_setup as jsetup

    jsm = _load_jax("tpu_train_smoke")
    got = {}

    class Stub:
        def __init__(self, flags, config, *a, **kw):
            got["cfg"] = config
            raise _Stop

    monkeypatch.setattr(jtrainer, "TrainDiffusion", Stub)
    monkeypatch.setattr(jsetup, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jsm.tempfile, "mkdtemp", lambda **kw: str(tmp_path))
    with pytest.raises(_Stop):
        jsm.main()
    for fname, (showers, energies) in tsm.smoke_files(tsm.N_EVENTS).items():
        with h5py.File(tmp_path / fname, "r") as f:
            assert f["showers"][:].tobytes() == showers.tobytes()
            assert f["incident_energies"][:].tobytes() == energies.tobytes()
    want = dict(got["cfg"], CHECKPOINT_NAME="train_smoke")
    assert tsm.smoke_config(tsm.EPOCHS) == want


def test_train_smoke_end_to_end_on_cpu(tiny, tmp_path):
    """Two epochs of 64 showers, 2-step DDim: the report's keys, the checks
    passed; then one epoch, whose loss cannot fall: the report written, then
    the JAX script's loss check raises."""
    out = tmp_path / "smoke.json"
    argv = ["--events", "64", "--sample-steps", "2", "--workdir", str(tmp_path / "w"),
            "--out", str(out), *CPU]
    report = tsm.main(["--epochs", "2", "--no-loss-check", *argv])
    assert set(report) == {"train_s", "epochs", "steps_per_epoch", "batch", "epoch_losses",
                           "loss_ratio", "loss_ok", "showers", "sample_steps", "generate_s",
                           "showers_per_s", "mean_generated_E", "showers_ok", "card"}
    assert json.loads(out.read_text()) == report
    assert report["epochs"] == 2 and report["steps_per_epoch"] == 1 and report["showers"] == 64
    assert report["showers_ok"] and report["card"] == "CPU"
    with pytest.raises(AssertionError, match="loss did not decrease"):
        tsm.main(["--epochs", "1", *argv])
    assert json.loads(out.read_text())["loss_ok"] is False


# ---------------------------------------------------------------------------
# the JAX scripts beside the port's, stubbed
# ---------------------------------------------------------------------------

def _jax_workdir(tmp_path, port_workdir, layer=False):
    """The JAX scripts' view of a port workdir: the checkpoints' folders
    with their config.json (an empty final.ckpt), and the raw eval showers
    as the h5 file they read."""
    wd = tmp_path / "jax_workdir"
    for sub in (("ckpt", "ckpt_layer") if layer else ("ckpt", "ckpt_cd")):
        for cfg_path in (port_workdir / sub).glob("*/config.json"):
            dst = wd / sub / cfg_path.parent.name
            dst.mkdir(parents=True)
            (dst / "config.json").write_text(cfg_path.read_text())
            (dst / "final.ckpt").write_bytes(b"")
    with np.load(port_workdir / "dataset_2_2.hdf5.raw.npz") as f, \
            h5py.File(wd / "dataset_2_2.hdf5", "w") as h:
        h.create_dataset("showers", data=f["showers"])
        h.create_dataset("incident_energies", data=f["energies"])
    return wd


class _JaxModel:
    """The JAX model's surface the scripts call, returning showers of the
    eval set's shape."""

    def __init__(self, config, n, table=None):
        self.config, self.n, self.table, self._int8_scales = dict(config), n, table, None
        self.scales_seen = []

    def generate(self, params, key, loader, sample_steps=400, sampler=None, **kw):
        self.scales_seen.append(self._int8_scales if self.config.get("QUANT_INT8") else None)
        return np.full((self.n, 6480), 1e-3, np.float32), np.ones((self.n, 1), np.float32)

    def make_sampler(self, name):
        return name

    def sample_layers(self, params, key, E):
        return np.zeros((len(E), 46), np.float32)

    def prepare_int8(self, params, E=None, layers=None):
        return dict(self.table)


def _stub_jax(monkeypatch, jmod, tmp_path, argv):
    """The JAX script's heavy parts stubbed: its compile cache, its loader
    (one eval batch), its docs folder under ``tmp_path``; its argv."""
    import calodiffusion_tpu.data.loader as jloader
    import calodiffusion_tpu.utils.jax_setup as jsetup

    monkeypatch.setattr(jsetup, "enable_compile_cache", lambda *a, **k: None)
    batch = (np.ones((4, 1), np.float32), np.zeros((4, 46), np.float32), None)
    monkeypatch.setattr(jloader, "load_data", lambda *a, **k: ([batch], None))
    (tmp_path / "docs").mkdir(exist_ok=True)
    monkeypatch.setattr(jmod, "ROOT", str(tmp_path))
    monkeypatch.setattr(sys, "argv", [f"{jmod.__name__}.py", *argv])


def _row_scorer(row):
    """A compute_seps / separations stub returning the port's row."""
    return lambda *a, **k: {k: v for k, v in row.items() if k != "source"}


def _same_keys(got, want):
    assert set(got) == set(want)
    for tag in want:
        assert set(got[tag]) == set(want[tag]), tag


@pytest.fixture(scope="module")
def fence_run(workdirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("fence") / "fence.json"
    report = tfr.main(["--workdir", str(workdirs.fewstep), "--sample-steps", "1", "--out",
                       str(out), *CPU])
    return report, out


def test_fence_regate_end_to_end_and_keys_match_jax(fence_run, workdirs, tmp_path,
                                                   monkeypatch):
    """The port's report (the JAX script's int8_fence_regate.json), finite,
    sampled behind the fence the JAX script puts in the config it samples
    with."""
    import calodiffusion_tpu.train.trainer as jtrainer
    import tpu_fidelity_check

    report, out = fence_run
    assert json.loads(out.read_text()) == report and _finite_rows(report)
    jmod = _load_jax("tpu_int8_fence_regate")
    wd = _jax_workdir(tmp_path, workdirs.fewstep)
    seen = {}

    class Stub:
        def __init__(self, flags, config, *a, **kw):
            seen["cfg"] = config

        def load_for_inference(self):
            return _JaxModel(seen["cfg"], 24), None

    monkeypatch.setattr(jtrainer, "TrainDiffusion", Stub)
    monkeypatch.setattr(tpu_fidelity_check, "compute_seps", _row_scorer(report["int8_fenced"]))
    _stub_jax(monkeypatch, jmod, tmp_path, [f"--workdir={wd}"])
    jmod.main()
    _same_keys(report, json.loads((tmp_path / "docs" / "int8_fence_regate.json").read_text()))
    assert seen["cfg"]["QUANT_INT8"] is True
    assert seen["cfg"]["QUANT_INT8_EXCLUDE"] == int8_fence(workdirs.cfg)


@pytest.mark.parametrize("mode", ["coarse", "fine"])
@pytest.mark.parametrize("widths", [[32, 32, 64, 32], [8, 8, 8, 8, 8]])
def test_conv_groups_match_jax(mode, widths, monkeypatch):
    """On the U-Net's conv paths (the upsampling transposes included, which
    fall in "other"), the port's groups are the JAX function's."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    jmod = _load_jax("tpu_int8_cascade_ablation")
    monkeypatch.setenv("CALODIFF_INT8_TRANSPOSE", "1")
    cfg = dict(tfam.tiny_ds2_config(), LAYER_SIZE_UNET=widths, BLOCK_ATTN=True, MID_ATTN=True)
    table = dict.fromkeys(CaloDiffusion(cfg, device="cpu").quantizable_convs(), 0.1)
    n_res = len(widths) - 1
    got = tca.conv_groups(table, n_res, mode)
    assert got == jmod.conv_groups(table, n_res, mode)
    assert ("other" in got) and sum(map(len, got.values())) == len(table)


@pytest.fixture(scope="module")
def ablation_run(workdirs, tmp_path_factory):
    from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion

    tables, scoped = [], []
    real, real_scope = LayerDiffusion.prepare_int8, LayerDiffusion.int8_scope
    out = tmp_path_factory.mktemp("ablation") / "ablation.json"

    @contextlib.contextmanager
    def scope(self):
        with real_scope(self):  # the convs that run int8 inside it
            scoped.append({p for p, c in self.quantizable_convs().items()
                           if c.int8_scale is not None})
            yield

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LayerDiffusion, "prepare_int8",
                   lambda self, **kw: tables.append(real(self, **kw)) or tables[-1])
        mp.setattr(LayerDiffusion, "int8_scope", scope)
        report = tca.main(["--workdir", str(workdirs.layer), "--sample-steps", "1", "--events",
                           "20", "--out", str(out), *CPU])
    return report, out, tables, scoped


def test_cascade_ablation_end_to_end_and_keys_match_jax(ablation_run, workdirs, tmp_path,
                                                       monkeypatch):
    """The port's rows (bf16, int8_full, w8a16_all, excl_/only_ each coarse
    group of the calibrated table) are the JAX script's for the same table,
    each row's keys as the JAX script writes them; the run's fence keeps the
    down path out of the table, so no down group."""
    import calodiffusion_tpu.train.train_layer_model as jlayer

    report, out, tables, _ = ablation_run
    assert json.loads(out.read_text()) == report and _finite_rows(report)
    assert len(tables) == 1
    table = tables[0]
    groups = tca.conv_groups(table, 3, "coarse")
    assert "down" not in groups and set(groups) == {"mid", "up", "final_block"}
    assert list(report) == list(tca.ablation_rows(table, groups))

    jmod = _load_jax("tpu_int8_cascade_ablation")
    import scripts.tpu_fidelity_families as jfam

    wd = _jax_workdir(tmp_path, workdirs.layer, layer=True)
    model = _JaxModel(workdirs.lcfg, 24, table)

    class Stub:
        def __init__(self, flags, config, *a, **kw):
            model.config = dict(config)

        def load_for_inference(self):
            return model, None

    monkeypatch.setattr(jlayer, "TrainLayerModel", Stub)
    monkeypatch.setattr(jfam, "separations", _row_scorer(report["bf16"]))
    _stub_jax(monkeypatch, jmod, tmp_path, [f"--workdir={wd}"])
    jmod.main()
    want = json.loads((tmp_path / "docs" / "int8_cascade_ablation.json").read_text())
    _same_keys(report, want)
    assert list(report) == list(want)


def test_cascade_ablation_excluded_groups_run_float(ablation_run):
    """What ran int8 inside each row's ``int8_scope``: the row's table and
    nothing else; an excl_ row none of its group's convs, an only_ row its
    group's alone; weight-only for every conv of w8a16_all."""
    report, _, tables, scoped = ablation_run
    table = tables[0]
    groups = tca.conv_groups(table, 3, "coarse")
    rows = tca.ablation_rows(table, groups)
    for g, paths in groups.items():
        assert not set(paths) & set(rows[f"excl_{g}"])
        assert set(rows[f"only_{g}"]) == set(paths)
    assert all(v == "w8a16" for v in rows["w8a16_all"].values())
    # one int8_scope a generate batch, rows in order; the bf16 row sets none
    want = [set(t or {}) for t in rows.values()]
    per_row = len(scoped) // len(want)
    assert per_row * len(want) == len(scoped)
    for i, expected in enumerate(want):
        assert all(s == expected for s in scoped[i * per_row:(i + 1) * per_row]), \
            list(rows)[i]


@pytest.fixture(scope="module")
def distill_runs(workdirs, tmp_path_factory):
    """torch_distill_extend.py (to 2 epochs, Consistency@1,2,4), then
    torch_distill_variant.py (1 epoch) into the same report."""
    out = tmp_path_factory.mktemp("distill") / "distill_scaling.json"
    common = ["--workdir", str(workdirs.fewstep), "--out", str(out), *CPU]
    extend = dict(tde.main(["--to-epochs", "2", "--steps", "1,2,4", *common]))
    variant = tdv.main(["--epochs", "1", *common])
    return extend, variant, out


def test_distill_extend_resumes_the_student(distill_runs, workdirs):
    """The student resumed from its 1-epoch checkpoint to epoch 2; rows
    epochs2_Consistency_{1,2,4}, finite."""
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    extend, _, _ = distill_runs
    assert sorted(extend) == [f"epochs2_Consistency_{n}" for n in (1, 2, 4)]
    assert _finite_rows(extend)
    folder = next((workdirs.fewstep / "ckpt_cd").glob("*"))
    _, host = ckpt_io.load_checkpoint(str(folder), "checkpoint")
    assert host["epoch"] == 1


def test_distill_variant_appends_its_rows(distill_runs, workdirs):
    """The variant's config (the JAX script's overrides) and its rows with
    their source, merged into the extend run's report."""
    _, variant, out = distill_runs
    tag = "variant_n18_d0.999_e1"
    assert set(variant) == {f"epochs2_Consistency_{n}" for n in (1, 2, 4)} | {
        f"{tag}_Consistency_{n}" for n in (4, 2)}
    assert json.loads(out.read_text()) == variant and _finite_rows(variant)
    assert variant[f"{tag}_Consistency_4"]["source"].startswith("torch_distill_variant.py")
    name, cfg = tdv.variant_config(workdirs.cfg, 1, 18, 0.999)
    assert name == tag and (cfg["CONSIS_NSTEPS"], cfg["DISTILL_TARGET_DECAY"],
                            cfg["DISTILL_LR"]) == (18, 0.999, 1e-4)
    assert (workdirs.fewstep / f"ckpt_cd_{tag}" / f"fewstep_cd_{tag}_Distillation"
            / "final.ckpt").exists()


@pytest.mark.parametrize("script", ["tpu_distill_extend", "tpu_distill_variant"])
def test_distill_reports_keys_match_jax(script, distill_runs, workdirs, tmp_path, monkeypatch):
    """Each JAX script, stubbed, writes the rows the port's wrote, key for
    key, under the same argv."""
    import calodiffusion_tpu.train.checkpoint as jckpt
    import calodiffusion_tpu.train.train_distill as jdistill
    import tpu_fidelity_check

    _, variant, _ = distill_runs
    jmod = _load_jax(script)
    wd = _jax_workdir(tmp_path, workdirs.fewstep)
    seen = {}

    class Stub:
        ema_params = None

        def __init__(self, flags, config, *a, **kw):
            seen.update(flags=flags, cfg=config)

        def train(self):
            return _JaxModel(seen["cfg"], 24), None

    monkeypatch.setattr(jdistill, "TrainDistillation", Stub)
    monkeypatch.setattr(jckpt, "load_checkpoint", lambda *a, **k: ({}, {}))
    monkeypatch.setattr(jckpt, "inference_params", lambda *a, **k: {})
    monkeypatch.setattr(tpu_fidelity_check, "compute_seps",
                        _row_scorer(next(iter(variant.values()))))
    argv = ([f"--workdir={wd}", "--to-epochs=2", "--steps=1,2,4"]
            if script == "tpu_distill_extend" else [f"--workdir={wd}", "--epochs=1"])
    _stub_jax(monkeypatch, jmod, tmp_path, argv)
    jmod.main()
    want = json.loads((tmp_path / "docs" / "distill_scaling.json").read_text())
    got = {k: v for k, v in variant.items()
           if k.startswith("epochs" if script == "tpu_distill_extend" else "variant")}
    _same_keys(got, want)
    if script == "tpu_distill_variant":
        port = tdv.variant_config(workdirs.cfg, 1, 18, 0.999)[1]
        assert {k: seen["cfg"][k] for k in ("MAXEPOCH", "DISTILL_LR", "CONSIS_NSTEPS",
                                            "DISTILL_TARGET_DECAY")} == \
               {k: port[k] for k in ("MAXEPOCH", "DISTILL_LR", "CONSIS_NSTEPS",
                                     "DISTILL_TARGET_DECAY")}
    else:
        assert seen["cfg"]["MAXEPOCH"] == 2 and seen["flags"].load


def test_scripts_refuse_missing_workdirs(tmp_path):
    with pytest.raises(SystemExit, match="torch_fewstep_check"):
        tfr.main(["--workdir", str(tmp_path), *CPU])
    with pytest.raises(SystemExit, match="--distill"):
        tde.main(["--workdir", str(tmp_path), *CPU])



@pytest.mark.parametrize("script", [tsm, tfr, tca, tde, tdv])
def test_scripts_without_a_card_refuse(script, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        script.main(["--workdir", str(tmp_path)])
