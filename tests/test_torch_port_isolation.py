"""calodiffusion_tpu_torch stands alone: no module of the port, nor
chip_smoke.py, imports JAX, flax or the JAX package, and the port imports
and runs with those (and the packages the card machine lacks: h5py, yaml,
click, matplotlib, sklearn, pandas, optuna) blocked, its train and sample
CLIs from npz caches too, and its classifier metrics and random study."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "calodiffusion_tpu_torch"
FORBIDDEN = ("jax", "flax", "calodiffusion_tpu")


def _forbidden(name: str) -> bool:
    # exact name or dotted prefix: "calodiffusion_tpu_torch" is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


_BLOCKED_RUN = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys

BLOCKED = ("jax", "flax", "calodiffusion_tpu", "h5py", "yaml", "click", "orbax",
           "matplotlib", "sklearn", "pandas", "optuna")

class Refuse(importlib.abc.Loader):
    def create_module(self, spec):
        raise ImportError(f"blocked import {spec.name}")

    def exec_module(self, module):
        pass

class Block(importlib.abc.MetaPathFinder):
    # a spec whose import raises: torch._dynamo asks find_spec for optional
    # packages (pandas among them) and takes a raise there for a fault
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            return importlib.util.spec_from_loader(name, Refuse())
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
import calodiffusion_tpu_torch
for m in pkgutil.walk_packages(calodiffusion_tpu_torch.__path__, "calodiffusion_tpu_torch."):
    importlib.import_module(m.name)

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
cfg = dict(SHAPE_PAD=[-1, 1, 45, 16, 9], SHAPE_FINAL=[-1, 1, 45, 16, 9], DATASET_NUM=2,
           LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16, BLOCK_ATTN=True, MID_ATTN=True,
           COMPRESS_Z=True, CYLINDRICAL=True, SHOWERMAP="layer-logit-norm", R_Z_INPUT=True,
           NOISE_SCHED="log", TRAINING_OBJ="hybrid_weight", TIME_EMBED="log", COND_EMBED="id")
m = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    y = m.denoise(torch.randn(2, 1, 45, 16, 9), E=torch.rand(2, 1),
                  sigma=torch.full((2, 1, 1, 1, 1), 0.5), layers=torch.randn(2, 46))
assert y.shape == (2, 1, 45, 16, 9) and bool(torch.isfinite(y).all())

# the evaluation and the optimisation harness need neither sklearn, pandas
# nor optuna
import numpy as np
from calodiffusion_tpu_torch.evaluation.classifier import classifier_metrics
from calodiffusion_tpu_torch.train.optimize import _RandomStudy, _create_study
rng = np.random.default_rng(0)
m = classifier_metrics(rng.normal(size=(300, 4)), rng.normal(0.5, 1.0, (300, 4)), epochs=1,
                       device="cpu")
assert 0 <= m["auc"] <= 1 and m["jsd"] >= 0, m
study = _create_study("s", ["minimize"])
assert isinstance(study, _RandomStudy)
study.optimize(lambda trial: [trial.suggest_float("x", 0.0, 1.0)], n_trials=2)
assert study.report()["number"] == [0, 1]
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr


_BLOCKED_CLI = _BLOCKED_RUN.split("import calodiffusion_tpu_torch\n")[0] + r"""
import json, sys
from calodiffusion_tpu_torch import inference, training

cfg, data, ck = sys.argv[1:4]
trainer = training.main(["-c", cfg, "-d", data, "--checkpoint", ck, "--seed", "2",
                         "--device", "cpu", "diffusion"])
flags = inference.parse_flags(["-c", cfg, "-d", data, "--device", "cpu", "--seed", "1",
                               "sample", "--sample-steps", "2", "--model-loc",
                               trainer.checkpoint_folder + "/final.ckpt", "diffusion"])
showers, energies, fout = inference.generate_showers(flags, flags.config)
assert showers.shape == (8, 6480) and energies.shape == (8, 1), (showers.shape, energies.shape)
assert bool((showers >= 0).all()) and fout.endswith(".h5")
print("ok")
"""


def test_cli_runs_from_npz_caches_with_h5py_click_matplotlib_blocked(tmp_path):
    """The npz caches are made here; the h5 sources are then removed, and
    the train CLI (one epoch) and the sample CLI's loading and generation
    (2-step DDim) run with h5py, click, yaml and matplotlib blocked."""
    import json

    import h5py
    import numpy as np

    from calodiffusion_tpu_torch.data.loader import load_data
    from calodiffusion_tpu_torch.utils.config import default_flags
    from tests.utils_test import tiny_ds2_config

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for name in ("dataset_2_1.hdf5", "dataset_2_2.hdf5"):
        with h5py.File(data / name, "w") as f:
            f.create_dataset("showers", data=rng.exponential(1.0, (8, 6480)).astype(np.float32))
            f.create_dataset("incident_energies",
                             data=rng.uniform(1e3, 1e6, (8, 1)).astype(np.float32))
    cfg = tiny_ds2_config(BATCH=4, MAXEPOCH=1, LAYER_SIZE_UNET=[8, 8, 8, 8],
                          COND_SIZE_UNET=16, CHECKPOINT_NAME="blocked")
    flags = default_flags(data_folder=str(data) + "/")
    load_data(flags, cfg)
    load_data(flags, cfg, eval=True)
    for name in ("dataset_2_1.hdf5", "dataset_2_2.hdf5"):
        (data / name).unlink()
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_CLI, str(tmp_path / "config.json"),
                           str(data) + "/", str(tmp_path / "ckpt")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr
