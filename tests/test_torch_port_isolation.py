"""calodiffusion_tpu_torch stands alone: no module of the port, nor
chip_smoke.py, nor the port's job scripts (scripts/torch_submit_*.py and the
Python that scripts/torch_train_h100.sh runs), nor its fidelity harnesses
(scripts/torch_fidelity_check.py, torch_fidelity_families.py,
torch_fewstep_check.py, torch_cascade_seeds.py), nor the last five scripts'
counterparts (torch_train_smoke.py, torch_int8_fence_regate.py,
torch_int8_cascade_ablation.py, torch_distill_extend.py,
torch_distill_variant.py), nor the four TPU probes' counterparts
(torch_level_profile.py, torch_l0_elementwise_ablation.py,
torch_im2col_microbench.py, torch_ds3_roofline.py, which also run here with
those blocked), nor any other scripts/torch_*.py, imports JAX,
flax, orbax, the JAX package or the scripts (scripts/orbax_to_torch.py, which needs
orbax, and the JAX package's scripts by their bare names among them); the job scripts launch the port's modules only; and the port imports
and runs with those (and the packages the card machine lacks: h5py, yaml,
click, matplotlib, sklearn, pandas, optuna) blocked, its train and sample
CLIs from npz caches too, and its classifier metrics and random study.
tests/torch_hgcal_split.py, which runs both packages, stays beside the
tests, and nothing under scripts/ imports it."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "calodiffusion_tpu_torch"
# and the JAX package's scripts by their bare names (the port's scripts
# import their siblings so, from scripts/ on sys.path)
JAX_SCRIPTS = tuple(sorted({p.stem for p in (ROOT / "scripts").glob("*.py")
                            if not p.stem.startswith("torch_")} | {"bench"}))
FORBIDDEN = ("jax", "flax", "orbax", "calodiffusion_tpu", "scripts", "orbax_to_torch") \
    + JAX_SCRIPTS


def _forbidden(name: str) -> bool:
    # exact name or dotted prefix: "calodiffusion_tpu_torch" is allowed
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


JOB_SCRIPTS = sorted((ROOT / "scripts").glob("torch_submit_*.py"))
TRAIN_SH = ROOT / "scripts" / "torch_train_h100.sh"
# the fidelity harnesses and the ds2 check they build on
HARNESSES = [ROOT / "scripts" / f"{name}.py" for name in (
    "torch_fidelity_check", "torch_fidelity_families", "torch_fewstep_check",
    "torch_cascade_seeds")]
# the last five JAX scripts' counterparts
SCRIPTS = [ROOT / "scripts" / f"{name}.py" for name in (
    "torch_train_smoke", "torch_int8_fence_regate", "torch_int8_cascade_ablation",
    "torch_distill_extend", "torch_distill_variant")]
# the four TPU probes' counterparts
PROBES = [ROOT / "scripts" / f"{name}.py" for name in (
    "torch_level_profile", "torch_l0_elementwise_ablation", "torch_im2col_microbench",
    "torch_ds3_roofline")]
OTHER_SCRIPTS = sorted(set((ROOT / "scripts").glob("torch_*.py"))
                       - set(JOB_SCRIPTS + HARNESSES + SCRIPTS))
SPLIT_HELPER = ROOT / "tests" / "torch_hgcal_split.py"


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + JOB_SCRIPTS + HARNESSES
            + SCRIPTS + OTHER_SCRIPTS)


def _imported(path) -> set:
    """Every module ``path`` imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _check_imports(path, source):
    tree = ast.parse(source, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    _check_imports(path, path.read_text())


def test_the_five_scripts_exist_and_are_checked():
    assert all(p.exists() for p in SCRIPTS)
    assert set(SCRIPTS) <= set(_sources())


def test_the_four_probes_exist_and_are_checked():
    assert all(p.exists() for p in PROBES)
    assert set(PROBES) <= set(OTHER_SCRIPTS) <= set(_sources())


def test_split_helper_runs_both_packages_and_stays_in_tests():
    """The helper imports the JAX package and the port (so it may not live
    under scripts/); no script imports it."""
    names = _imported(SPLIT_HELPER)
    assert any(n == "calodiffusion_tpu" or n.startswith("calodiffusion_tpu.") for n in names)
    assert any(n.startswith("calodiffusion_tpu_torch") for n in names)
    assert "jax" in names
    assert not (ROOT / "scripts" / SPLIT_HELPER.name).exists()
    for path in sorted((ROOT / "scripts").glob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert SPLIT_HELPER.stem not in _imported(path), path


def _launched_modules(text: str) -> list[str]:
    return re.findall(r"-m\s+(calodiffusion_tpu\w*)\.", text)


@pytest.mark.parametrize("path", JOB_SCRIPTS + [TRAIN_SH],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_job_scripts_launch_the_port_only(path):
    """Each job script launches the port's modules and nothing of the JAX
    package; torch_train_h100.sh's Python (the config's CHECKPOINT_NAME)
    imports neither JAX, the JAX package nor yaml."""
    text = path.read_text()
    assert JOB_SCRIPTS, "no scripts/torch_submit_*.py"
    assert set(_launched_modules(text)) == {"calodiffusion_tpu_torch"}, path
    assert not re.search(r"calodiffusion_tpu(?!_torch)\b", text)
    if path.suffix == ".sh":
        code = re.findall(r"<<'EOF'\n(.*?)\nEOF", text, re.S)
        assert len(code) == 1
        _check_imports(path, code[0])
        assert "yaml" not in ast.dump(ast.parse(code[0]))


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

# int8 sampling (ops/quant.py, ops/int8_conv.py, the int8 transpose of
# ops/conv.py) needs none of them either
import os
os.environ["CALODIFF_INT8_TRANSPOSE"] = "1"
m.config["QUANT_INT8"] = True
# the 36 convs of ds2's layout and the 2 transposes
assert len(m.prepare_int8(n_sigmas=1, batch=1)) == 38
with torch.no_grad(), m.int8_scope():
    yq = m.denoise(torch.randn(2, 1, 45, 16, 9), E=torch.rand(2, 1),
                   sigma=torch.full((2, 1, 1, 1, 1), 0.5), layers=torch.randn(2, 46))
assert yq.shape == y.shape and bool(torch.isfinite(yq).all())

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


_BLOCKED_PROBES = _BLOCKED_RUN.split("import calodiffusion_tpu_torch\n")[0] + r"""
import sys
sys.path.insert(0, "scripts")
import torch_ds3_roofline as trl
import torch_im2col_microbench as tim
import torch_l0_elementwise_ablation as tl0
import torch_level_profile as tlp

tlp.LS = [8, 8, 16, 8]
real = tlp.make_model
tlp.make_model = lambda kw, keep=None, **k: real(kw, keep, **dict(k, cond_dim=16))
cpu = ["--device", "cpu", "--batch", "1", "--iters", "1"]
assert set(tlp.main(cpu)["cases"]) == {c[0] for c in tlp.CASES}
assert set(tl0.main(cpu)["cases"]) == {c[0] for c in tl0.CASES}
tim.CASES = [("tiny", 1, (5, 4, 3), 8, 16)]
rep = tim.main(["--device", "cpu", "--iters", "1"])
assert rep["cases"][0]["rel_err"] <= tim.REL_ERR_MAX
trl.CONV_CASES = {"ds2": [((4, 4, 3), 8, 8)], "ds3": []}
rep = trl.main(["--device", "cpu", "--which", "ds2", "--iters", "1", "--steps", "1",
                "--batch", "1"])
assert rep["ds2"]["full"]["k1_blocks"] == 7
print("ok")
"""


def test_probe_scripts_run_with_jax_blocked():
    """The four probes on the CPU at a tiny cut, jax, flax, the JAX package
    and the packages the card machine lacks blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_PROBES], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr
