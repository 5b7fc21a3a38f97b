"""calodiffusion_tpu_torch stands alone: no module of the port, nor
chip_smoke.py, imports JAX, flax or the JAX package, and the port imports
and runs with those (and the packages the card machine lacks) blocked."""

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
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "flax", "calodiffusion_tpu", "h5py", "yaml", "click", "orbax")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import {name}")
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
print("ok")
"""


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr
