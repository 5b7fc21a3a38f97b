"""The result line, the refusal without a card, and what a run imports."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import REPO

from portbench import harness

BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "calodiffusion_tpu"}


def test_the_result_has_the_keys_the_driver_reads(tiny_bench):
    for traced in (False, True):
        r = harness.run_cell(tiny_bench, "tiny_ds2.train", 9, 1.5, traced, device="cpu")
        assert list(r)[-1] == "checks"
        assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
        assert isinstance(r["correct"], bool) and r["attempted"] > 0
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
        for m in r["metrics"].values():
            assert set(m) == {"value", "unit"}
        names = set(r["metrics"])
        if traced:
            assert {"busy_s", "window_s"} <= set(r["device"])
            assert "breakdown" in r and "setup_s" not in names and "mfu.train.ds2" in names
        else:
            assert names == {"train_samples_per_s.ds2", "setup_s"}
        for c in r["checks"].values():
            assert set(c) == {"value", "limit"}
        json.dumps(r, allow_nan=False)


def test_the_command_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ds2.train",
                           "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    import torch

    if not torch.cuda.is_available():
        assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port(tmp_path):
    """A whole tiny run in a fresh process, then the modules it holds,
    compared by whole top-level names."""
    code = f"""
import json, sys
sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})
sys.path.insert(0, {str(REPO)!r})
from conftest import make_tiny_bench
from pathlib import Path
from portbench import harness
bench = make_tiny_bench(Path({str(tmp_path)!r}), steps=4)
for w in ("tiny_ds2.generate.ddim400", "tiny_ds3.train"):
    harness.run_cell(bench, w, 5, 0.2, True, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "calodiffusion_tpu_torch" in loaded and not loaded & BANNED

    code = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
import portbench.reference.diffusion, portbench.reference.unet
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300)
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "calodiffusion_tpu_torch" not in loaded and not loaded & BANNED


def test_the_sources_import_only_what_they_may():
    """No file under portbench/ imports JAX, the JAX package, bench.py,
    scripts/ or chip_smoke; the reference imports nothing of the port."""
    for path in (REPO / "portbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module.split(".")[0])
        assert not names & (BANNED | {"bench", "scripts", "chip_smoke", "bench_baselines"}), path
        if "reference" in path.parts:
            assert "calodiffusion_tpu_torch" not in names, path
