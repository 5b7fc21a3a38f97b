"""Shared pieces of the benchmark's tests: the repository on ``sys.path``
and a benchmark of tiny cells, cut from the shipped configurations, that
runs on the CPU with the program's plain kernels."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

SHIPPED = harness.Bench.load(REPO / "BENCHMARK.json")


def tiny_config(name: str, precision: str = "float32") -> dict:
    """A shipped configuration at a tiny grid and width, in float32 unless
    asked: Z 6, A 4, the dataset's own radial bins, widths [8, 8, 16, 8],
    batch 4."""
    c = SHIPPED.config(name)
    r = c["SHAPE_PAD"][-1]
    c.update({"SHAPE_PAD": [-1, 1, 6, 4, r], "SHAPE_FINAL": [-1, 1, 6, 4, r],
              "SHAPE_ORIG": [-1, 6 * 4 * r], "LAYER_SIZE_UNET": [8, 8, 16, 8], "BATCH": 4,
              "PRECISION": "bf16" if precision == "bf16" else "f32"})
    return c


def make_tiny_bench(root: Path, steps: int = 12, precision: str = "float32") -> harness.Bench:
    """A benchmark whose cells are the shipped ones at tiny sizes (named
    ``tiny_<cell>``), their traffic with ``steps`` sampler steps, and the
    shipped cells' limits; files written under ``root``, metrics and the
    rest found among the shipped files."""
    spec = json.loads(json.dumps(SHIPPED.spec))
    for sub in ("configs", "traffic", "limits"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rename = {}
    for c in spec["configs"]:
        json.dump(tiny_config(c["name"], precision), open(root / "configs" / f"{c['name']}.json", "w"))
        c["file"] = f"configs/{c['name']}.json"
    for w in spec["workloads"]:
        traffic = SHIPPED.traffic(w["traffic"])
        if traffic["entry"] == "generate":
            traffic["steps"] = steps
        json.dump(traffic, open(root / "traffic" / f"tiny_{w['traffic']}.json", "w"))
        json.dump(SHIPPED.limits(w["name"]), open(root / "limits" / f"tiny_{w['name']}.json", "w"))
        rename[w["name"]] = "tiny_" + w["name"]
        w["name"], w["traffic"] = rename[w["name"]], "tiny_" + w["traffic"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[x] for x in m["workloads"]]
    return harness.Bench(spec, base=root, dirs=(root, harness.HERE))


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory):
    return make_tiny_bench(tmp_path_factory.mktemp("tiny_bench"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
