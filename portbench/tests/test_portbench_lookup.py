"""The harness finds configurations, traffic mixes, limits and metrics by
name, and ``BENCHMARK.json`` holds to the contract's shape."""

from __future__ import annotations

import json
import re

import pytest
from conftest import REPO, SHIPPED

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    for w in SHIPPED.spec["workloads"]:
        config = SHIPPED.config(w["config"])
        traffic = SHIPPED.traffic(w["traffic"])
        limits = SHIPPED.limits(w["name"])
        assert traffic["entry"] in harness.ENTRIES
        assert config["BATCH"] > 0 and limits
        for traced in (False, True):
            for m in SHIPPED.metrics(w["name"], traced):
                assert callable(SHIPPED.reader(m["name"]))


def test_benchmark_json_has_the_contracts_shape():
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for group in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        # bf16 is this repo's addition to the published configs (PARITY.md)
        assert c["reduced"] == ["PRECISION"] == SHIPPED.config(c["name"])["reduced"]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m["name"] for m in spec["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
    # each rate has a bound of its own in each configuration
    for m in spec["end_to_end"]:
        if m["name"] != "setup_s":
            assert len(m["workloads"]) == 1


def test_a_split_metric_reads_with_its_unsplit_file():
    run = harness.RunRecord("generate", {}, {}, 64, window_s=2.0, units=800,
                            evals_per_call=400)
    assert SHIPPED.reader("showers_per_s.ds3")(run) == pytest.approx(64.0)
    assert SHIPPED.reader("showers_per_s.anything.else")(run) == pytest.approx(64.0)
    with pytest.raises(FileNotFoundError):
        SHIPPED.reader("no_such_metric.ds3")


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "metrics").mkdir()
    config = SHIPPED.config("calochallenge_ds2")
    config["BATCH"] = 32
    (tmp_path / "configs" / "ds2_small.json").write_text(json.dumps(config))
    traffic = dict(SHIPPED.traffic("generate.ddim400"), steps=100)
    (tmp_path / "traffic" / "generate.ddim100.json").write_text(json.dumps(traffic))
    (tmp_path / "limits" / "ds2.generate.ddim100.json").write_text('{"rel_l2": 0.5}')
    (tmp_path / "metrics" / "calls.generate.py").write_text(
        "def read(run):\n    return float(run.calls) if run.entry == 'generate' else None\n")
    spec = json.loads(json.dumps(SHIPPED.spec))
    spec["configs"].append({"name": "ds2_small", "source": "x", "file": "configs/ds2_small.json",
                            "reduced": ["BATCH"], "why": "x"})
    spec["workloads"].append({"name": "ds2.generate.ddim100", "config": "ds2_small",
                              "traffic": "generate.ddim100", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "calls.generate", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "entry",
                              "moves": "showers_per_s.ds2", "workloads": ["ds2.generate.ddim100"]})
    for m in spec["end_to_end"]:
        if m["name"] == "showers_per_s.ds2":
            m["workloads"].append("ds2.generate.ddim100")
    bench = harness.Bench(spec, base=tmp_path, dirs=(tmp_path, harness.HERE))
    w = bench.workload("ds2.generate.ddim100")
    assert bench.config(w["config"])["BATCH"] == 32
    assert bench.traffic(w["traffic"])["steps"] == 100
    assert bench.limits(w["name"]) == {"rel_l2": 0.5}
    traced = [m["name"] for m in bench.metrics(w["name"], True)]
    assert traced == ["calls.generate"]
    e2e = [m["name"] for m in bench.metrics(w["name"], False)]
    assert e2e == ["showers_per_s.ds2", "setup_s"]
    run = harness.RunRecord("generate", {}, {}, 32, calls=3)
    assert bench.reader("calls.generate")(run) == 3.0
    # the shipped cells are still found beside it
    assert bench.traffic("train")["entry"] == "train_step"
    with pytest.raises(FileNotFoundError):
        bench.traffic("no_such_mix")
