"""The check that decides ``correct``, driven through whole runs of tiny
cells on the CPU: the reference agrees with the port in float32, and each
fault a cell can have turns ``correct`` false."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import make_tiny_bench, tiny_config

from portbench import calibrate, harness, judge

GEN = ("tiny_ds3.generate.ddim400", "tiny_ds2.generate.ddim400")
TRAIN = ("tiny_ds3.train", "tiny_ds2.train")
SEED = 2**40 + 17  # past 32 signed bits, as the driver's are


def _run(bench, workload, seconds=0.3):
    return harness.run_cell(bench, workload, SEED, seconds, False, device="cpu")


@pytest.mark.parametrize("workload", GEN + TRAIN)
def test_reference_agrees_with_the_port_in_float32(tiny_bench, workload):
    r = _run(tiny_bench, workload)
    assert r["correct"] and r["failed"] == 0
    # float32 on both sides: round-off only
    tol = {"gap": 1e-4, "grad3_diff": 1e-4, "update3_diff": 1e-4}
    for k, c in r["checks"].items():
        assert c["value"] < tol[k], (k, c)


@pytest.mark.parametrize("name", ["calochallenge_ds2", "calochallenge_ds3"])
def test_reference_denoiser_matches_the_ports(name):
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    from portbench import inputs
    from portbench.reference import diffusion as ref

    config = tiny_config(name)
    weights = inputs.make_weights(config, 5, "cpu")
    model = CaloDiffusion(config, n_steps=400, loss_type="l2", device="cpu")
    model.load_state_dict(weights)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, *config["SHAPE_PAD"][1:]), generator=g)
    E = torch.rand((3, 1), generator=g)
    layers = torch.randn((3, config["SHAPE_FINAL"][2] + 1), generator=g)
    sigma = torch.tensor([0.05, 1.0, 20.0]).reshape(3, 1, 1, 1, 1)
    with torch.no_grad():
        got = model.denoise(x, E=E, sigma=sigma, layers=layers)
        want = ref.Denoiser(config, weights)(x, E, sigma, layers if model.layer_cond else None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_bench, workload, monkeypatch):
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    monkeypatch.setattr(TrainDiffusion, "_apply_update", lambda self: None)
    r = _run(tiny_bench, workload)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["update3_diff"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out_is_caught(tiny_bench, workload, monkeypatch):
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    step = TrainDiffusion.train_step

    def half(self, data, E, layers):
        n = data.shape[0] // 2
        return step(self, data[:n], E[:n], None if layers is None else layers[:n])

    monkeypatch.setattr(TrainDiffusion, "train_step", half)
    r = _run(tiny_bench, workload)
    assert not r["correct"]


@pytest.mark.parametrize("workload", GEN)
def test_an_answer_altered_where_it_is_produced_is_caught(tiny_bench, workload, monkeypatch):
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    generate = CaloDiffusion.generate

    def altered(self, *args, **kw):
        showers, energies = generate(self, *args, **kw)
        return showers * 1.5, energies  # every shower half as energetic again

    monkeypatch.setattr(CaloDiffusion, "generate", altered)
    r = harness.run_cell(tiny_bench, workload, SEED, 0.3, False, device="cpu")
    assert not r["correct"] and r["failed"] > 0


def test_the_kept_rows_and_steps_are_drawn_from_the_seed():
    traffic = {"steps": 400, "check_rows": 8, "check_pairs": 3}
    rows, steps = judge.capture_plan(SEED, 64, traffic)
    assert (rows, steps) == judge.capture_plan(SEED, 64, traffic)
    assert len(rows) == 8 == len(set(rows)) and all(0 <= r < 64 for r in rows)
    assert steps[0] == 0 and steps[-1] == 399 and len(steps) >= 6
    assert (rows, steps) != judge.capture_plan(SEED + 1, 64, traffic)


def test_the_controls_read_above_the_sound_runs(tmp_path):
    """The control of each kind of cell, at a tiny size in bfloat16 on the
    CPU, reads well above the sound program; on the card the cells' own
    sizes give the limits (PERF.md)."""
    bench = make_tiny_bench(tmp_path, steps=12, precision="bf16")
    dev = torch.device("cpu")
    w = bench.workload("tiny_ds3.generate.ddim400")
    gen = calibrate.generation_readings(bench.config(w["config"]), bench.traffic(w["traffic"]),
                                        SEED, dev, control=True)
    assert gen["control_gap"] > 3 * gen["gap"]
    w = bench.workload("tiny_ds3.train")
    tr = calibrate.training_readings(bench.config(w["config"]), bench.traffic(w["traffic"]),
                                     SEED, dev, control=True)
    numbers = ("grad3_diff", "update3_diff")
    for bad in ("control", "half_batch"):
        assert any(tr[bad][k] > 3 * tr[k] for k in numbers), bad


def test_rel_l2_of_empty_showers():
    a = np.zeros((2, 5))
    b = np.ones((2, 5))
    assert judge.rel_l2(a, a).tolist() == [0.0, 0.0]
    assert judge.rel_l2(b, a).tolist() == [np.inf, np.inf]
    assert judge.rel_l2(a, b).tolist() == [1.0, 1.0]
