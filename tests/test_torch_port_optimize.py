"""calodiffusion_tpu_torch's optimisation harness and its CLI against the
JAX package's on the CPU.

- The suggestions (``_RandomTrial``, ``suggest_config``,
  ``suggest_sampler_config``) over a rich ``OPTIMIZE`` spec are plain Python
  and equal JAX's for the same numpy seed, sampler by sampler.
- The random study's report JSON is the JAX package's, byte for byte (the
  JAX package writes it through pandas, the port without).
- The ``optimize`` CLI has the JAX parser's flags and defaults, plus
  ``--device``.
- One trial end to end on the port (widths [8, 8, 8, 8], 2 sampling steps,
  COUNT, FPD and CNN): every value finite and none its objective's
  ``failure()``.
"""

import json
import math

import numpy as np
import pytest
import torch

from calodiffusion_tpu import optimize as jcli
from calodiffusion_tpu.train import optimize as jopt
from calodiffusion_tpu_torch import optimize as tcli
from calodiffusion_tpu_torch.train import optimize as topt
from calodiffusion_tpu_torch.utils.config import dotdict
from chip_smoke import DS2_PARTICLE, ds2_binning_xml
from tests.test_torch_port_data import make_h5
from tests.utils_test import tiny_ds2_config


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

SAMPLER_SETTINGS = {
    "ETA": [0.0, 1.0], "S_NOISE": [0.5, 1.5], "ORDER": [1, 3], "R_TOL": [0.01, 0.1],
    "A_TOL": [0.001, 0.01], "H_INIT": [0.01, 0.1], "T_ERROR": [1e-5, 1e-3],
    "ACCEPT_SAFETY": [0.5, 0.95], "R": [0.1, 0.9], "SOLVER": ["midpoint", "heun"],
    "NOISY_SAMPLE": [True, False], "ORIG_SCHEDULE": [True, False], "C1": [0.0005, 0.005],
    "RHO": [3, 9], "SIGMA_MIN": [0.001, 0.01], "S_MIN": [0.0, 0.1], "S_MAX": [10.0, 50.0],
    "S_CHURN": [0.0, 40.0], "RESTART_GAMMA": [0.01, 0.1], "C2": [0.001, 0.01],
    "RESTART_I": [1, 3], "N_RESTART": [1, 4], "RESTART_K": [1, 5], "RESTART_T": [0.05, 10],
}
SAMPLERS = ["Restart", "DPMAdaptive", "DPMPPSDE", "DPMPP2MSDE", "LMS", "Heun", "DDim"]


def _spec(samplers):
    return {
        "LAYER_SIZE_UNET": {"init_unet": [8, 32], "n_unet_layers": [2, 4],
                            "layer_ratio": [1, 3]},
        "LR": [1e-4, 1e-3],
        "BATCH": [16, 64],
        "TIME_EMBED": ["log", "sin"],
        "BLOCK_ATTN": [True, False],
        "SAMPLER": samplers,
        "SAMPLER_SETTINGS": SAMPLER_SETTINGS,
    }


def _optimizers(config, tmp_path=None):
    flags = dotdict(config=config, study_name="unit", n_trials=4,
                    results_folder=str(tmp_path) if tmp_path else None)
    return jopt.Optimize(flags, None, ["COUNT"]), topt.Optimize(flags, None, ["COUNT"])


@pytest.mark.parametrize("sampler", SAMPLERS + ["any"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_suggest_config_matches_jax(sampler, seed):
    samplers = SAMPLERS if sampler == "any" else [sampler]
    cfg = tiny_ds2_config(OPTIMIZE=_spec(samplers))
    j, t = _optimizers(cfg)
    jt = jopt._RandomTrial(np.random.default_rng(seed), 0)
    tt = topt._RandomTrial(np.random.default_rng(seed), 0)
    want, got = j.suggest_config(jt), t.suggest_config(tt)
    assert got == want
    assert tt.params == jt.params
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if sampler == "Restart":
        assert "RESTART_T_MAX_0" in tt.params and got["SAMPLER_OPTIONS"]["RESTART_LIST"]


def test_suggest_sampler_config_with_a_fixed_sampler_matches_jax():
    cfg = tiny_ds2_config(SAMPLER="Euler", OPTIMIZE={"SAMPLER_SETTINGS": SAMPLER_SETTINGS})
    j, t = _optimizers(cfg)
    jt = jopt._RandomTrial(np.random.default_rng(5), 0)
    tt = topt._RandomTrial(np.random.default_rng(5), 0)
    assert t.suggest_sampler_config(dict(cfg), tt) == j.suggest_sampler_config(dict(cfg), jt)
    assert tt.params == jt.params


def test_random_trial_draws_match_jax():
    jt = jopt._RandomTrial(np.random.default_rng(3), 0)
    tt = topt._RandomTrial(np.random.default_rng(3), 0)
    for trial in (jt, tt):
        trial.suggest_int("a", 2, 31, step=2)
        trial.suggest_int("b", 0, 5)
        trial.suggest_float("c", -1.0, 2.0)
        trial.suggest_categorical("d", ["x", "y", "z"])
    assert tt.params == jt.params


def test_report_json_matches_jax(tmp_path):
    cfg = tiny_ds2_config(OPTIMIZE=_spec(SAMPLERS))
    j, _ = _optimizers(cfg, tmp_path / "jax")  # each package writes into its own folder
    _, t = _optimizers(cfg, tmp_path / "torch")

    def objective(opt):
        def run(trial):
            config = opt.suggest_config(trial)
            if trial.number == 2:
                raise RuntimeError("a failed trial")
            return [config["LR"], float(len(config["LAYER_SIZE_UNET"]))]
        return run

    reports = []
    for opt, study_cls in ((j, jopt._RandomStudy), (t, topt._RandomStudy)):
        study = study_cls("unit", ["minimize", "minimize"])
        study.optimize(objective(opt), n_trials=4)
        opt.save_results(study)
        opt.save_results(study)  # appended, as the JAX package appends
        reports.append(opt.flags.results_folder + "/unit_report.json")
    want, got = (open(p).read() for p in reports)
    assert got == want
    first = json.loads(got[: len(got) // 2])
    assert first["number"] == [0, 1, 2, 3] and first["values"][2] is None


def test_optimize_cli_parser_matches_jax():
    jp, tp = jcli.optimize_parser(), tcli.optimize_parser()
    jopts = {o: a for o, a in jp._option_string_actions.items()}
    topts = {o: a for o, a in tp._option_string_actions.items()}
    assert set(topts) - set(jopts) == {"--device"}
    assert topts["--device"].default == "cuda"
    for o, a in jopts.items():
        b = topts[o]
        assert (b.dest, b.default, b.choices, b.nargs, b.type, b.required) == (
            a.dest, a.default, a.choices, a.nargs, a.type, a.required), o


def test_one_trial_end_to_end_on_the_port(tmp_path):
    """The CLI's random-search trial with all three objectives on the CPU;
    the trial's params are the JAX study's first draw."""
    data = tmp_path / "data"
    data.mkdir()
    make_h5(data / "dataset_2_1.hdf5", 32, 6480, 0)
    make_h5(data / "dataset_2_2.hdf5", 16, 6480, 1)
    xml = tmp_path / "binning.xml"
    xml.write_text(ds2_binning_xml())
    cfg = tiny_ds2_config(
        VAL_FILES=["dataset_2_2.hdf5"], BATCH=16, MAXEPOCH=1, NSTEPS=2,
        LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, CHECKPOINT_NAME="opt_test",
        OPTIMIZE={"LR": [1e-4, 1e-3], "SAMPLER_SETTINGS": {}}, SAMPLER="DDim",
        BIN_FILE=str(xml), PART_TYPE=DS2_PARTICLE)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        study = tcli.optimize(["-c", str(tmp_path / "config.json"), "-d", f"{data}/",
                               "-o", "COUNT", "FPD", "CNN", "--n-trials", "1", "--study-name",
                               "unit", "--results-folder", str(tmp_path / "results"),
                               "--device", "cpu"])
    finally:
        torch.set_num_threads(prev)
    report = json.loads((tmp_path / "results" / "unit_report.json").read_text())
    assert report["number"] == [0] and report["values"] == [study.trials[0]["values"]]
    jt = jopt._RandomTrial(np.random.default_rng(0), 0)
    jopt.Optimize(dotdict(config=cfg), None, ["COUNT"]).suggest_config(jt)
    assert report["params"] == [jt.params]
    values = report["values"][0]
    failures = [topt.Count.failure(), topt.FPD.failure(), topt.CNNMetric.failure()]
    assert values is not None and len(values) == 3
    for v, bad in zip(values, failures):
        assert math.isfinite(v) and v != bad
    assert values[2] <= 0  # a mean log posterior
