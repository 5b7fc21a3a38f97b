"""The port's fidelity harnesses (scripts/torch_fidelity_families.py,
scripts/torch_fewstep_check.py, scripts/torch_cascade_seeds.py) against the
JAX scripts they port, on the CPU.

Each family's synthetic data and config are held to the JAX family
function's: the JAX function runs with its ``run_family`` (or trainer)
stubbed to capture the config and folder and stop before training, so it
writes only its h5 files; the port's family function runs the same way and
writes its npz caches.  The raw eval showers the port keeps equal the JAX
eval file bit for bit, and every cache equals the one the port's loader
writes from the JAX h5 file (HGCal on a two-ring geometry: both packages'
``make_synthetic_geom`` are wrapped, called with the same arguments, and
build two rings; ds3 at ``--events 64``, its eval file compared on a
slice).  ``separations`` is held to the JAX script's on the same arrays:
the histogram terms bit for bit, the FPD bit for bit and the classifier's
AUC and JSD within 1e-3 from the same initial weights (the classifier's
weights after training are held within 1e-4 in
tests/test_torch_port_evaluation.py).  The gates and the report rules are
held to the JAX scripts' by running both on the same inputs; each harness
also runs end to end at tiny widths with ``--device cpu``.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_cascade_seeds as tcs  # noqa: E402
import torch_fewstep_check as tfs  # noqa: E402
import torch_fidelity_families as tfam  # noqa: E402


def _load_jax(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jfam():
    return _load_jax("tpu_fidelity_families")


@pytest.fixture(scope="module")
def jfs():
    return _load_jax("tpu_fewstep_check")


@pytest.fixture(scope="module")
def jcs():
    return _load_jax("tpu_cascade_seeds")


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


class _Stop(Exception):
    pass


def _capture(store):
    """A ``run_family`` that records its arguments and stops."""

    def stub(tag, cfg, tmp, *args, **kw):
        store.update(cfg=cfg, tmp=tmp, eval_file=args[1], energy_key=args[2], kw=kw)
        raise _Stop

    return stub


def _trainer_stub(store):
    """A trainer class whose construction records (flags, config) and stops."""

    class Stub:
        def __init__(self, flags, config, *a, **kw):
            store.update(flags=flags, cfg=config, tmp=flags.data_folder.rstrip("/"))
            raise _Stop

    return Stub


def _same_geometry(monkeypatch):
    """Both packages' make_synthetic_geom wrapped: their calls recorded, each
    building the same geometry with two rings."""
    from calodiffusion_tpu.utils import hgcal_utils as jh
    from calodiffusion_tpu_torch.utils import hgcal_utils as th

    calls = {}
    for side, mod in (("jax", jh), ("torch", th)):
        orig = mod.make_synthetic_geom

        def wrapped(*a, _orig=orig, _side=side, **kw):
            calls[_side] = (a, kw)
            return _orig(**dict(kw, nrings=2))

        monkeypatch.setattr(mod, "make_synthetic_geom", wrapped)
    return calls


def _assert_same_npz(path_a, path_b, rows=None):
    with np.load(path_a) as a, np.load(path_b) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            x, y = (a[k], b[k]) if rows is None else (a[k][:rows], b[k][:rows])
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes(), k


def _loader_cache(h5_path, cfg):
    """The npz cache the port's loader writes for one h5 file."""
    from calodiffusion_tpu_torch.data import loader
    from calodiffusion_tpu_torch.utils.config import default_flags

    embed = None
    if cfg.get("HGCAL"):
        from calodiffusion_tpu_torch.utils import hgcal_utils

        embed = hgcal_utils.make_pre_embed_converter(cfg, device="cpu")
    path, _ = loader._preprocess_one(str(h5_path), dict(cfg), default_flags(), -1, 0,
                                     NN_embed=embed, device="cpu")
    return path


FAMILY_CALLS = {  # (JAX call, port call, train file, eval file, argv of both)
    "hgcal": (lambda j: j.hgcal_family(25), lambda o: tfam.hgcal_family(25, o),
              "hgcal_1.h5", "hgcal_2.h5", []),
    "ds1": (lambda j: j.ds1_family(100), lambda o: tfam.ds1_family(100, o),
            "dataset_1_photons_1.hdf5", "dataset_1_photons_2.hdf5", []),
    "ds1pion": (lambda j: j.ds1_family(100, particle="pion"),
                lambda o: tfam.ds1_family(100, o, particle="pion"),
                "dataset_1_pions_1.hdf5", "dataset_1_pions_2.hdf5", []),
    "ds3": (lambda j: j.ds3_family(100), lambda o: tfam.ds3_family(100, o),
            "dataset_3_1.hdf5", "dataset_3_2.hdf5", ["--events", "64"]),
    "layer": (lambda j: j.layer_family(200), lambda o: tfam.layer_family(200, o),
              "dataset_2_1.hdf5", "dataset_2_2.hdf5", ["--events", "64"]),
}


@pytest.mark.parametrize("family", list(FAMILY_CALLS))
def test_family_data_and_config_match_jax(family, jfam, tmp_path, monkeypatch):
    """The JAX family function's h5 files and config against the port's
    caches, raw eval showers and config."""
    import calodiffusion_tpu.train.trainer as jtrainer
    import calodiffusion_tpu_torch.train.trainer as ttrainer

    jcall, tcall, f_train, f_eval, argv = FAMILY_CALLS[family]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    calls = _same_geometry(monkeypatch)
    got_j, got_t = {}, {}
    monkeypatch.setattr(jfam, "run_family", _capture(got_j))
    monkeypatch.setattr(tfam, "run_family", _capture(got_t))
    monkeypatch.setattr(jtrainer, "TrainDiffusion", _trainer_stub(got_j))
    monkeypatch.setattr(ttrainer, "TrainDiffusion", _trainer_stub(got_t))
    monkeypatch.setattr(jfam.tempfile, "mkdtemp", lambda **kw: str(jdir))
    monkeypatch.setattr(sys, "argv", ["tpu_fidelity_families.py", *argv]
                        + (["--workdir", str(jdir)] if family == "ds3" else []))
    with pytest.raises(_Stop):
        jcall(jfam)
    opts = tfam.parse([family, "--device", "cpu", "--workdir", str(tdir), *argv])
    with pytest.raises(_Stop):
        tcall(opts)
    if family == "hgcal":
        assert calls["jax"] == calls["torch"]

    jcfg, tcfg = dict(got_j["cfg"]), dict(got_t["cfg"])
    assert Path(jcfg.pop("BIN_FILE") or "x").name == Path(tcfg.pop("BIN_FILE") or "x").name
    assert tcfg == jcfg
    if "eval_file" in got_j:  # run_family's own arguments
        assert {k: got_t[k] for k in ("eval_file", "energy_key", "kw")} == \
               {k: got_j[k] for k in ("eval_file", "energy_key", "kw")}
    tfolder = Path(got_t["tmp"])
    assert tfolder == tdir / family

    # the port's raw eval showers: the JAX eval file, bit for bit
    rows = 64 if family == "ds3" else None
    with h5py.File(jdir / f_eval, "r") as f, np.load(tfolder / f"{f_eval}.raw.npz") as t:
        ekey = "gen_info" if family == "hgcal" else "incident_energies"
        assert t["energies"].tobytes() == f[ekey][:].tobytes()
        assert t["showers"][:rows].tobytes() == f["showers"][:rows].tobytes()
    # every cache: the port loader's from the JAX h5 file, bit for bit
    tcfg = dict(got_t["cfg"])
    _assert_same_npz(_loader_cache(jdir / f_train, tcfg), tfolder / f"{f_train}.npz")
    if rows is None:
        _assert_same_npz(_loader_cache(jdir / f_eval, tcfg), tfolder / f"{f_eval}.npz")
    else:  # ds3's eval cache on its first rows
        import chip_smoke

        with h5py.File(jdir / f_eval, "r") as f:
            chip_smoke.write_cache(tmp_path / "slice.npz", f["showers"][:rows],
                                   f["incident_energies"][:rows], tcfg)
        _assert_same_npz(tmp_path / "slice.npz", tfolder / f"{f_eval}.npz", rows=rows)


def test_family_constants_match_jax(jfam):
    assert tfam.SPARSITY_QUANTILE == jfam.SPARSITY_QUANTILE
    assert tfam.DS1_GEOMS == jfam.DS1_GEOMS
    from tests.utils_test import tiny_ds2_config

    assert tfam.tiny_ds2_config() == tiny_ds2_config()
    assert tfam.stage1_epochs(200, 32768, tfam.parse(["layer"])) == 400
    assert tfam.stage1_epochs(200, 8192, tfam.parse(["layer"])) == 400
    assert tfam.stage1_epochs(300, 32768, tfam.parse(["layer"])) == 600


def _features(n, nlayers, per_layer, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.exponential(1.0 + shift, (n, nlayers * per_layer)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.4] = 0
    return x, rng.uniform(10.0, 100.0, (n, 1)).astype(np.float32)


@pytest.mark.parametrize("nlayers,occupancy", [(5, True), (None, False)])
def test_separations_match_jax(jfam, monkeypatch, nlayers, occupancy):
    """The histogram terms and the FPD bit for bit; the classifier's AUC
    and JSD within 1e-3 from JAX's initial weights."""
    from calodiffusion_tpu_torch.evaluation import classifier as tcls
    from calodiffusion_tpu_torch.tools.jax_import import dnn_params_to_state_dict
    from tests.test_torch_port_evaluation import _dnn_init

    ref, ref_e = _features(300, 5, 12, 1)
    gen, gen_e = _features(300, 5, 12, 2, shift=0.2)
    orig = tcls.classifier_metrics

    def from_jax_init(real, g, **kw):
        kw.update(init_state=dnn_params_to_state_dict(_dnn_init(real.shape[1], 0)), device="cpu")
        return orig(real, g, **kw)

    monkeypatch.setattr(tcls, "classifier_metrics", from_jax_init)
    want = jfam.separations(ref, ref_e, gen, gen_e, nlayers, include_occupancy=occupancy)
    got = tfam.separations(ref, ref_e, gen, gen_e, nlayers, include_occupancy=occupancy,
                           device="cpu")
    assert list(got) == list(want)
    for k in ("Etot", "ERatio", "layer_profile_L1", "fpd", "fpd_err"):
        if k in want:
            assert got[k] == want[k], k
    for k in ("classifier_auc", "classifier_jsd"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])


SEPS = {
    "pass": {"Etot": 0.01, "ERatio": 0.02, "layer_profile_L1": 0.3, "classifier_auc": 0.6,
             "fpd": 0.5},
    "auc": {"Etot": 0.01, "ERatio": 0.02, "classifier_auc": 0.71, "fpd": 0.5,
            "int8_Etot": 0.01, "int8_ERatio": 0.01, "int8_classifier_auc": 0.5, "int8_fpd": 2.0},
    "hist": {"Etot": 0.1, "ERatio": 0.0, "int8_Etot": 0.0, "int8_ERatio": 0.05},
    "fpd": {"Etot": 0.0, "ERatio": 0.0, "classifier_auc": 0.7, "fpd": 1.01},
}


@pytest.mark.parametrize("case", list(SEPS))
def test_family_report_matches_jax(case, jfam, tmp_path, monkeypatch):
    """The JAX main's report rules on the same separations: a rerun
    supersedes the family's whole entry (stale int8/oracle keys go), the ds2
    key layer_profile_L1 and other families' keys stay, and the gates."""
    import calodiffusion_tpu.utils.jax_setup as jax_setup

    stale = {"hgcal_oracle_Etot": 1.0, "hgcal_int8_ok": False, "layer_profile_L1": 0.2,
             "ds1_classifier_auc": 0.9, "epochs": 80}
    seps = SEPS[case]
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    for p in (jpath, tpath):
        p.write_text(json.dumps(stale))
    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jfam, "REPORT", str(jpath))
    monkeypatch.setattr(jfam, "hgcal_family", lambda e: dict(seps))
    monkeypatch.setattr(sys, "argv", ["tpu_fidelity_families.py", "3", "hgcal"])
    jfam.main()
    monkeypatch.setitem(tfam.RUNNERS, "hgcal", lambda e, o: (dict(seps), {"train_s": 1.0}))
    tfam.main(["3", "hgcal", "--device", "cpu", "--out", str(tpath)])
    want, got = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    extra = {"hgcal_train_s": 1.0, "hgcal_epochs": 3, "hgcal_seed": 1234, "hgcal_card": "CPU"}
    assert {k: v for k, v in got.items() if k not in extra and k != "hgcal_wall_s"} == want
    assert {k: got[k] for k in extra} == extra
    for pfx in ("", "int8_"):
        if f"{pfx}Etot" in seps:
            assert tfam.gate(seps, pfx) == want[f"hgcal_{pfx}ok"]


def _showers(n, seed):
    """(n, 28 x 45 x 2) showers and incident energies: every family's layer
    axis divides the voxels."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(1.0, (n, 28 * 45 * 2)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.4] = 0
    return x, rng.uniform(10.0, 100.0, n).astype(np.float32)


@pytest.mark.parametrize("family", ["hgcal", "ds1pion", "ds3"])
def test_expected_keys_are_what_the_family_scores(family, tmp_path, monkeypatch):
    """``expected_keys`` (which chip_smoke.py's phase 18 checks) names what
    the family function scores, every flag on: run_family stubbed to return
    small arrays for each run, the sharp instruments stubbed."""
    from calodiffusion_tpu_torch.evaluation import evaluate

    _same_geometry(monkeypatch)
    ref, ref_e = _showers(24, 1)
    gen, gen_e = _showers(24, 2)
    monkeypatch.setattr(tfam, "run_family", lambda *a, **kw: (
        ref, ref_e, gen, gen_e, gen * 1.1, gen * 0.9, {"train_s": 1.0}))
    monkeypatch.setattr(evaluate, "fidelity_metrics", lambda *a, **kw: {
        "classifier_auc": 0.5, "classifier_jsd": 0.0, "fpd": 0.1, "fpd_err": 0.01})
    opts = tfam.parse([family, "--int8", "--roundtrip", "--oracle", "--device", "cpu",
                       "--events", "16", "--eval-events", "8", "--workdir", str(tmp_path)])
    seps, _ = tfam.RUNNERS[family](1, opts)
    assert sorted(seps) == sorted(tfam.expected_keys(family, opts))


def test_metrics_survive_only_a_singular_covariance(monkeypatch, capsys):
    """``separations`` and ``compute_seps`` go on without the sharp
    instruments where the FPD fails (FDPCalculationError, one line in
    METRIC_FAILURES); any other failure ends the run."""
    import torch_fidelity_check as tfc

    from calodiffusion_tpu_torch.evaluation import evaluate

    ref, ref_e = _showers(24, 1)
    gen, gen_e = _showers(24, 2)
    cfg = {"SHAPE_FINAL": [-1, 1, 45, 16, 9]}
    # dataset 2's 6480 voxels, without the plot suite
    ref2, gen2 = (np.tile(x, 3)[:, :6480] for x in (ref, gen))
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def singular(*a, **kw):
        raise evaluate.FDPCalculationError("singular matrix")

    monkeypatch.setattr(evaluate, "fidelity_metrics", singular)
    before = len(tfam.METRIC_FAILURES)
    seps = tfam.separations(ref, ref_e, gen, gen_e, 45, device="cpu")
    assert sorted(seps) == ["ERatio", "Etot", "layer_profile_L1"]
    assert tfam.METRIC_FAILURES[before:] == ["classifier/FPD metrics failed: singular matrix"]
    ds2 = tfc.compute_seps(ref2, ref_e[:, None], gen2, gen_e[:, None], cfg, "cpu")
    assert "classifier/FPD metrics failed: singular matrix" in capsys.readouterr().out
    assert "classifier_auc" not in ds2 and "fpd" not in ds2

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(evaluate, "fidelity_metrics", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tfam.separations(ref, ref_e, gen, gen_e, 45, device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tfc.compute_seps(ref2, ref_e[:, None], gen2, gen_e[:, None], cfg, "cpu")
    assert len(tfam.METRIC_FAILURES) == before + 1


def test_parse_and_refusals(tmp_path):
    opts = tfam.parse(["150", "ds1", "layer", "--seed=7", "--events", "99", "--int8"])
    assert (opts.epochs, opts.families, opts.seed, opts.events, opts.int8) == (
        150, ["ds1", "layer"], 7, 99, True)
    assert tfam.parse([]).families == ["hgcal", "ds1"] and tfam.parse([]).epochs is None
    with pytest.raises(SystemExit, match="unknown families"):
        tfam.parse(["ds9"])
    with pytest.raises(SystemExit, match="JAX package's report"):
        tfam.parse(["--out", str(ROOT / "fidelity_report.json")])
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(SystemExit, match="no CUDA card"):
            tfam.main(["1", "ds1", "--out", str(tmp_path / "r.json")])
        with pytest.raises(SystemExit, match="no CUDA card"):
            tfs.main(["1", "--out", str(tmp_path / "r.json")])
        with pytest.raises(SystemExit, match="no CUDA card"):
            tcs.main(["--out", str(tmp_path / "r.json")])


# ---------------------------------------------------------------------------
# the few-step harness
# ---------------------------------------------------------------------------

def test_fewstep_tables_match_jax(jfs):
    assert tfs.CANDIDATES == jfs.CANDIDATES
    assert tfs.EDM_CANDIDATES == jfs.EDM_CANDIDATES
    assert [tfs.norm_cand(c) for c in tfs.CANDIDATES + tfs.EDM_CANDIDATES] == \
           [jfs.norm_cand(c) for c in jfs.CANDIDATES + jfs.EDM_CANDIDATES]
    for name in ("THRESH", "AUC_MAX", "FPD_MAX", "REL_AUC_DELTA", "REL_FPD_DELTA"):
        assert getattr(tfs, name) == getattr(jfs, name), name
    # the families' and the seeds' gates share them
    assert (tfam.AUC_MAX, tfam.FPD_MAX, tfam.THRESH) == (tcs.AUC_MAX, tcs.FPD_MAX, tfs.THRESH)
    assert [norm for norm in (tfs.norm_cand(c)[2] for c in tfs.mode_candidates("int8"))] == \
           [jfs.norm_cand(c)[2] for c in jfs.CANDIDATES]
    for widths in ([32, 32, 64, 32], [16, 16, 32, 32, 64]):
        assert tfs.int8_fence({"LAYER_SIZE_UNET": widths}) == \
               jfs.int8_fence({"LAYER_SIZE_UNET": widths})


def _seps(auc, fpd, hist=0.0):
    return {"Etot": hist, "ERatio": 0.0, "layer_profile_L1": 0.0, "classifier_auc": auc,
            "fpd": fpd}


GATE_CASES = [  # (candidate, baseline, ok, rel_ok)
    (_seps(0.55, 0.2), _seps(0.5, 0.1), True, True),
    (_seps(0.71, 0.2), _seps(0.69, 0.1), False, True),
    (_seps(0.60, 0.9), _seps(0.5, 0.6), True, False),
    (_seps(0.60, 0.2, hist=0.1), _seps(0.5, 0.1), False, False),
    (_seps(0.94, 4.9), _seps(0.95, 5.0), False, True),
    ({"Etot": 0.0, "ERatio": 0.0, "layer_profile_L1": 0.0}, _seps(0.5, 0.1), False, False),
    (_seps(0.55, 0.2), None, True, False),
]


@pytest.mark.parametrize("case", range(len(GATE_CASES)))
def test_fewstep_gates(case):
    """The JAX script's absolute and relative gates (its eval_candidates,
    :320-339): a missing sharp metric passes neither, the relative one needs
    a baseline."""
    seps, base, ok, rel_ok = GATE_CASES[case]
    assert tfs.gates(seps, base) == (ok, rel_ok)


STALE = {
    "fewstep_Consistency_1_ok": False,
    "fewstep_DDim_50_ok": False,
    "fewstep_best": None,
    "fewstep_int8_DDim_50_ok": True,
    "fewstep_int8_fenced": True,
    "layer_ok": False,
}
REPORT_CASES = {
    # tests/test_fewstep_report.py's three scenarios, and their int8 twins
    "supersede": ({"DDim_400": {"seps": _seps(0.5, 0.1), "ok": True, "rel_ok": False},
                   "DDim_50": {"seps": _seps(0.55, 0.2), "ok": True, "rel_ok": True},
                   "DPMPP2M_18": {"seps": _seps(0.95, 2.0), "ok": False, "rel_ok": False}},
                  {"DDim_50": 250.0, "DPMPP2M_18": 660.0}, _seps(0.5, 0.1)),
    "unconverged": ({"DDim_400": {"seps": _seps(0.95, 5.0), "ok": False, "rel_ok": False},
                     "DDim_50": {"seps": _seps(0.94, 4.9), "ok": False, "rel_ok": True}},
                    {"DDim_50": 250.0}, _seps(0.95, 5.0)),
    "none": ({"DDim_400": {"seps": _seps(0.95, 5.0), "ok": False, "rel_ok": False},
              "DDim_50": {"seps": _seps(0.99, 9.0), "ok": False, "rel_ok": False}},
             {"DDim_50": 250.0}, _seps(0.95, 5.0)),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", list(REPORT_CASES))
def test_fewstep_write_report_matches_jax(case, int8, jfs, tmp_path, monkeypatch, capsys):
    """The port's write_report on tests/test_fewstep_report.py's scenarios:
    the same report as the JAX script's, key for key, from the same stale
    report (its prefix superseded, the other prefix and the other keys
    kept), and the same warning for an unconverged teacher."""
    results, speeds, baseline = REPORT_CASES[case]
    for r in results.values():
        r["gen_s"] = 1.0
    jpath, tpath = tmp_path / "jax.json", tmp_path / "torch.json"
    for p in (jpath, tpath):
        p.write_text(json.dumps(STALE))
    monkeypatch.setattr(jfs, "REPORT", str(jpath))
    jfs.write_report(results, speeds, baseline, int8=int8)
    jout = capsys.readouterr().out
    tfs.write_report(results, speeds, baseline, int8=int8, out=tpath)
    tout = capsys.readouterr().out
    want, got = json.loads(jpath.read_text()), json.loads(tpath.read_text())
    assert got == want
    assert ("teacher has not converged" in tout) == ("teacher has not converged" in jout)
    prefix = "fewstep_int8" if int8 else "fewstep"
    assert f"{prefix}_DDim_400_ok" not in got and got["layer_ok"] is False
    if case == "supersede":
        assert got[f"{prefix}_best"] == "DDim_50" and f"{prefix}_Consistency_1_ok" not in got
    if case == "none":
        assert got[f"{prefix}_best_showers_per_sec"] is None


@pytest.mark.parametrize("int8", [False, True])
def test_fewstep_report_keys(int8, tmp_path):
    """``report_keys`` (which chip_smoke.py's phase 18 checks) names what
    ``write_report`` writes: the candidates' separations as numbers, the
    verdicts as booleans."""
    results, speeds, baseline = REPORT_CASES["supersede"]
    report = tfs.write_report(results, speeds, baseline, int8=int8, out=tmp_path / "r.json")
    values, verdicts = tfs.report_keys("int8" if int8 else "bf16", ["DDim_50", "DPMPP2M_18"])
    assert all(isinstance(report[k], float) for k in values)
    assert all(isinstance(report[k], bool) for k in verdicts)
    prefix = tfs.PREFIX["int8" if int8 else "bf16"]
    written = {k for k in report if k.startswith(prefix + "_")
               and k.endswith(tfs.ROW_KEYS + ("_ok",)) and "baseline" not in k}
    assert written == set(values) | set(verdicts)


def test_fewstep_data_and_config_match_jax(jfs, tmp_path, monkeypatch):
    """The JAX few-step main's h5 files and teacher config against the
    port's caches, raw eval showers and config (--events 64)."""
    import calodiffusion_tpu.train.trainer as jtrainer
    import calodiffusion_tpu.utils.jax_setup as jax_setup
    import calodiffusion_tpu_torch.train.trainer as ttrainer

    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    got_j, got_t = {}, {}
    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jtrainer, "TrainDiffusion", _trainer_stub(got_j))
    monkeypatch.setattr(ttrainer, "TrainDiffusion", _trainer_stub(got_t))
    monkeypatch.setattr(sys, "argv", ["tpu_fewstep_check.py", "--events", "64",
                                      f"--workdir={jdir}", "--seed", "5"])
    with pytest.raises(_Stop):
        jfs.main()
    with pytest.raises(_Stop):
        tfs.main(["--events", "64", "--workdir", str(tdir), "--seed", "5", "--device", "cpu"])
    assert got_t["cfg"] == got_j["cfg"]
    assert (got_t["flags"].seed, got_t["flags"].load) == (got_j["flags"].seed,
                                                           got_j["flags"].load) == (5, True)
    with h5py.File(jdir / "dataset_2_2.hdf5", "r") as f, \
            np.load(tdir / "dataset_2_2.hdf5.raw.npz") as t:
        assert t["showers"].tobytes() == f["showers"][:].tobytes()
        assert t["energies"].tobytes() == f["incident_energies"][:].tobytes()
    for name in ("dataset_2_1.hdf5", "dataset_2_2.hdf5"):
        _assert_same_npz(_loader_cache(jdir / name, got_t["cfg"]), tdir / f"{name}.npz")
    # a changed setup in the workdir is refused
    with pytest.raises(SystemExit, match="use a fresh --workdir"):
        tfs.main(["--events", "64", "--workdir", str(tdir), "--seed", "6", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the cascade's seeds
# ---------------------------------------------------------------------------

ROWS = {
    "seed1234": {"classifier_auc": 0.6958, "fpd": 0.2157, "Etot": 0.0037},
    "seed1": {"classifier_auc": 0.71, "fpd": 0.25, "Etot": 0.004},
    "seed2": {"classifier_auc": 0.66, "fpd": 0.19, "Etot": 0.003},
}


@pytest.mark.parametrize("keep", [["seed1234"], ["seed1234", "seed1"], list(ROWS)])
def test_cascade_seeds_report_matches_jax(keep, jcs, tmp_path, monkeypatch):
    """Every seed already recorded: both scripts skip them all and report
    the same layer_seed_* (mean, t-based 95 % half-width; NaN below two
    rows) and layer_seeds_ok."""
    import calodiffusion_tpu.utils.jax_setup as jax_setup

    rows = {k: ROWS[k] for k in keep}
    jrows, trows = tmp_path / "jax_rows.json", tmp_path / "torch_cascade_seeds.json"
    jrep, trep = tmp_path / "jax.json", tmp_path / "torch.json"
    for p in (jrows, trows):
        p.write_text(json.dumps(rows))
    for p in (jrep, trep):
        p.write_text(json.dumps({"layer_ok": True}))
    seeds = ",".join(k.removeprefix("seed") for k in keep)
    monkeypatch.setattr(jax_setup, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(jcs, "OUT", str(jrows))
    monkeypatch.setattr(jcs, "REPORT", str(jrep))
    monkeypatch.setattr(sys, "argv", ["tpu_cascade_seeds.py", f"--seeds={seeds}"])
    with np.errstate(all="ignore"):
        jcs.main()
        tcs.main(["--seeds", seeds, "--out", str(trep), "--device", "cpu"])
    want, got = json.loads(jrep.read_text()), json.loads(trep.read_text())
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert json.loads(trows.read_text()) == rows


# ---------------------------------------------------------------------------
# end to end on the CPU, at tiny widths
# ---------------------------------------------------------------------------

def _tiny(monkeypatch):
    """Every harness config at widths [8, 8, 8, 8], cond 16."""
    base = tfam.tiny_ds2_config

    def tiny(**kw):
        return dict(base(**kw), LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16)

    monkeypatch.setattr(tfam, "tiny_ds2_config", tiny)
    monkeypatch.setattr(tfs, "tiny_ds2_config", tiny)


CUT = ["--events", "64", "--eval-events", "32", "--device", "cpu"]


def test_families_end_to_end_on_cpu(tmp_path, monkeypatch):
    """ds1 with --int8 --roundtrip --swa for one epoch, then resumed to two
    epochs without --int8: the report's ds1 entry is superseded (no int8
    keys left), every value of the first run finite, and the SWA state
    restored (the second epoch folds into the first's average: swa_n 2);
    resumed once more, nothing is left to train."""
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    _tiny(monkeypatch)
    out = tmp_path / "report.json"
    common = ["ds1", *CUT, "--sample-steps", "2", "--workdir", str(tmp_path / "w"),
              "--out", str(out), "--swa"]
    first = dict(tfam.main(["1", *common, "--int8", "--roundtrip"]))
    keys = [p + k for p in ("", "int8_", "ceiling_")
            for k in ("Etot", "ERatio", "classifier_auc", "classifier_jsd", "fpd", "fpd_err")]
    assert all(np.isfinite(first[f"ds1_{k}"]) for k in keys)
    assert sorted(tfam.expected_keys("ds1", tfam.parse(["ds1", "--int8", "--roundtrip"]))) == \
           sorted(keys)
    assert isinstance(first["ds1_ok"], bool) and isinstance(first["ds1_int8_ok"], bool)
    folder = tmp_path / "w" / "ds1" / "ckpt" / "fidelity_ds1_Diffusion"
    one, host = ckpt_io.load_checkpoint(str(folder), "checkpoint")
    assert host["epoch"] == 0 and host["swa_n"] == 1

    second = tfam.main(["2", *common, "--resume"])
    assert not any(k.startswith(("ds1_int8_", "ds1_ceiling_")) for k in second)
    assert json.loads(out.read_text()) == second
    two, host = ckpt_io.load_checkpoint(str(folder), "checkpoint")
    assert host["epoch"] == 1 and host["swa_n"] == 2
    assert sorted(int(e) for e in host["train_loss_hist"]) == [0, 1]
    for k, s1 in one["swa_params"].items():
        assert torch.equal(two["swa_params"][k], s1 + (two["params"][k] - s1) / 2), k

    mtime = (folder / "checkpoint.ckpt").stat().st_mtime_ns
    tfam.main(["2", *common, "--resume"])
    assert (folder / "checkpoint.ckpt").stat().st_mtime_ns == mtime


def test_cascade_seeds_end_to_end_on_cpu(tmp_path, monkeypatch):
    """Two seeds of the cascade (--oracle off, SWA on) at tiny widths: each
    row written, the interval over two rows finite; a rerun skips both."""
    _tiny(monkeypatch)
    argv = ["--seeds", "1,2", "--epochs", "1", "--stage1-epochs", "1", "--sample-steps", "2",
            *CUT, "--out", str(tmp_path / "report.json"), "--workdir", str(tmp_path / "w")]
    agg = tcs.main(argv)
    assert agg["layer_seed_n"] == 2 and isinstance(agg["layer_seeds_ok"], bool)
    assert all(np.isfinite(v) for k, v in agg.items() if k != "layer_seeds_ok")
    rows = json.loads((tmp_path / "torch_cascade_seeds.json").read_text())
    assert sorted(rows) == ["seed1", "seed2"]
    assert set(rows["seed1"]) - {"wall_s", "epochs", "events"} == set(
        tfam.expected_keys("layer", tfam.parse(["layer", "--swa"])))
    assert tcs.main(argv) == agg


def test_fewstep_end_to_end_on_cpu(tmp_path, monkeypatch):
    """The teacher, the baseline (cut to 4 steps), a candidate, then one
    distillation epoch and Consistency@1, at tiny widths; a candidate's
    speed measured where it passed a gate, and ``candidate_speed`` (which
    chip_smoke.py's phase 18 calls) on Consistency@1."""
    import tempfile

    _tiny(monkeypatch)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    # no plot suite, as on the card's machine (no matplotlib there)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(tfs, "BASELINE", ("DDim", 4))
    out = tmp_path / "report.json"
    results, speeds = tfs.main(["1", *CUT, "--out", str(out), "--candidates", "DPMPP2M_18",
                                "Consistency_1", "--distill", "1", "--workdir",
                                str(tmp_path / "w")])
    assert sorted(results["bf16"]) == ["Consistency_1", "DDim_4", "DPMPP2M_18"]
    for tag, r in results["bf16"].items():
        if tag != "DDim_4":
            assert (tag in speeds["bf16"]) == (r["ok"] or r["rel_ok"]), tag
    assert tfs.candidate_speed(tfs.fewstep_config(1), ("Consistency", 1), "bf16", "cpu") > 0
    report = json.loads(out.read_text())
    assert not any(k.startswith("fewstep_DDim_4_") for k in report)  # the baseline's row
    assert all(np.isfinite(report[f"fewstep_{t}_{k}"]) for t in ("DPMPP2M_18", "Consistency_1")
               for k in ("Etot", "ERatio", "layer_profile_L1"))
    assert isinstance(report["fewstep_teacher_ok"], bool)
    assert all((f"fewstep_{t}_showers_per_sec" in report) == (t in speeds["bf16"])
               for t in ("DPMPP2M_18", "Consistency_1"))
