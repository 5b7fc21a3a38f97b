"""calodiffusion_tpu_torch's evaluation (HighLevelFeatures, FPD, the
classifier metrics, CNNCompare) against the JAX package's on the CPU.

Inputs come from numpy seeds.  The numpy code is held bit for bit; the
port's isotonic fit to sklearn's within 1e-12; the DNN's and the
ComparisonNetwork's f32 forwards (weights from JAX's init through
``tools/jax_import``) and CNNCompare's score within 1e-5 relative; the
weights after training (the classifier 3 epochs, the CNN one epoch) within
1e-4 max abs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.evaluation import classifier as jcls
from calodiffusion_tpu.evaluation import evaluate as jev
from calodiffusion_tpu.evaluation import frechet as jfr
from calodiffusion_tpu.evaluation.hlf import HighLevelFeatures as JHLF
from calodiffusion_tpu.utils.config import dotdict
from calodiffusion_tpu_torch.evaluation import classifier as tcls
from calodiffusion_tpu_torch.evaluation import evaluate as tev
from calodiffusion_tpu_torch.evaluation import frechet as tfr
from calodiffusion_tpu_torch.evaluation.hlf import HighLevelFeatures as THLF
from calodiffusion_tpu_torch.tools.jax_import import (comparison_params_to_state_dict,
                                                      dnn_params_to_state_dict)
from chip_smoke import DS2_PARTICLE, ds2_binning_xml
from tests.test_evaluation import BINNING_XML

FWD_RTOL = 1e-5
TRAINED_ATOL = 1e-4
ISOTONIC_TOL = 1e-12
# CNNCompare's data shapes by dataset
CNN_SHAPES = {2: (45, 16, 9), 3: (45, 50, 18)}


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


@pytest.fixture(scope="module")
def binnings(tmp_path_factory):
    d = tmp_path_factory.mktemp("xml")
    (d / "toy.xml").write_text(BINNING_XML)
    (d / "ds2.xml").write_text(ds2_binning_xml())
    return {"toy": (str(d / "toy.xml"), "photon", 73), "ds2": (str(d / "ds2.xml"),
                                                                DS2_PARTICLE, 6480)}


def _showers(n, voxels, seed):
    rng = np.random.default_rng(seed)
    x = rng.exponential(1.0, (n, voxels)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.7] = 0
    return x, rng.uniform(1e3, 1e6, (n, 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# numpy: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["toy", "ds2"])
def test_hlf_features_match_jax(binnings, name):
    path, part, voxels = binnings[name]
    data, energies = _showers(40, voxels, 1)
    j, t = JHLF(part, path), THLF(part, path)
    j.CalculateFeatures(data)
    t.CalculateFeatures(data)
    np.testing.assert_array_equal(t.GetEtot(), j.GetEtot())
    for getter in ("GetElayers", "GetECEtas", "GetECPhis", "GetWidthEtas", "GetWidthPhis"):
        jd, td = getattr(j, getter)(), getattr(t, getter)()
        assert list(td) == list(jd), getter
        for k in jd:
            np.testing.assert_array_equal(td[k], jd[k])
    np.testing.assert_array_equal(t.feature_matrix(energies), j.feature_matrix(energies))


def test_hist_max_e_feeds_the_jax_histogram(tmp_path):
    """HistMaxE (JAX evaluation/plots.py:523-533): the histogram input (each
    shower's max voxel over its sum, 0 for an empty shower), its binning
    and its label equal the JAX class's on the same showers, with the
    figure drawn neither side."""
    from types import SimpleNamespace

    from calodiffusion_tpu.evaluation import plots as jplots
    from calodiffusion_tpu_torch.evaluation import plots as tplots

    x, E = _showers(12, 6480, seed=7)
    x[3] = 0  # an empty shower: the masked division's 0
    data = {"Geant4": x, "CaloDiffusion": np.flip(x, 0).copy()}
    cfg = {"SHAPE_FINAL": [-1, 1, 45, 16, 9], "SHAPE_PAD": [-1, 1, 45, 16, 9],
           "CHECKPOINT_NAME": "hist"}
    flags = SimpleNamespace(plot_folder=str(tmp_path), generated="gen.h5")
    fed = {}
    for name, mod in (("jax", jplots), ("port", tplots)):
        plot = mod.HistMaxE(flags, dict(cfg))

        def hist(feed_dict, name=name, **kw):
            fed[name] = (feed_dict, kw)
            return None, None

        plot._hist, plot.save_fig = hist, lambda *a: None
        plot(data, E)
    (want, want_kw), (got, got_kw) = fed["jax"], fed["port"]
    assert set(got) == set(want) == set(data)
    for key in data:
        assert got[key].dtype == want[key].dtype and got[key].tobytes() == want[key].tobytes()
    assert want["Geant4"][3] == 0 and (want["Geant4"] > 0).sum() == 11
    np.testing.assert_array_equal(got_kw.pop("binning"), want_kw.pop("binning"))
    assert got_kw == want_kw == {"xlabel": "Max. voxel/Dep. energy"}


def test_frechet_matches_jax():
    rng = np.random.default_rng(2)
    real = rng.normal(0, 1, (600, 6))
    gen = rng.normal(0.2, 1.1, (500, 6))
    assert tfr.fpd(real, gen) == jfr.fpd(real, gen)
    kw = dict(min_samples=200, max_samples=400, num_batches=3, num_points=4)
    assert tfr.fpd_jetnet(real, gen, **kw) == jfr.fpd_jetnet(real, gen, **kw)
    for got, want in zip(tfr.normalise_features(real, gen), jfr.normalise_features(real, gen)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfr.normalise_features(real), jfr.normalise_features(real))


# the HGCal fidelity harness's --energy-min (scripts/torch_fidelity_families.py
# hgcal): its readout threshold, the 0.45 quantile of the 6144 train showers'
# cells (2.0392e-4 raw, tests/torch_hgcal_split.py draws it), x SHOWERSCALE 200
HGCAL_EMIN = 200 * 2.0392441962478197e-4
MASK_CASES = ("mixed", "layer_all_under", "layer_one_left", "negative", "layer_empty")


def _mask_input(case):
    """(3, 28, 50) generated cells around HGCAL_EMIN; ``case`` sets layer 24
    of event 0 (and 25 of event 1) to its edge."""
    rng = np.random.default_rng(MASK_CASES.index(case))
    x = (HGCAL_EMIN * rng.exponential(1.5, (3, 28, 50))).astype(np.float32)
    if case == "layer_all_under":  # every voxel just under: the layer masked away
        x[0, 24] = HGCAL_EMIN * rng.uniform(0.5, 0.999, 50)
        x[1, 25] = HGCAL_EMIN * 0.999
    elif case == "layer_one_left":  # one voxel over: it takes the layer's energy
        x[0, 24] = HGCAL_EMIN * rng.uniform(0.5, 0.999, 50)
        x[0, 24, 7] = 1.5 * HGCAL_EMIN
        x[1, 25] = 0.0
        x[1, 25, 3] = 1.01 * HGCAL_EMIN
    elif case == "negative":  # negative voxels: zeroed, their energy not conserved
        x[0, 24] = HGCAL_EMIN * rng.normal(0.0, 2.0, 50)
        x[1] -= HGCAL_EMIN
    elif case == "layer_empty":  # a layer with nothing: stays 0, no NaN
        x[0, 24] = 0.0
    return x


@pytest.mark.parametrize("case", MASK_CASES)
def test_apply_mask_conserve_e_matches_jax(case):
    """``apply_mask_conserveE`` at the HGCal harness's threshold, bit for
    bit against the JAX package's (port evaluation/metrics_utils.py:44, JAX
    :41), with the edges HGCal's deep layers turn on."""
    from calodiffusion_tpu.evaluation import metrics_utils as jmu
    from calodiffusion_tpu_torch.evaluation import metrics_utils as tmu

    x = _mask_input(case)
    got = tmu.apply_mask_conserveE(x.copy(), x < HGCAL_EMIN)
    want = jmu.apply_mask_conserveE(x.copy(), x < HGCAL_EMIN)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.isfinite(got).all() and (got >= 0).all()
    assert ((got == 0) | (got >= HGCAL_EMIN)).all()
    kept = np.maximum(x, 0).sum(-1)  # a layer keeps its energy where a voxel is left
    left = (x >= HGCAL_EMIN).any(-1)
    np.testing.assert_allclose(got.sum(-1)[left], kept[left], rtol=1e-5)
    assert (got.sum(-1)[~left] == 0).all()
    if case == "layer_all_under":
        assert not got[0, 24].any() and not got[1, 25].any()
    elif case == "layer_one_left":
        assert np.count_nonzero(got[0, 24]) == 1
        assert got[0, 24, 7] == pytest.approx(kept[0, 24], rel=1e-5)
        assert np.count_nonzero(got[1, 25]) == 1 and got[1, 25, 3] == x[1, 25, 3]


@pytest.mark.parametrize("nlayers,occupancy", [(45, True), (45, False), (None, True)])
def test_shower_features_and_aucs_match_jax(nlayers, occupancy):
    ref, ref_e = _showers(160, 6480, 3)
    gen, gen_e = _showers(150, 6480, 4)
    f_ref = tev.shower_feature_matrix(ref, ref_e, nlayers, occupancy)
    f_gen = tev.shower_feature_matrix(gen, gen_e, nlayers, occupancy)
    np.testing.assert_array_equal(f_ref, jev.shower_feature_matrix(ref, ref_e, nlayers,
                                                                   occupancy))
    np.testing.assert_array_equal(f_gen, jev.shower_feature_matrix(gen, gen_e, nlayers,
                                                                   occupancy))
    assert tev.feature_names(f_ref.shape[1], occupancy) == jev.feature_names(f_ref.shape[1],
                                                                             occupancy)
    np.testing.assert_array_equal(tev.per_feature_auc(f_ref, f_gen),
                                  jev.per_feature_auc(f_ref, f_gen))
    le_r, le_g = np.log10(ref_e), np.log10(gen_e)
    np.testing.assert_array_equal(
        tev.per_feature_auc(f_ref, f_gen, cond_ref=le_r, cond_gen=le_g),
        jev.per_feature_auc(f_ref, f_gen, cond_ref=le_r, cond_gen=le_g))


def test_auc_score_matches_jax():
    rng = np.random.default_rng(5)
    y = (rng.uniform(size=300) < 0.4).astype(np.float32)
    p = np.round(rng.uniform(size=300), 2).astype(np.float32)  # ties
    assert tcls.auc_score(y, p) == jcls.auc_score(y, p)
    assert tcls.auc_score(np.ones(4), p[:4]) == jcls.auc_score(np.ones(4), p[:4]) == 0.5


# ---------------------------------------------------------------------------
# the isotonic calibration: sklearn's semantics without sklearn
# ---------------------------------------------------------------------------

def _isotonic_cases():
    rng = np.random.default_rng(6)
    labels = (rng.uniform(size=500) < 0.5).astype(np.float64)
    p = rng.uniform(size=500)
    tied = np.round(p, 2)  # exact ties
    near = p.astype(np.float32)
    near[::7] = near[1::7][: len(near[::7])] + np.float32(3e-7)  # within float32's 1e-6
    noisy = np.sin(6 * p) + rng.normal(0, 0.3, 500)
    return {
        "labels f64": (p, labels),
        "labels f32": (p.astype(np.float32), labels.astype(np.float32)),
        "exact ties": (tied, labels),
        "near ties f32": (near, labels.astype(np.float32)),
        "values f64": (p, noisy),
        "one x": (np.full(10, 0.3), labels[:10]),
    }


@pytest.mark.parametrize("case", list(_isotonic_cases()))
@pytest.mark.parametrize("bounds", [(1e-7, 1 - 1e-7), (-np.inf, np.inf)])
def test_isotonic_fit_matches_sklearn(case, bounds):
    from sklearn.isotonic import IsotonicRegression

    x, y = _isotonic_cases()[case]
    want = IsotonicRegression(out_of_bounds="clip", y_min=bounds[0],
                              y_max=bounds[1]).fit_transform(x, y)
    got = tcls.isotonic_fit_transform(x, y, y_min=bounds[0], y_max=bounds[1])
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=ISOTONIC_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jsd_from_probs_matches_jax_with_sklearn(dtype):
    import sklearn  # noqa: F401  (the JAX package calibrates only where it is installed)

    rng = np.random.default_rng(7)
    y = (rng.uniform(size=400) < 0.5).astype(dtype)
    p = np.clip(0.5 + 0.3 * (y - 0.5) + rng.normal(0, 0.2, 400), 0, 1).astype(dtype)
    for calibrated in (True, False):
        assert abs(tcls.jsd_from_probs(y, p, calibrated)
                   - jcls.jsd_from_probs(y, p, calibrated)) <= ISOTONIC_TOL


# ---------------------------------------------------------------------------
# the networks: JAX's init through tools/jax_import
# ---------------------------------------------------------------------------

def _dnn_init(n_in, seed):
    _, k = jax.random.split(jax.random.PRNGKey(seed))
    return jcls.DNN().init(k, jnp.zeros((1, n_in)))


def _max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_dnn_forward_matches_jax():
    params = _dnn_init(12, 0)
    x = np.random.default_rng(8).normal(size=(64, 12)).astype(np.float32)
    want = np.asarray(jcls.DNN().apply(params, jnp.asarray(x)))
    model = tcls.DNN(12)
    model.load_state_dict(dnn_params_to_state_dict(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert _max_rel(got, want) <= FWD_RTOL


def _cnn_init(shape, seed=0):
    return jev.ComparisonNetwork().init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape)),
                                        jnp.zeros((1, 1)))


def _cnn_inputs(shape, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, *shape)).astype(np.float32),
            rng.uniform(size=(n, 1)).astype(np.float32))


@pytest.mark.parametrize("num", sorted(CNN_SHAPES))
def test_comparison_network_forward_matches_jax(num):
    """flax's SAME padding ((0, 1) at stride 2 on an even size), GroupNorm's
    epsilon 1e-6 and the channels-last flatten all show in the logits."""
    shape = CNN_SHAPES[num]
    params = _cnn_init(shape)
    x, E = _cnn_inputs(shape, 3, 9)
    want = np.asarray(jev.ComparisonNetwork().apply(params, jnp.asarray(x), jnp.asarray(E)))
    net = tev.ComparisonNetwork(shape)
    net.load_state_dict(comparison_params_to_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(E)).numpy()
    assert _max_rel(got, want) <= FWD_RTOL


@pytest.mark.parametrize("n,stride,pads", [(16, 2, (0, 1)), (9, 2, (1, 1)), (50, 2, (0, 1)),
                                           (18, 2, (0, 1)), (5, 2, (1, 1)), (9, 1, (1, 1))])
def test_same_pads_are_flax_pads(n, stride, pads):
    from jax import lax

    assert tev.same_pads(n, stride) == pads
    assert tuple(lax.padtype_to_pads((n,), (3,), (stride,), "SAME")[0]) == pads


def test_train_classifier_matches_jax():
    rng = np.random.default_rng(10)
    real = rng.normal(0, 1, (600, 10)).astype(np.float32)
    gen = rng.normal(0.3, 1.2, (600, 10)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, jparams, (jX_val, jy_val, *_) = jcls.train_classifier(real, gen, key=key, epochs=3)
    apply_fn, state, (X_val, y_val, *_) = tcls.train_classifier(
        real, gen, epochs=3, device="cpu", init_state=dnn_params_to_state_dict(_dnn_init(10, 3)))
    np.testing.assert_array_equal(X_val, jX_val)
    np.testing.assert_array_equal(y_val, jy_val)
    want = dnn_params_to_state_dict(jparams)
    assert set(state) == set(want)
    for k in want:
        err = float((state[k] - want[k]).abs().max())
        assert err <= TRAINED_ATOL, (k, err)


# ---------------------------------------------------------------------------
# CNNCompare, with stub models that sample fixed showers
# ---------------------------------------------------------------------------

class _JaxStub:
    """The JAX model's ``sample``: fixed showers a call."""

    def __init__(self, batches):
        self.batches, self.calls = batches, 0

    def sample(self, params, key, E, layers=None, num_steps=400, sample_offset=0):
        out = self.batches[self.calls % len(self.batches)]
        self.calls += 1
        return out


class _TorchStub:
    device = torch.device("cpu")

    def __init__(self, batches):
        self.batches, self.calls = batches, 0

    def sample(self, E, layers=None, num_steps=400, generator=None, sample_offset=0):
        out = torch.from_numpy(self.batches[self.calls % len(self.batches)])
        self.calls += 1
        return out


def _cnn_setup(tmp_path, retrain=False):
    shape = CNN_SHAPES[2]
    rng = np.random.default_rng(11)
    batches = [rng.normal(size=(8, 1, *shape)).astype(np.float32) for _ in range(2)]
    data = [(rng.uniform(size=(8, 1)).astype(np.float32),
             rng.normal(size=(8, 46)).astype(np.float32),
             rng.normal(size=(8, 1, *shape)).astype(np.float32)) for _ in range(2)]
    flags = dotdict(results_folder=str(tmp_path))
    config = {"DATASET_NUM": 2, "NSTEPS": 3, "EVAL_NETWORK": "eval_cnn",
              "RETRAIN_EVAL_NETWORK": retrain, "flags": flags}
    params = _cnn_init(shape)
    torch.save(comparison_params_to_state_dict(params), tmp_path / "eval_cnn.pt")
    return batches, data, flags, config, params


def test_cnn_compare_score_matches_jax(tmp_path, capsys):
    batches, data, flags, config, params = _cnn_setup(tmp_path)
    j = jev.CNNCompare(_JaxStub(batches), config, flags)  # no .npz: flax's init, key 0
    assert "Cannot find weights at path" in capsys.readouterr().out
    j.cnn_params = params
    t = tev.CNNCompare(_TorchStub(batches), config, flags)
    want, got = j(data), t(data)
    assert got <= 0 and abs(got - want) <= FWD_RTOL * abs(want)


def test_cnn_compare_unknown_dataset_raises(tmp_path):
    with pytest.raises(ValueError, match="can be evaluated with CNNCompare"):
        tev.CNNCompare(_TorchStub([]), {"DATASET_NUM": 1}, dotdict(results_folder=str(tmp_path)))


def test_cnn_compare_train_network_matches_jax(tmp_path, monkeypatch):
    """One epoch of AdamW (weight decay 1e-4, as optax.adamw) from the JAX
    init: each package's loader yields the batches once, so its later
    epochs take no step."""
    from calodiffusion_tpu.data import loader as jloader
    from calodiffusion_tpu_torch.data import loader as tloader

    batches, data, flags, config, params = _cnn_setup(tmp_path)
    monkeypatch.setattr(jloader, "load_data", lambda *a, **k: (iter(data), None))
    monkeypatch.setattr(tloader, "load_data", lambda *a, **k: (iter(data), None))
    j = jev.CNNCompare(_JaxStub(batches), config, flags)
    want = comparison_params_to_state_dict(j.train_network(params))
    t = tev.CNNCompare(_TorchStub(batches), config, flags)
    t.train_network()
    got = torch.load(tmp_path / "eval_cnn.pt", weights_only=True)
    assert set(got) == set(want)
    moved = max(float((want[k] - v).abs().max())
                for k, v in comparison_params_to_state_dict(params).items())
    assert moved > 2 * TRAINED_ATOL  # the epoch took its steps
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        assert err <= TRAINED_ATOL, (k, err)
