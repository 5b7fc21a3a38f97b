"""CMS HGCal at the fidelity harness's own geometry and widths, the port
against the JAX package on the CPU.

``scripts/torch_fidelity_families.py hgcal`` (and the JAX
``scripts/tpu_fidelity_families.py`` it ports) trains on a synthetic
geometry of 28 layers, 9 cells a ring and 20 rings (1891 cells a layer),
pre-embedded by GLaM into a (28, 12, 21) grid, at widths [16, 16, 32, 32],
cond 64, mid attention only, R/Z and phi images, and scores the showers
after sparse decoding and the ``--energy-min`` mask at the readout
threshold.  This file holds each stage of that path at that geometry, in
f32 (and the train step in bf16 too): the loader's cache of the harness's
showers (its shower law, seed 0, ``N_TRAIN`` + ``N_EVAL`` events, the
threshold from those events), ``denoise``, the hybrid-weight loss, a DDim
from an injected start, ``reverse_norm_hgcal`` with sparse decoding from one
numpy Generator, the mask, and one train step (loss, every gradient, the
parameters and EMA after Adam).  The deepest layers (24-27), where the
harness's generated showers depart from Geant, get their own assertions:
each layer's energy, and each cell's occupancy after the mask.

Both packages start from the same weights: the port's seeded init, carried
to JAX by ``calodiffusion_tpu/tools/torch_import.torch_state_dict_to_params``.
The JAX side's checks come from one jit (``_jax_outputs``).
"""

import argparse
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.data import loader as jloader
from calodiffusion_tpu.evaluation import metrics_utils as jmetrics
from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu.tools.torch_import import torch_state_dict_to_params
from calodiffusion_tpu.utils import hgcal_utils as jh
from calodiffusion_tpu.utils.config import default_flags as jflags
from calodiffusion_tpu_torch.evaluation import metrics_utils as tmetrics
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils import hgcal_utils as th
from calodiffusion_tpu_torch.utils.config import default_flags

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_fidelity_families as tfam  # noqa: E402

N_TRAIN, N_EVAL = 16, 8
NLAYERS, DEEP = 28, slice(24, 28)
GRID = (NLAYERS, 12, 21)
DDIM_STEPS = 8
# the weight-transfer bound of docs/DESIGN.md:32, as tests/test_torch_port_hgcal.py
DENOISE_ATOL = 2e-4
# the caches: the GLaM encode is numpy's einsum in JAX, one torch product in
# the port (tests/test_torch_port_hgcal.py's cache bound)
CACHE_RTOL, CACHE_ATOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
# reverse_norm_hgcal of the two packages' own DDim outputs: those differ by
# up to DENOISE_ATOL in the logit space, which reverse_logit and the layer
# rescale carry into a relative difference of the cells
CELL_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads (the converters' 56 pseudo-inverses):
    the Tier-1 run shares the cores between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    """The harness's geometry (written by the JAX package), config (f32),
    showers and threshold; the JAX loader's caches of the JAX script's h5
    files and the port's caches written as the harness writes them."""
    root = tmp_path_factory.mktemp("hgcal_deep")
    geom = jh.make_synthetic_geom(nlayers=NLAYERS, cells_per_ring=9, nrings=20)
    geom_path = str(root / "geom.pkl")
    jh.save_geom(geom, geom_path)
    opts = tfam.parse(["hgcal", "--device", "cpu"])
    cfg = dict(tfam.hgcal_config(opts, geom_path, geom.max_ncell, 1), PRECISION="f32")
    files, thr = tfam.hgcal_showers(th.load_geom(geom_path), N_TRAIN, N_EVAL)
    jdir, tdir = root / "jax", root / "port"
    jdir.mkdir()
    tdir.mkdir()
    for fname, (showers, gen_info) in files.items():
        with h5py.File(jdir / fname, "w") as f:
            f.create_dataset("showers", data=showers)
            f.create_dataset("gen_info", data=gen_info)
    jloader.load_data(jflags(data_folder=str(jdir) + "/"), dict(cfg))
    tfam.write_caches(str(tdir), files, cfg, "hgcal_2.h5", "cpu")
    with np.load(tdir / "hgcal_2.h5.npz") as f:
        cache = {k: f[k] for k in f.files}
    # each package's pre-embed converter, as reverse_norm_hgcal builds it
    # (JAX's is built again at every call otherwise: 28 pseudo-inverses)
    convs = {"jax": jh.make_pre_embed_converter(cfg),
             "port": th.make_pre_embed_converter(cfg, device="cpu")}
    return argparse.Namespace(cfg=cfg, files=files, thr=thr, jdir=jdir, tdir=tdir,
                              cache=cache, C=geom.max_ncell, convs=convs)


def _inputs(h, seed):
    """Eval conditioning from the cache; seeded noise, sigmas and loss draws."""
    rng = np.random.default_rng(seed)
    x0, E, layers = (h.cache[k].astype(np.float32) for k in ("showers", "E", "layers"))
    B = len(E)
    sigma = np.geomspace(0.01, 80.0, B).astype(np.float32).reshape(B, 1, 1, 1, 1)
    return dict(
        x=(x0 + sigma * rng.standard_normal(x0.shape)).astype(np.float32), sigma=sigma,
        data=x0, E=E, layers=layers,
        noise=rng.standard_normal(x0.shape).astype(np.float32),
        rnd=rng.standard_normal(B).astype(np.float32),
        start=rng.standard_normal(x0.shape).astype(np.float32))


EMA_DECAY = 0.999
LR = 4e-4


def _jax_outputs(jm, params, cfg, inp):
    """What the tests hold the port to, from one jit: a denoise, a DDim
    from the injected start, and JAX's train step (trainer.py:371-411:
    value_and_grad of the loss, optax Adam, the EMA) on the batch, noise
    and sigma draws of ``inp``."""
    key = jax.random.PRNGKey(0)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=LR)

    def outputs(p):
        loss, grads = jax.value_and_grad(
            lambda q: jm.compute_loss(q, key, inp["data"], inp["E"], noise=inp["noise"],
                                      layers=inp["layers"], rnd_normal=inp["rnd"]))(p)
        updates, _ = opt.update(grads, opt.init(p), p)
        new = optax.apply_updates(p, updates)
        return dict(
            denoise=jm.denoise(p, inp["x"], E=inp["E"], sigma=inp["sigma"],
                               layers=inp["layers"]),
            ddim=jax_get_sampler("DDim")(cfg)(jm, p, jnp.asarray(inp["start"]),
                                              jnp.asarray(inp["E"]),
                                              jnp.asarray(inp["layers"]), DDIM_STEPS, 0, key,
                                              False),
            loss=loss, grads=grads, params=new,
            ema=jax.tree_util.tree_map(lambda e, q: EMA_DECAY * e + (1 - EMA_DECAY) * q,
                                       p, new))

    out = jax.tree_util.tree_map(np.asarray, jax.jit(outputs)(params))
    for k in ("grads", "params", "ema"):  # as state dicts, the port's names
        out[k] = {n: v.numpy() for n, v in params_to_state_dict(out[k], cfg).items()}
    return out


_TEMPLATE: dict = {}


def _jax_init(jm):
    """JAX's parameter tree at the harness's widths (the template
    torch_state_dict_to_params fills; f32 whatever the config's
    precision): one jit of ``init``, made once for the module."""
    if "params" not in _TEMPLATE:
        _TEMPLATE["params"] = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return _TEMPLATE["params"]


def _pair(cfg, seed=0):
    """The port's model from its seeded init and the JAX model with the same
    weights (the port's state_dict through torch_state_dict_to_params)."""
    tm = CaloDiffusion(dict(cfg), n_steps=cfg["NSTEPS"], device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    jm = JaxModel(dict(cfg), n_steps=cfg["NSTEPS"])
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = torch_state_dict_to_params(sd, jm, _jax_init(jm))
    return tm, jm, params


@pytest.fixture(scope="module")
def pair(harness):
    tm, jm, params = _pair(harness.cfg)
    inp = _inputs(harness, seed=1)
    return tm, jm, params, inp, _jax_outputs(jm, params, harness.cfg, inp)


# ---------------------------------------------------------------------------
# the harness's config and caches
# ---------------------------------------------------------------------------

def test_harness_config_is_the_geometry_under_test(harness):
    cfg = harness.cfg
    assert harness.C == 1891 and cfg["MAX_CELLS"] == 1891
    assert cfg["SHAPE_PAD"] == cfg["SHAPE_FINAL"] == [-1, 1, *GRID]
    assert cfg["LAYER_SIZE_UNET"] == [16, 16, 32, 32] and cfg["COND_SIZE_UNET"] == 64
    assert cfg["MID_ATTN"] and not cfg["BLOCK_ATTN"]
    assert cfg["R_Z_INPUT"] and cfg["PHI_INPUT"] and cfg["SHOWER_EMBED"] == "NN-pre-embed"


@pytest.mark.parametrize("fname", ["hgcal_1.h5", "hgcal_2.h5"])
def test_pre_embedded_caches_match_the_jax_loader(harness, fname):
    """The port's caches of the harness's showers against the JAX loader's
    of the JAX script's h5 files at the full 20 rings: E bit for bit, the
    encoded showers and the layer energies within the GLaM products'
    tolerance, layers 24-27 on their own."""
    with np.load(harness.tdir / f"{fname}.npz") as t, \
            np.load(harness.jdir / f"{fname}.npz") as j:
        assert sorted(t.files) == sorted(j.files) == ["E", "layers", "showers"]
        assert t["E"].tobytes() == j["E"].tobytes()
        n = N_TRAIN if fname == "hgcal_1.h5" else N_EVAL
        assert t["showers"].shape == j["showers"].shape == (n, 1, *GRID)
        assert t["layers"].shape == j["layers"].shape == (n, NLAYERS + 1)
        for k in ("showers", "layers"):
            np.testing.assert_allclose(t[k], j[k], rtol=CACHE_RTOL, atol=CACHE_ATOL, err_msg=k)
        np.testing.assert_allclose(t["showers"][:, 0, DEEP], j["showers"][:, 0, DEEP],
                                   rtol=CACHE_RTOL, atol=CACHE_ATOL)
        # layers holds totalE, then one column a layer
        np.testing.assert_allclose(t["layers"][:, 1:][:, DEEP], j["layers"][:, 1:][:, DEEP],
                                   rtol=CACHE_RTOL, atol=CACHE_ATOL)


# ---------------------------------------------------------------------------
# the model at the harness's widths
# ---------------------------------------------------------------------------

def test_weights_carried_to_jax_come_back(pair, harness):
    tm, jm, params, _, _ = pair
    back = params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), harness.cfg)
    sd = tm.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert back[k].numpy().tobytes() == v.numpy().tobytes(), k


def test_denoise_matches_jax(pair):
    tm, _, _, inp, want = pair
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(inp["x"]), E=torch.from_numpy(inp["E"]),
                         sigma=torch.from_numpy(inp["sigma"]),
                         layers=torch.from_numpy(inp["layers"])).numpy()
    assert got.shape == want["denoise"].shape == inp["x"].shape
    np.testing.assert_allclose(got, want["denoise"], rtol=0, atol=DENOISE_ATOL)
    np.testing.assert_allclose(got[:, :, DEEP], want["denoise"][:, :, DEEP], rtol=0,
                               atol=DENOISE_ATOL)


def test_hybrid_weight_loss_matches_jax(pair):
    tm, _, _, inp, want = pair
    with torch.no_grad():
        got = tm.compute_loss(torch.from_numpy(inp["data"]), torch.from_numpy(inp["E"]),
                              noise=torch.from_numpy(inp["noise"]),
                              layers=torch.from_numpy(inp["layers"]),
                              rnd_normal=torch.from_numpy(inp["rnd"])).item()
    assert abs(got - float(want["loss"])) <= LOSS_RTOL * abs(float(want["loss"]))


def _ddim(tm, cfg, inp):
    with torch.no_grad():
        return get_sampler("DDim")(cfg)(
            tm, torch.from_numpy(inp["start"]), torch.from_numpy(inp["E"]),
            torch.from_numpy(inp["layers"]), DDIM_STEPS, 0, None, False).numpy()


def test_ddim_from_an_injected_start_matches_jax(pair, harness):
    tm, _, _, inp, want = pair
    got = _ddim(tm, harness.cfg, inp)
    assert got.shape == want["ddim"].shape == inp["start"].shape
    np.testing.assert_allclose(got, want["ddim"], rtol=0, atol=DENOISE_ATOL)
    np.testing.assert_allclose(got[:, :, DEEP], want["ddim"][:, :, DEEP], rtol=0,
                               atol=DENOISE_ATOL)


# ---------------------------------------------------------------------------
# sparse decoding and the --energy-min mask at the harness's threshold
# ---------------------------------------------------------------------------

def _reverse_norm(h, pkg, grid, E, layers, seed):
    """reverse_norm_hgcal of ``pkg`` as ``generate`` calls it, sparse, with
    the package's pre-embed converter, the draws from ``default_rng(seed)``
    (the JAX package's fresh Generator a batch patched to that one)."""
    cfg = h.cfg
    kw = dict(shape=cfg["SHAPE_FINAL"], config=cfg, emax=cfg["EMAX"], emin=cfg["EMIN"],
              layerE=layers, logE=cfg["logE"], binning_file=cfg["BIN_FILE"],
              max_deposit=cfg["MAXDEP"], showerMap=cfg["SHOWERMAP"],
              dataset_num=cfg["DATASET_NUM"], orig_shape=False, ecut=float(cfg["ECUT"]),
              embed=True, sparse_decoding=True)
    if pkg is th:
        return th.reverse_norm_hgcal(grid, E, rng=np.random.default_rng(seed), device="cpu",
                                     NN_embed=h.convs["port"], **kw)[0]
    rng = np.random.default_rng(seed)
    real = np.random.default_rng
    np.random.default_rng = lambda *a, **k: rng
    try:
        return jh.reverse_norm_hgcal(grid, E, NN_embed=h.convs["jax"], **kw)[0]
    finally:
        np.random.default_rng = real


def _masked(pkg_metrics, cells, thr):
    out = cells.copy()
    return pkg_metrics.apply_mask_conserveE(out, out < thr)


def test_sparse_decode_and_mask_bit_equal_on_one_input(pair, harness):
    """The port's DDim output through each package's sparse
    reverse_norm_hgcal (one Generator) and mask at thr x SHOWERSCALE: bit
    for bit, layers 24-27's occupancy included."""
    tm, _, _, inp, _ = pair
    cfg = harness.cfg
    grid = _ddim(tm, cfg, inp)
    got = _reverse_norm(harness, th, grid, inp["E"], inp["layers"], seed=5)
    want = _reverse_norm(harness, jh, grid, inp["E"], inp["layers"], seed=5)
    assert got.shape == want.shape == (N_EVAL, NLAYERS, harness.C)
    assert got.tobytes() == want.tobytes()
    emin = harness.thr * cfg["SHOWERSCALE"]
    mt, mj = _masked(tmetrics, got, emin), _masked(jmetrics, want, emin)
    assert mt.tobytes() == mj.tobytes()
    assert ((mt[:, DEEP] > 0) == (mj[:, DEEP] > 0)).all()
    assert (mt[mt > 0] >= emin).all()


def test_generated_path_matches_jax_end_to_end(pair, harness):
    """Each package's own chain: its DDim (the injected start), its sparse
    reverse_norm_hgcal (one Generator), its mask.  Layers 24-27 on their
    own: each layer's energy before the mask within CELL_RTOL, and each
    cell's occupancy after the mask equal but for cells within CELL_RTOL of
    the threshold."""
    tm, _, _, inp, want = pair
    cfg = harness.cfg
    got = _reverse_norm(harness, th, _ddim(tm, cfg, inp), inp["E"], inp["layers"], seed=6)
    ref = _reverse_norm(harness, jh, want["ddim"], inp["E"], inp["layers"], seed=6)
    emin = harness.thr * cfg["SHOWERSCALE"]
    deep_t, deep_j = got[:, DEEP].sum(-1), ref[:, DEEP].sum(-1)
    np.testing.assert_allclose(deep_t, deep_j, rtol=CELL_RTOL, atol=0)
    np.testing.assert_allclose(got.sum(-1), ref.sum(-1), rtol=CELL_RTOL, atol=0)
    np.testing.assert_allclose(got, ref, rtol=CELL_RTOL, atol=1e-6 * emin)
    mt, mj = _masked(tmetrics, got, emin), _masked(jmetrics, ref, emin)
    near = np.abs(ref[:, DEEP] - emin) <= CELL_RTOL * emin
    differ = (mt[:, DEEP] > 0) != (mj[:, DEEP] > 0)
    assert not (differ & ~near).any()
    np.testing.assert_allclose(mt[:, DEEP].sum(-1), mj[:, DEEP].sum(-1), rtol=CELL_RTOL,
                               atol=0)


# ---------------------------------------------------------------------------
# one train step at the harness's config, f32 and bf16
# ---------------------------------------------------------------------------

# The JAX package's bf16 step on the CPU sums the bias and conditioning
# gradients over the (B, 28, 12, 21) positions in bf16 (XLA's CPU
# reduction): 96-103 % off its own f32 step at final_conv.1.bias,
# init_conv.bias, cond_mlp.0.weight.  The port's bf16 step sums them in f32
# and lies within 2.4-4.8 % of that f32 step (measured at two inits).  So
# the port's step, f32 and bf16, is held to the JAX f32 step; in bf16 (8
# significant bits, some 30 rounded layers between the loss and a weight)
# a gradient within 2^-4 of its tensor's largest entry, the loss 1e-2.
STEP_TOL = {"f32": dict(loss=1e-5, grad=5e-4),
            "bf16": dict(loss=1e-2, grad=2.0**-4)}


@pytest.fixture(scope="module", params=["f32", "bf16"])
def train_step(request, pair, harness, tmp_path_factory):
    """One Adam + EMA step of the port's trainer (``_accumulate_grads`` and
    ``_apply_update``) at ``PRECISION`` f32 or bf16 from the pair's weights,
    on the pair's batch, noise and sigma draws."""
    precision = request.param
    tm, _, _, inp, want = pair
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path_factory.mktemp("step")),
                                     seed=3),
                       dict(harness.cfg, PRECISION=precision, EMA_DECAY=EMA_DECAY),
                       load_data=False, save_model=False, device="cpu")
    t.init_model()
    t.model.load_state_dict(tm.state_dict())
    t.ema_params = {k: v.detach().clone() for k, v in t.model.state_dict().items()}
    t.make_optimizer(LR)
    loss = t._accumulate_grads(*(torch.from_numpy(inp[k]) for k in ("data", "E", "layers")),
                               noise=torch.from_numpy(inp["noise"]),
                               rnd_normal=torch.from_numpy(inp["rnd"])).item()
    grads = {k: p.grad.numpy().copy() for k, p in t.model.named_parameters()}
    t._apply_update()
    return precision, loss, float(want["loss"]), grads, t, (want["grads"], want["params"],
                                                            want["ema"])


def _max_norm_err(got, want, floor):
    return np.abs(got - want).max() / (np.abs(want).max() + floor)


def test_train_step_loss_and_every_gradient_match_jax(train_step):
    """The loss relative to JAX's f32 loss; each gradient in max-norm
    relative to max(|jax f32|) + 1e-3 G, G the largest gradient
    entry (a conv bias ahead of a one-channel GroupNorm group has a zero
    gradient but for roundoff; tests/test_torch_port_train.py)."""
    precision, loss, want_loss, grads, _, (want, _, _) = train_step
    tol = STEP_TOL[precision]
    assert abs(loss - want_loss) <= tol["loss"] * abs(want_loss)
    assert set(grads) == set(want)
    G = max(np.abs(w).max() for w in want.values())
    errs = {k: _max_norm_err(grads[k], w, 1e-3 * G) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["grad"], f"{worst}: {errs[worst]:.3g}"


def test_train_step_parameters_and_ema_after_adam_match_jax(train_step):
    """After one Adam step (|update| = lr for every entry whose gradient is
    above Adam's eps) and the EMA: within lr x 1e-3 of JAX's f32 step, i.e.
    the same sign of every update but where the gradient lies within the
    gradient tolerance of zero; no entry moves more than 2 lr apart."""
    precision, _, _, _, t, (want_grads, new, ema) = train_step
    tol = STEP_TOL[precision]["grad"]
    G = max(np.abs(g).max() for g in want_grads.values())
    for k, p in t.model.named_parameters():
        g = np.abs(want_grads[k])
        near_zero = g <= tol * (g.max() + 1e-3 * G)
        err = np.abs(p.detach().numpy() - new[k])
        assert (err[~near_zero] <= LR * 1e-3).all() and (err <= 2 * LR + 1e-7).all(), k
        e_err = np.abs(t.ema_params[k].numpy() - ema[k])
        assert (e_err[~near_zero] <= 1e-6).all(), k
        assert (e_err <= (1 - EMA_DECAY) * 2 * LR + 1e-7).all(), k


# ---------------------------------------------------------------------------
# tests/torch_hgcal_split.py, the trained-weight split's helper
# ---------------------------------------------------------------------------

def test_split_helper_draws_the_harness_eval_set(monkeypatch):
    """Its chunked draw equals hgcal_showers' one draw: the eval showers,
    gen_info and threshold bit for bit (the train set cut to 40 events)."""
    import torch_hgcal_split as split

    monkeypatch.setattr(split, "CHUNK", 16)
    geom = th.make_synthetic_geom(nlayers=NLAYERS, cells_per_ring=9, nrings=20)
    files, thr = tfam.hgcal_showers(geom, 40, 6)
    showers, info, got_thr = split.harness_eval_set(geom, 4, n_train=40, n_eval=6)
    assert got_thr == thr
    assert showers.tobytes() == files["hgcal_2.h5"][0][:4].tobytes()
    assert info.tobytes() == files["hgcal_2.h5"][1][:4].tobytes()


def test_split_helper_runs_end_to_end(tmp_path, monkeypatch):
    """From the port's seeded weights, 4 events and 2 DDim steps (train set
    cut to 32 events): the report's keys, JAX and the port within the
    denoise bound."""
    import torch_hgcal_split as split

    monkeypatch.setattr(split, "N_TRAIN", 32)
    monkeypatch.setattr(split, "N_EVAL", 8)
    cfg = tfam.hgcal_config(tfam.parse(["hgcal", "--device", "cpu"]), "", 1891, 1)
    # the module's parameter template, for the helper's (its values are the port's)
    template = _jax_init(JaxModel(dict(cfg, BIN_FILE=""), n_steps=cfg["NSTEPS"]))
    monkeypatch.setattr(JaxModel, "init", lambda self, key: template)
    weights = tmp_path / "w.pt"
    torch.save(CaloDiffusion(dict(cfg, BIN_FILE=""), device="cpu",
                             generator=torch.Generator().manual_seed(0)).state_dict(), weights)
    report = split.main(["--checkpoint", str(weights), "--events", "4", "--steps", "2",
                         "--threads", "2", "--out", str(tmp_path / "split.json")])
    assert report["ddim_max_abs_diff"] <= DENOISE_ATOL * max(1.0, report["ddim_scale"])
    for who in ("port", "jax", "geant"):
        assert set(report[who]) == {f"layer{i}" for i in range(24, 28)}
    assert (tmp_path / "split.json").exists()


# ---------------------------------------------------------------------------
# the trainers' loops at a cut, their steps stubbed
# ---------------------------------------------------------------------------

# batch 8: the JAX tests' mesh has 8 host devices, and JAX pads a batch to
# a multiple of them (by repeating its last row); one process of the port
# does not
LOOP_EPOCHS, LOOP_BATCH, LOOP_EARLYSTOP = 12, 8, 3
STEPS_PER_EPOCH = N_TRAIN // LOOP_BATCH


def _scripted_loss(step):
    """Train loss a step: falling for 3 epochs, then flat."""
    return 1.0 / (1 + min(step // STEPS_PER_EPOCH, 2))


def _scripted_val(steps_done):
    """Val loss after ``steps_done`` train steps: best at epoch 2, then
    rising, so the early stopper (EARLYSTOP 3) ends the loop at epoch 5."""
    return 0.5 + 0.01 * max(0, steps_done // STEPS_PER_EPOCH - 3)


def test_trainer_loop_matches_jax_at_a_cut(harness, tmp_path, monkeypatch):
    """Both trainers' ``train()`` at the harness's config on its caches
    (16 train, 8 val events), batch 8, up to 12 epochs, SWA from epoch 3,
    EARLYSTOP 3, with the train and val steps stubbed to scripted losses:
    each step's batch (E bit for bit, layer energies within the caches'
    tolerance; the first epoch streamed, later ones reshuffled from the
    device cache), the epoch the early stopper ends on, the LR at every
    step (the plateau scheduler's classes are held to JAX's in
    tests/test_torch_port_train.py), the SWA count, and the weights
    inference is served (the SWA average)."""
    import calodiffusion_tpu.train.trainer as jtrainer

    cfg = dict(harness.cfg, BATCH=LOOP_BATCH, MAXEPOCH=LOOP_EPOCHS, SWA_START_FRAC=0.25,
               EARLYSTOP=LOOP_EARLYSTOP)
    seen = {"jax": [], "port": []}

    jt = jtrainer.TrainDiffusion(jflags(data_folder=str(harness.jdir) + "/",
                                        checkpoint_folder=str(tmp_path / "jax"), seed=3),
                                 dict(cfg), save_model=False)

    def jax_steps():
        def train_step(params, opt_state, ema_params, key, data, E, layers):
            step = len(seen["jax"])
            seen["jax"].append((np.asarray(E), np.asarray(layers),
                                float(opt_state.hyperparams["learning_rate"])))
            return params, opt_state, ema_params, jnp.float32(_scripted_loss(step))

        def val_step(params, data, E, layers, rnd_normal, mask, key):
            return jnp.float32(_scripted_val(len(seen["jax"])))

        return train_step, val_step

    monkeypatch.setattr(jt, "_make_train_step", jax_steps)
    template = _jax_init(JaxModel(dict(cfg), n_steps=cfg["NSTEPS"]))
    monkeypatch.setattr(JaxModel, "init", lambda self, key: template)  # the steps are stubs
    jt.train()

    tt = TrainDiffusion(default_flags(data_folder=str(harness.tdir) + "/",
                                      checkpoint_folder=str(tmp_path / "port"), seed=3),
                        dict(cfg), save_model=False, device="cpu")

    def port_step(data, E, layers):
        step = len(seen["port"])
        seen["port"].append((E.numpy().copy(), layers.numpy().copy(),
                             tt.opt.param_groups[0]["lr"]))
        return torch.tensor(_scripted_loss(step))

    monkeypatch.setattr(tt, "train_step", port_step)
    monkeypatch.setattr(tt, "val_step",
                        lambda *a, **k: torch.tensor(_scripted_val(len(seen["port"]))))
    tt.train()

    got, want = seen["port"], seen["jax"]
    assert len(got) == len(want) and len(got) % STEPS_PER_EPOCH == 0
    assert len(got) // STEPS_PER_EPOCH == 6  # the early stopper ended it at epoch 5
    for (e_t, l_t, lr_t), (e_j, l_j, lr_j) in zip(got, want):
        assert e_t.tobytes() == e_j.tobytes()
        np.testing.assert_allclose(l_t, l_j, rtol=CACHE_RTOL, atol=CACHE_ATOL)
        assert lr_t == pytest.approx(lr_j, rel=1e-6)
    assert tt.swa_n == jt.swa_n > 0
    assert tt.inference_weights() is tt.swa_params
