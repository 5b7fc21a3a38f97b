"""calodiffusion_tpu_torch on CaloChallenge dataset 1 against the JAX package
on the CPU: flat showers through the in-model NN geometry embed
(SHOWER_EMBED "orig-NN"), the phi image, the layer-conditioned U-Net.  The
binnings are chip_smoke.py's synthetic photon and pion XMLs (DS1_BINNING:
the public binning's layers as best known, one-alpha layers among them);
the shipped configs, cut to U-Net widths [8, 8, 16, 8].  Weights, inputs
and noise are made with numpy from a seed and fed to both sides."""

import json
import os
import pickle

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from calodiffusion_tpu.data import loader as jloader
from calodiffusion_tpu.models.converters import NNConverter as JaxConverter
from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu.utils import preprocessing as jprep
from calodiffusion_tpu.utils.geom import GeomConverter as JaxGeom
from calodiffusion_tpu.utils.xml_handler import XMLHandler as JaxXML
from calodiffusion_tpu_torch.data import loader as tloader
from calodiffusion_tpu_torch.models.converters import NNConverter
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
from calodiffusion_tpu_torch.ops import linear_attention as tattn
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils import preprocessing as tprep
from calodiffusion_tpu_torch.utils.config import default_flags
from calodiffusion_tpu_torch.utils.geom import GeomConverter
from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler
from tests.test_torch_port_data import make_h5
from tests.test_torch_port_model import random_params
from tests.test_torch_int8_family import Int8Runs, check_int8_generate

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
PARTS = ("photon", "pion")
# the weight-transfer bound of docs/DESIGN.md:32
DENOISE_ATOL = 2e-4


def shipped(part):
    with open(os.path.join(CONFIGS, f"config_dataset1_{part}.json")) as f:
        return json.load(f)


def ds1_config(part, xml, **kw):
    """The shipped dataset-1 config on the synthetic binning, f32, U-Net
    widths [8, 8, 16, 8] (photons' grid (5, 10, 30), pions' (7, 10, 23))."""
    cfg = shipped(part)
    cfg.update(BIN_FILE=xml, LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16,
               PRECISION="f32", **kw)
    return cfg


@pytest.fixture(scope="module")
def xmls(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds1_binning")
    out = {}
    for part in PARTS:
        (root / f"{part}.xml").write_text(chip_smoke.ds1_binning_xml(part))
        out[part] = str(root / f"{part}.xml")
    return out


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


def _embed_params(gc, seed):
    """The embed's weights near its geometric init: JAX's enc_i / dec_i
    plus 1e-2 of seeded normals."""
    rng = np.random.default_rng(seed)
    out = {}
    for i, (mat, inv) in enumerate(zip(gc.weight_mats, gc.weight_mats_inv)):
        out[f"enc_{i}"] = (mat + 1e-2 * rng.standard_normal(mat.shape)).astype(np.float32)
        out[f"dec_{i}"] = (inv + 1e-2 * rng.standard_normal(inv.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=PARTS)
def pair(request, xmls):
    """One JAX model and its port, from the same random weights (the embed's
    near its geometric init), per particle."""
    part = request.param
    cfg = ds1_config(part, xmls[part])
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    params["params"]["NN_embed"] = _embed_params(jm.net.nn_embed_gc, seed=1)
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return part, cfg, jm, params, tm


def _batch(cfg, batch, seed):
    """(flat showers, E, layers) of unit scale, as the loader yields them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, cfg["SHAPE_ORIG"][1])).astype(np.float32),
            rng.uniform(0.1, 1.0, (batch, 1)).astype(np.float32),
            rng.standard_normal((batch, cfg["SHAPE_FINAL"][2] + 1)).astype(np.float32))


# ---------------------------------------------------------------------------
# the binnings and the shipped configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", PARTS)
def test_synthetic_binning_gives_the_configs_shapes(xmls, part):
    """chip_smoke's binning: its regular grid is the config's SHAPE_FINAL,
    its voxel count SHAPE_ORIG, in both packages' geometry."""
    cfg = shipped(part)
    chip_smoke.check_ds1_binning(part, xmls[part], cfg)
    for handler, geom in ((XMLHandler, GeomConverter), (JaxXML, JaxGeom)):
        bins = handler(part, xmls[part])
        g = geom(bins)
        assert [g.num_layers, g.alpha_out, g.dim_r_out] == cfg["SHAPE_FINAL"][2:]
        assert bins.GetTotalNumberOfBins() == cfg["SHAPE_ORIG"][1]
        assert 1 in g.lay_alphas  # layers with one alpha bin, spread by the embed


@pytest.mark.parametrize("part", PARTS)
def test_shipped_configs_build_with_the_embed(xmls, part, monkeypatch):
    """The shipped configs at full width: 4 input channels ([x, R, Z, phi]),
    the embed's weights in state_dict, parameters and named_parameters, and
    the 7 attention blocks at chip_smoke's (C, N)."""
    cfg = dict(shipped(part), BIN_FILE=xmls[part])
    m = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert m.net.unet.init_conv.weight.shape[1] == 4
    assert m._data_shape == (cfg["SHAPE_ORIG"][1],)
    sd = m.state_dict()
    n_layers = cfg["SHAPE_FINAL"][2]
    embed = {f"NN_embed.{k}s.{i}.weight" for k in ("enc", "dec") for i in range(n_layers)}
    assert embed <= set(sd) and {k for k in sd if k.startswith("NN_embed.")} == embed
    named = dict(m.named_parameters())
    assert embed <= set(named) and "init_conv.weight" in named
    assert {id(p) for p in m.parameters()} == {id(p) for p in named.values()}
    assert sum(p.numel() for p in m.parameters()) == sum(v.numel() for v in sd.values())

    blocks = []

    def spy(x, *args, **kw):
        blocks.append((x.shape[2], x.shape[1]))
        return tattn.attention_block_reference(x, *args, **kw)

    monkeypatch.setattr("calodiffusion_tpu_torch.models.nn_modules.fused_attention_block", spy)
    x, E, layers = _batch(cfg, 1, seed=0)
    with torch.no_grad():
        out = m.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.full((1, 1), 0.7),
                        layers=torch.from_numpy(layers))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert blocks == chip_smoke.DS1_ATTENTION_BLOCKS[part]


def test_pre_embed_and_other_embeds_raise(xmls):
    """The dense FCN model (M11) builds on flat showers ("orig-FCN") and
    denoises as the JAX package, within 2e-4; "FCN" without "orig" is
    refused naming "orig", where the JAX package's denoise returns a wrongly
    shaped output (its Dense layers act on SHAPE_PAD's last axis, so the
    conditioning broadcasts against the batch).  A pre-embed without HGCAL is refused with a message, where
    the JAX package fails too (its model at the orig layout, its loader
    unpickling the binning XML as an HGCal geometry)."""
    cfg = ds1_config("photon", xmls["photon"], SHOWER_EMBED="orig-FCN", NUM_LAYERS_LINEAR=3)
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=3)
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    x, E, layers = _batch(cfg, 2, seed=4)
    sig = np.full((2, 1), 0.7, np.float32)
    want = np.asarray(jm.denoise(params, x, E=E, sigma=sig, layers=layers))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig),
                         layers=torch.from_numpy(layers))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
    cfg = ds1_config("photon", xmls["photon"], SHOWER_EMBED="FCN", NUM_LAYERS_LINEAR=3)
    with pytest.raises(ValueError, match="orig"):
        CaloDiffusion(dict(cfg), device="cpu")
    jm = JaxModel(dict(cfg), n_steps=10)
    x = np.zeros((2, *jm._data_shape), np.float32)  # SHAPE_PAD (2, 1, 368)
    out = jax.eval_shape(lambda p: jm.denoise(p, x, E=E, sigma=np.full((2, 1, 1), 0.7, np.float32),
                                              layers=layers), jm.init(jax.random.PRNGKey(0)))
    assert out.shape == (2, 2, 368) != x.shape  # the conditioning broadcasts over the batch
    for embed in ("orig-pre-embed", "NN-pre-embed"):
        cfg = ds1_config("photon", xmls["photon"], SHOWER_EMBED=embed, FILES=[], VAL_FILES=[])
        with pytest.raises(ValueError, match="needs HGCAL"):
            CaloDiffusion(dict(cfg), device="cpu")
        with pytest.raises(pickle.UnpicklingError):
            jloader.load_data(default_flags(data_folder="/nonexistent/"), dict(cfg))
    with pytest.raises(ValueError, match="broadcast"):
        JaxModel(ds1_config("photon", xmls["photon"], SHOWER_EMBED="orig-pre-embed")).init(
            jax.random.PRNGKey(0))


def test_nn_embed_without_orig_builds_as_jax(xmls):
    """SHOWER_EMBED "NN" (no "orig") on dataset 1 builds as in the JAX
    package: the embed in the model, showers in SHAPE_PAD's (1, 368)."""
    cfg = ds1_config("photon", xmls["photon"], SHOWER_EMBED="NN")
    m = CaloDiffusion(dict(cfg), device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(m.net.NN_embed, NNConverter)
    assert m._data_shape == JaxModel(dict(cfg))._data_shape == (1, 368)
    x, E, layers = _batch(cfg, 2, seed=3)
    with torch.no_grad():
        out = m.denoise(torch.from_numpy(x[:, None]), E=torch.from_numpy(E),
                        sigma=torch.full((2, 1, 1), 0.7), layers=torch.from_numpy(layers))
    assert out.shape == (2, 1, 368) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# NNConverter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", PARTS)
def test_nn_converter_init_is_bit_equal_to_jax(xmls, part):
    jgc = JaxGeom(JaxXML(part, xmls[part]))
    x = jnp.zeros((1, jgc.layer_boundaries[-1]), jnp.float32)
    want = JaxConverter(jgc).init(jax.random.PRNGKey(0), x)["params"]
    conv = NNConverter(GeomConverter(XMLHandler(part, xmls[part])))
    sd = conv.state_dict()
    assert len(sd) == len(want) == 2 * jgc.num_layers
    for i in range(jgc.num_layers):
        for mine, theirs in ((f"encs.{i}.weight", f"enc_{i}"), (f"decs.{i}.weight", f"dec_{i}")):
            a, b = sd[mine].numpy(), np.asarray(want[theirs])
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes(), mine


def _assert_max_norm_close(got, want, tol=1e-6):
    """|got - want| within tol of want's largest magnitude: both sum up to
    30 f32 products a value, in other orders (einsum against matmul)."""
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max-norm relative error {err:.3g} > {tol}"


@pytest.mark.parametrize("part", PARTS)
def test_enc_and_dec_match_jax(xmls, part):
    jgc = JaxGeom(JaxXML(part, xmls[part]))
    params = _embed_params(jgc, seed=2)
    conv = NNConverter(GeomConverter(XMLHandler(part, xmls[part])))
    conv.load_state_dict({f"{k}s.{i}.weight": torch.from_numpy(params[f"{k}_{i}"])
                          for k in ("enc", "dec") for i in range(jgc.num_layers)})
    x = np.random.default_rng(3).exponential(1.0, (3, jgc.layer_boundaries[-1]))
    x = x.astype(np.float32)
    jc = JaxConverter(jgc)
    want = np.asarray(jc.apply({"params": params}, x, method="enc"))
    with torch.no_grad():
        got = conv.enc(torch.from_numpy(x))
    assert got.shape == want.shape == (3, *shipped(part)["SHAPE_FINAL"][2:])
    _assert_max_norm_close(got.numpy(), want)
    y = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    want = np.asarray(jc.apply({"params": params}, y, method="dec"))
    with torch.no_grad():
        got = conv.dec(torch.from_numpy(y))
    assert got.shape == want.shape == x.shape
    _assert_max_norm_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the embedded model: denoise, loss, DDim, round trip, generate
# ---------------------------------------------------------------------------

def test_params_to_state_dict_carries_the_embed(pair):
    part, cfg, jm, params, tm = pair
    sd = tm.state_dict()
    for i in range(cfg["SHAPE_FINAL"][2]):
        for mine, theirs in ((f"NN_embed.encs.{i}.weight", f"enc_{i}"),
                             (f"NN_embed.decs.{i}.weight", f"dec_{i}")):
            np.testing.assert_array_equal(sd[mine].numpy(), params["params"]["NN_embed"][theirs])


@pytest.mark.parametrize("sigma", [0.05, 5.0])
def test_embedded_denoise_matches_jax(pair, sigma):
    part, cfg, jm, params, tm = pair
    x, E, layers = _batch(cfg, 2, seed=5)
    sig = np.full((2, 1), sigma, np.float32)
    want = np.asarray(jax.jit(
        lambda p, x, E, s, lay: jm.denoise(p, x, E=E, sigma=s, layers=lay)
    )(params, x, E, sig, layers))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig),
                         layers=torch.from_numpy(layers))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


def test_hybrid_weight_loss_matches_jax(pair):
    part, cfg, jm, params, tm = pair
    assert cfg["TRAINING_OBJ"] == "hybrid_weight"
    data, E, layers = _batch(cfg, 2, seed=6)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)
    want = float(jax.jit(lambda p: jm.compute_loss(
        p, jax.random.PRNGKey(0), data, E, noise=noise, layers=layers, rnd_normal=rnd))(params))
    got = tm.compute_loss(*(torch.from_numpy(a) for a in (data, E)), noise=torch.from_numpy(noise),
                          layers=torch.from_numpy(layers), rnd_normal=torch.from_numpy(rnd))
    assert abs(got.item() - want) <= 1e-5 * abs(want)


def test_ddim_from_an_injected_start_matches_jax(pair):
    part, cfg, jm, params, tm = pair
    steps = 4
    start, E, layers = _batch(cfg, 2, seed=8)
    want = np.asarray(jax_get_sampler("DDim")(cfg)(
        jm, params, jnp.asarray(start), jnp.asarray(E), jnp.asarray(layers), steps, 0,
        jax.random.PRNGKey(0), False))
    with torch.no_grad():
        got = get_sampler("DDim")(cfg)(tm, torch.from_numpy(start), torch.from_numpy(E),
                                       torch.from_numpy(layers), steps, 0, None, False)
    assert got.shape == want.shape == start.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


# ---------------------------------------------------------------------------
# int8 (W8A8) sampling through the in-model embed (tests/test_torch_int8_family.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int8_runs(pair):
    """The int8 comparisons of each particle's pair, computed once: the
    embed runs in f32 outside the quantized U-Net."""
    part, cfg, jm, params, tm = pair
    x, E, layers = _batch(cfg, 2, seed=40)
    start = _batch(cfg, 2, seed=41)[0]
    return Int8Runs(cfg, jm, params, tm, x, E, layers, np.full((2, 1), 0.7, np.float32), start,
                    seed=42)


def test_int8_calibration_table_matches_jax(pair, int8_runs):
    """The key set of JAX's table (the U-Net's convs, none of NN_embed), with
    and without the transposes, the values within 1e-4."""
    int8_runs.check_tables()
    assert all(k.startswith("CondUnet_0/") for k in int8_runs.tables[1])


def test_each_conv_of_an_int8_denoise_matches_the_jax_op(int8_runs):
    int8_runs.check_convs()


@pytest.mark.parametrize("what", ["denoise", "ddim"])
def test_int8_call_lies_within_int8_noise_of_jax(pair, int8_runs, what):
    """The int8 denoise and a 4-step int8 DDim from an injected start, in
    the flat orig layout, within INT8_NOISE_RMS of JAX's int8-vs-float gap."""
    int8_runs.check_within_int8_noise(what)
    assert int8_runs.port[f"{what}_int8"].shape == (2, pair[1]["SHAPE_ORIG"][1])


def test_int8_generate_calibrates_on_the_first_batch(pair):
    """generate --int8 on dataset 1: the calibration on the first batch's E
    and layers, the int8 U-Net behind the f32 embed, the flat orig-shape
    showers of the inverse preprocessing."""
    part, cfg, jm, params, tm = pair
    loader = [_batch(cfg, 2, seed=s)[1:] + (None,) for s in (43, 44)]
    check_int8_generate(tm, loader)


def test_embed_roundtrip_matches_jax(pair):
    part, cfg, jm, params, tm = pair
    x = _batch(cfg, 3, seed=9)[0]
    want = np.asarray(jm.embed_roundtrip(params, x))
    got = tm.embed_roundtrip(x)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_generate_roundtrip_in_orig_shape_matches_jax(pair):
    """generate(roundtrip=True): the loader's showers through the embed,
    then reverse_norm(orig_shape=True), flat SHAPE_ORIG showers."""
    part, cfg, jm, params, tm = pair
    loader = [(E, layers, 0.3 * x) for x, E, layers in (_batch(cfg, 3, seed=s) for s in (10, 11))]
    want, want_E = jm.generate(params, jax.random.PRNGKey(0), loader, 1, roundtrip=True)
    got, got_E = tm.generate(loader, 1, roundtrip=True)
    assert got.shape == want.shape == (6, cfg["SHAPE_ORIG"][1])
    np.testing.assert_array_equal(got_E, want_E)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


@pytest.mark.parametrize("part", PARTS)
def test_reverse_norm_orig_shape_matches_jax(xmls, part):
    """The inverse preprocessing of flat dataset-1 showers (orig_shape,
    layer-logit-norm, the particle's DATASET_NUM) equals the JAX package's
    bit for bit."""
    cfg = ds1_config(part, xmls[part])
    rng = np.random.default_rng(12)
    voxels = rng.standard_normal((4, cfg["SHAPE_ORIG"][1])).astype(np.float32)
    E = rng.uniform(0.1, 1.0, (4, 1)).astype(np.float32)
    layerE = rng.standard_normal((4, cfg["SHAPE_FINAL"][2] + 1)).astype(np.float32)
    kw = dict(shape=cfg["SHAPE_FINAL"], emax=cfg["EMAX"], emin=cfg["EMIN"], layerE=layerE,
              logE=True, binning_file=xmls[part], max_deposit=cfg["MAXDEP"],
              showerMap=cfg["SHOWERMAP"], dataset_num=cfg["DATASET_NUM"], orig_shape=True,
              ecut=float(cfg["ECUT"]))
    want = jprep.reverse_norm(voxels.copy(), E, **kw)
    got = tprep.reverse_norm(voxels.copy(), E, **kw)
    assert got[0].shape == (4, cfg["SHAPE_ORIG"][1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reverse_logit_gives_the_limit_where_jax_overflows():
    """Past exp's f32 range the JAX package's reverse_logit is inf / inf =
    NaN; the port's gives the limit, and equals it bit for bit elsewhere."""
    x = np.linspace(-120, 120, 2001, dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        want = jprep.reverse_logit(x)
    got = tprep.reverse_logit(x)
    finite = np.isfinite(want)
    assert (~finite).any() and np.isfinite(got).all()
    np.testing.assert_array_equal(got[finite], want[finite])
    np.testing.assert_array_equal(got[~finite], tprep.reverse_logit(np.float32(88.0)))


# ---------------------------------------------------------------------------
# training, the loader, the cascade
# ---------------------------------------------------------------------------

def test_adam_step_moves_the_embed(xmls, tmp_path):
    """The trainer's optimizer, EMA and checkpoints cover the embed: one
    Adam step moves every encs/decs weight, and EMA and final.ckpt hold them."""
    cfg = ds1_config("pion", xmls["pion"], EMA_DECAY=0.9, BATCH=2)
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3), cfg,
                       load_data=False, device="cpu")
    t.init_model()
    t.make_optimizer(1e-3)
    before = {k: v.clone() for k, v in t.model.state_dict().items() if k.startswith("NN_embed.")}
    assert len(before) == 2 * cfg["SHAPE_FINAL"][2]
    assert set(before) <= set(t.ema_params)
    data, E, layers = (torch.from_numpy(a) for a in _batch(cfg, 2, seed=13))
    loss = t.train_step(data, E, layers)
    assert torch.isfinite(loss)
    after = t.model.state_dict()
    for k, v in before.items():
        assert (after[k] - v).abs().max() > 0, k
        assert not torch.equal(t.ema_params[k], v), k
    t.loader_train, t.loader_val = [], None
    t.config = dict(cfg, MAXEPOCH=0)
    t.train()
    saved = torch.load(tmp_path / f"{cfg['CHECKPOINT_NAME']}_Diffusion" / "final.ckpt",
                       weights_only=True)
    for key in ("params", "ema_params"):
        assert set(before) <= set(saved[key])


def test_loader_writes_the_jax_caches_on_dataset1(xmls, tmp_path):
    """Flat orig-layout npz caches and batches, bit for bit the JAX
    loader's, from the same synthetic h5 files; chip_smoke.write_cache
    writes the same cache."""
    cfg = ds1_config("photon", xmls["photon"], BATCH=4,
                     FILES=["dataset_1_photons_1.hdf5"], VAL_FILES=["dataset_1_photons_v.hdf5"])
    dirs = []
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        make_h5(d / "dataset_1_photons_1.hdf5", 6, 368, seed=14)
        make_h5(d / "dataset_1_photons_v.hdf5", 3, 368, seed=15)
        dirs.append(str(d) + "/")
    jtrain, jval = jloader.load_data(default_flags(data_folder=dirs[0]), dict(cfg))
    ttrain, tval = tloader.load_data(default_flags(data_folder=dirs[1]), dict(cfg))
    for name in ("dataset_1_photons_1.hdf5.npz", "dataset_1_photons_v.hdf5.npz"):
        with np.load(dirs[0] + name) as a, np.load(dirs[1] + name) as b:
            assert b["showers"].shape[1:] == (368,)
            for k in ("E", "layers", "showers"):
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    for tl, jl in ((ttrain, jtrain), (tval, jval)):
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            for u, v in zip(x, y):
                assert np.asarray(u).tobytes() == np.asarray(v).tobytes()
    with h5py.File(dirs[1] + "dataset_1_photons_1.hdf5", "r") as f:
        showers, energies = f["showers"][:], f["incident_energies"][:]
    chip_smoke.write_cache(tmp_path / "smoke.npz", showers, energies, dict(cfg))
    with np.load(tmp_path / "smoke.npz") as a, np.load(dirs[1] + "dataset_1_photons_1.hdf5.npz") as b:
        for k in ("E", "layers", "showers"):
            assert a[k].tobytes() == b[k].tobytes(), k


def test_layer_cascade_generates_flat_showers(xmls):
    """The cascade on dataset 1: stage 1's layer vector of Z + 1 energies,
    stage 2 through the embed, reverse_norm in the flat orig layout."""
    cfg = ds1_config("photon", xmls["photon"])
    m = LayerDiffusion(cfg, n_steps=4, device="cpu", generator=torch.Generator().manual_seed(0))
    assert {k for k in m.state_dict() if "NN_embed" in k} == {
        f"base_model.NN_embed.{k}s.{i}.weight" for k in ("enc", "dec") for i in range(5)}
    m.load_state_dict(m.state_dict())
    _, E, layers = _batch(cfg, 2, seed=16)
    showers, energies = m.generate([(E, layers, None)], 2,
                                   generator=torch.Generator().manual_seed(1))
    assert showers.shape == (2, 368) and energies.shape == (2, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()


def test_clis_train_sample_and_plot_dataset1(xmls, tmp_path):
    """The port's CLIs on dataset 1 (the README's recipe):
    train one epoch, sample 2 DDim steps into an h5 of flat (n, 368)
    showers, read it back through process_data_dict as the JAX package does
    (GeomConverter onto the regular grid), and plot it."""
    from calodiffusion_tpu import inference as jinf
    from calodiffusion_tpu.utils.config import dotdict
    from calodiffusion_tpu_torch import inference as tinf
    from calodiffusion_tpu_torch import training as ttrain

    data = tmp_path / "data"
    data.mkdir()
    make_h5(data / "dataset_1_photons_1.hdf5", 8, 368, seed=17)
    make_h5(data / "dataset_1_photons_2.hdf5", 4, 368, seed=18)
    cfg = ds1_config("photon", xmls["photon"], BATCH=4, MAXEPOCH=1, NSTEPS=4,
                     VAL_FILES=["dataset_1_photons_2.hdf5"], CHECKPOINT_NAME="ds1_cli")
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg))
    common = ["-c", str(cfg_path), "-d", str(data) + "/", "--device", "cpu"]
    trainer = ttrain.main(common + ["--checkpoint", str(tmp_path / "ckpt"), "diffusion"])
    model_loc = os.path.join(trainer.checkpoint_folder, "final.ckpt")
    gen = str(tmp_path / "gen_ds1" / "generated.h5")
    os.makedirs(os.path.dirname(gen))
    tinf.main(common + ["sample", "--sample-steps", "2", "--model-loc", model_loc, "-g", gen,
                        "diffusion"])
    with h5py.File(gen, "r") as f:
        showers = f["showers"][:]
        assert showers.shape == (4, 368) and f["incident_energies"].shape == (4, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()

    flags = dict(data_folder=str(data) + "/", generated=gen, nevts=-1, job_idx=-1, EMin=-1.0,
                 geant_only=False, hgcal=False, plot_reshape=False)
    got, got_e = tinf.process_data_dict(dotdict(flags), dict(cfg))
    want, want_e = jinf.process_data_dict(dotdict(flags), dict(cfg))
    np.testing.assert_array_equal(got_e, want_e)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape == (4, 1, 5, 10, 30)
        np.testing.assert_array_equal(got[k], want[k])
    folder = str(tmp_path / "plots")
    tinf.main(["-c", str(cfg_path), "-d", str(data) + "/", "plot", "-g", gen,
               "--plot-folder", folder])
    assert any(f.endswith(".png") for f in os.listdir(os.path.join(folder, "ds1_cli")))
