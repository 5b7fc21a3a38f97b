"""The port's CMS HGCal path (GLaM geometry, pre-embed, in-model GLaM,
sparse decoding) against the JAX package, on the JAX tests' synthetic
geometry (4 layers, 6 cells a ring, 5 rings: 91 cells, grid (4, 8, 6); the
detector pickles are not in the repository) and U-Net widths [8, 8, 8, 8].
Inputs are seeded numpy; the JAX side runs on the CPU, and
the port on the CPU (plain versions).  The JAX side of each model's checks
comes from one jit (``_jax_outputs``)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from calodiffusion_tpu.data import loader as jloader
from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu.utils import hgcal_utils as jh
from calodiffusion_tpu_torch.data import loader as tloader
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.utils import hgcal_utils as th
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_model import random_params
from tests.test_torch_int8_family import Int8Runs, check_int8_generate
from tests.utils_test import tiny_ds2_config

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
BINS = [-1, 1, 4, 8, 6]
NCELL = 91
DENOISE_ATOL = 2e-4  # the weight-transfer bound of docs/DESIGN.md:32
GLAM_RTOL = 1e-5  # torch's f32 product against numpy's einsum, max-norm relative
EMBEDS = ("pre-embed", "frozen", "trainable")


@pytest.fixture(scope="module")
def geom_file(tmp_path_factory):
    """The JAX tests' synthetic geometry, written with the JAX package's
    save_geom."""
    path = tmp_path_factory.mktemp("hgcal_geom") / "synth_geom.pkl"
    jh.save_geom(jh.make_synthetic_geom(nlayers=4, cells_per_ring=6, nrings=5), str(path))
    return str(path)


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


def hgcal_config(geom_file, embed="pre-embed", **kw):
    """A tiny HGCal config on the synthetic geometry: layer-logit-norm,
    hybrid_weight, R/Z and phi images, block and mid attention, f32."""
    cells = [-1, 4, NCELL]
    cfg = tiny_ds2_config(
        HGCAL=True, DATASET_NUM=121, BIN_FILE=geom_file, MAX_CELLS=NCELL,
        SHOWER_EMBED="NN-pre-embed" if embed == "pre-embed" else "NN",
        TRAINABLE_EMBED=embed == "trainable", SHAPE_ORIG=cells,
        SHAPE_PAD=BINS if embed == "pre-embed" else cells, SHAPE_FINAL=BINS,
        LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, BLOCK_ATTN=True, MID_ATTN=True,
        R_Z_INPUT=True, PHI_INPUT=True, EMAX=[100, 2.01, 1.572], EMIN=[50, 1.99, 1.57],
        logE=False, MAXDEP=1.0, SHOWERSCALE=1.0, ECUT=0.001, PRECISION="f32")
    cfg.update(kw)
    return cfg


def _max_norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _converters(geom_file, norm=True):
    j = jh.HGCalConverter(bins=BINS, geom_file=geom_file).init(norm=norm, dataset_num=121)
    t = th.HGCalConverter(bins=BINS, geom_file=geom_file).init(norm=norm, dataset_num=121,
                                                               device="cpu")
    return j, t


def _cells(n, seed, scale=1.0):
    """Raw cell energies (n, 4, 91), exponential, 70 % zero."""
    rng = np.random.default_rng(seed)
    x = rng.exponential(scale, (n, 4, NCELL)).astype(np.float32)
    x[rng.uniform(size=x.shape) < 0.7] = 0
    return x


# ---------------------------------------------------------------------------
# geometry, GLaM matrices and products
# ---------------------------------------------------------------------------

def test_geometry_maps_and_matrices_are_bit_equal(geom_file):
    """load_geom, make_synthetic_geom, init_map per layer and the
    converter's init (norm and not; numpy pinv on the CPU) bit for bit."""
    jg, tg = jh.load_geom(geom_file), th.load_geom(geom_file)
    for k in ("xmap", "ymap", "ring_map", "ncells", "theta_map"):
        assert getattr(tg, k).tobytes() == getattr(jg, k).tobytes(), k
    assert tg.max_ncell == jg.max_ncell == NCELL
    for k in ("xmap", "ymap", "ring_map", "nrings"):
        assert np.array_equal(getattr(th.make_synthetic_geom(nlayers=3, nrings=4), k),
                              getattr(jh.make_synthetic_geom(nlayers=3, nrings=4), k))
    for lay in range(4):
        for a, b in zip(th.init_map(8, 6, tg, lay), jh.init_map(8, 6, jg, lay)):
            assert a.tobytes() == b.tobytes()
    for norm in (True, False):
        j, t = _converters(geom_file, norm)
        for k in ("enc_mat", "dec_mat", "enc_mask", "dec_mask"):
            assert getattr(t, k).tobytes() == getattr(j, k).tobytes(), (k, norm)
        assert (t.embed_mean, t.embed_std) == (j.embed_mean, j.embed_std)


def test_geometry_pickled_by_either_package_loads_in_both(tmp_path):
    geom = jh.make_synthetic_geom(nlayers=2, cells_per_ring=6, nrings=3)
    paths = {"jax": str(tmp_path / "by_jax.pkl"), "port": str(tmp_path / "by_port.pkl")}
    jh.save_geom(geom, paths["jax"])
    port_geom = th.HGCalGeo()
    port_geom.__dict__.update({k: v for k, v in geom.__dict__.items()
                               if k not in ("theta_map", "max_ncell")})
    th.save_geom(port_geom, paths["port"])
    with open(paths["port"], "rb") as f:
        assert b"calodiffusion_tpu_torch.utils.hgcal_utils" in f.read()
    for path in paths.values():
        for pkg in (jh, th):
            g = pkg.load_geom(path)
            assert g.max_ncell == 37 and g.theta_map.shape == (2, 37)
            np.testing.assert_array_equal(g.ring_map, geom.ring_map)
        assert isinstance(th.load_geom(path), th.HGCalGeo)
        # the port's unpickler never imports the JAX package for the class
        with open(path, "rb") as f:
            assert type(th._RenameUnpickler(f).load()) is th.HGCalGeo


def test_synthetic_geometry_can_hold_exactly_max_cells():
    """make_synthetic_geom's max_cells fills the last ring in part
    (chip_smoke builds the shipped configs' geometries so)."""
    g = th.make_synthetic_geom(nlayers=2, cells_per_ring=10, nrings=20, max_cells=2076)
    assert g.max_ncell == 2076 and (g.ncells == 2076).all() and g.ring_map.max() == 20
    assert (g.ring_map[0] == 20).sum() == 2076 - (1 + 10 * 19 * 20 // 2)
    with pytest.raises(ValueError, match="max_cells"):
        th.make_synthetic_geom(nlayers=1, cells_per_ring=6, nrings=2, max_cells=20)


def test_dense_enc_and_dec_match_numpy(geom_file):
    """The torch products on the CPU against the JAX package's np.einsum,
    batched layouts (B, L, n) and (B, 1, L, n) and the batch helpers."""
    j, t = _converters(geom_file)
    x = _cells(6, seed=0)
    for xx in (x, x[:, None]):
        got, want = t.enc(xx, device="cpu"), j.enc(xx)
        assert got.shape == want.shape and got.dtype == np.float32
        assert _max_norm_rel(got, want) <= GLAM_RTOL
    assert _max_norm_rel(t.enc_batches(x, batch_size=4, device="cpu"),
                         j.enc_batches(x, batch_size=4)) <= GLAM_RTOL
    y = np.random.default_rng(1).standard_normal((6, 4, 8, 6)).astype(np.float32)
    got, want = t.dec(y, device="cpu"), j.dec(y)
    assert got.shape == want.shape == (6, 4, NCELL)
    assert _max_norm_rel(got, want) <= GLAM_RTOL
    assert _max_norm_rel(t.dec_batches(y, batch_size=4, device="cpu"),
                         j.dec_batches(y, batch_size=4)) <= GLAM_RTOL


@pytest.mark.parametrize("per_batch", [False, True])
def test_sparse_decode_is_bit_equal_for_one_rng(geom_file, per_batch):
    j, t = _converters(geom_file)
    y = np.abs(np.random.default_rng(2).standard_normal((5, 4, 8, 6))).astype(np.float32)
    got = t.dec(y, sparse_decoding=True, sparse_per_batch=per_batch,
                rng=np.random.default_rng(3))
    want = j.dec(y, sparse_decoding=True, sparse_per_batch=per_batch,
                 rng=np.random.default_rng(3))
    assert got.tobytes() == want.tobytes()
    # dec_batches draws every batch from the one rng in turn
    rng = np.random.default_rng(4)
    want = np.concatenate([j.dec(y[i:i + 2], sparse_decoding=True, rng=rng)
                           for i in range(0, 5, 2)])
    got = t.dec_batches(y, batch_size=2, sparse_decoding=True, rng=np.random.default_rng(4))
    assert got.tobytes() == want.tobytes()


def test_preprocess_and_reverse_norm_match_jax(geom_file):
    """preprocess_hgcal_shower bit for bit; reverse_norm_hgcal through the
    pre-embed's dense decode (torch) and the layer rescale, and through the
    sparse decode (one rng) bit for bit."""
    j, t = _converters(geom_file)
    raw = _cells(8, seed=5, scale=0.01)
    gen = np.random.default_rng(6).uniform(0.2, 0.8, (8, 3)).astype(np.float32)
    e = (np.array([50, 1.99, 1.57]) + np.array([50, 0.02, 0.002]) * gen)[:, 0]
    emb = j.enc(raw)
    kw = dict(showerMap="layer-logit-norm", dataset_num=121, max_deposit=1.0)
    want = jh.preprocess_hgcal_shower(emb.copy(), e, None, **kw)
    got = th.preprocess_hgcal_shower(emb.copy(), e, None, **kw)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    pre, layerE = want
    kw = dict(emax=[100, 2.01, 1.572], emin=[50, 1.99, 1.57], layerE=layerE,
              showerMap="layer-logit-norm", dataset_num=121, max_deposit=1.0, embed=True)
    rec_j, gen_j = jh.reverse_norm_hgcal(pre.reshape(-1, 1, 4, 8, 6), gen, NN_embed=j, **kw)
    rec_t, gen_t = th.reverse_norm_hgcal(pre.reshape(-1, 1, 4, 8, 6), gen, NN_embed=t,
                                         device="cpu", **kw)
    assert rec_t.shape == rec_j.shape == (8, 4, NCELL)
    assert gen_t.tobytes() == gen_j.tobytes()
    assert _max_norm_rel(rec_t, rec_j) <= 1e-5
    # the layer rescale gives each layer its target energy in both
    np.testing.assert_allclose(rec_t.sum(-1), rec_j.sum(-1), rtol=1e-5)
    rec_j = jh.reverse_norm_hgcal(pre, gen, NN_embed=j, **kw)[0]  # sparse: one rng
    state = np.random.default_rng(7)
    j_dec = j.dec_batches

    def seeded(x, **k):  # the JAX package draws from a fresh Generator a batch
        return np.concatenate([j.dec(x[i:i + 128], sparse_decoding=True, rng=state)
                               for i in range(0, x.shape[0], 128)])

    j.dec_batches = seeded
    try:
        rec_j = jh.reverse_norm_hgcal(pre, gen, NN_embed=j, sparse_decoding=True, **kw)[0]
    finally:
        j.dec_batches = j_dec
    rec_t = th.reverse_norm_hgcal(pre, gen, NN_embed=t, sparse_decoding=True,
                                  rng=np.random.default_rng(7), **kw)[0]
    assert rec_t.tobytes() == rec_j.tobytes()


def _mock_h5(path, n, seed):
    import h5py

    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        f.create_dataset("gen_info", data=rng.uniform(0.5, 1.0, (n, 3)).astype("<f4"))
        f.create_dataset("showers", data=_cells(n, seed + 1).astype("<f4"))


def test_loader_writes_the_jax_caches(geom_file, tmp_path):
    """load_data on a mock HGCal h5 with the pre-embed: the same npz cache
    names and keys as the JAX loader's, E bit for bit, the encoded showers
    and layer energies within the GLaM products' tolerance."""
    cfg = hgcal_config(geom_file, FILES=["hgcal_1.h5"], EVAL=["hgcal_1.h5"],
                       VAL_FILES=["hgcal_2.h5"], BATCH=8)
    dirs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        _mock_h5(d / "hgcal_1.h5", 12, seed=8)
        _mock_h5(d / "hgcal_2.h5", 5, seed=9)
        dirs[name] = str(d) + "/"
    jl = jloader.load_data(default_flags(data_folder=dirs["jax"], nevts=10), dict(cfg))
    tl = tloader.load_data(default_flags(data_folder=dirs["port"], nevts=10), dict(cfg),
                           device="cpu")
    assert len(tl[0].files) == len(jl[0].files) == 1 and tl[1] is jl[1] is None
    assert sorted(os.listdir(dirs["port"])) == sorted(os.listdir(dirs["jax"])) == [
        "hgcal_1.h5", "hgcal_1.h5.n10.npz", "hgcal_2.h5"]
    with np.load(dirs["port"] + "hgcal_1.h5.n10.npz") as a, \
            np.load(dirs["jax"] + "hgcal_1.h5.n10.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["E", "layers", "showers"]
        assert a["E"].tobytes() == b["E"].tobytes() and a["E"].shape == (10, 3)
        assert a["showers"].shape == b["showers"].shape == (10, 1, 4, 8, 6)
        assert a["layers"].shape == (10, 5)
        for k in ("showers", "layers"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-4)


def test_chip_smoke_hgcal_caches_equal_the_loaders(geom_file, tmp_path):
    """chip_smoke writes HGCal's npz caches without h5py (the card machine
    has none): from the same raw showers and gen_info they equal the port
    loader's, bit for bit (its GLaM encode on the CPU here)."""
    import h5py

    cfg = hgcal_config(geom_file, FILES=["hgcal_1.h5"], VAL_FILES=[], SHOWERSCALE=200.0)
    rng = np.random.default_rng(20)
    raw, gen_info = chip_smoke.raw_hgcal_showers(rng, 6, cfg)
    assert raw.shape == (6, 4, NCELL) and (raw >= 0).all()
    lo, hi = np.array(cfg["EMIN"]), np.array(cfg["EMAX"])
    assert ((gen_info >= lo) & (gen_info <= hi)).all()
    with h5py.File(tmp_path / "hgcal_1.h5", "w") as f:
        f.create_dataset("gen_info", data=gen_info)
        f.create_dataset("showers", data=raw)
    tloader.load_data(default_flags(data_folder=str(tmp_path) + "/"), dict(cfg), device="cpu")
    conv = th.make_pre_embed_converter(cfg, device="cpu")
    chip_smoke.write_hgcal_cache(tmp_path / "smoke.npz", [(raw, gen_info)], cfg, conv,
                                 device="cpu")
    with np.load(tmp_path / "smoke.npz") as a, np.load(tmp_path / "hgcal_1.h5.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("E", "layers", "showers"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_non_hgcal_pre_embed_is_refused(tmp_path):
    """A pre-embed without HGCAL: the JAX loader fails unpickling BIN_FILE as
    a geometry; the port refuses it with a message, in the model and the
    loader."""
    for embed in ("NN-pre-embed", "orig-pre-embed"):
        cfg = tiny_ds2_config(SHOWER_EMBED=embed, FILES=[], VAL_FILES=[])
        with pytest.raises(FileNotFoundError):
            jloader.load_data(default_flags(data_folder=str(tmp_path)), dict(cfg))
        with pytest.raises(ValueError, match="needs HGCAL"):
            tloader.load_data(default_flags(data_folder=str(tmp_path)), dict(cfg), device="cpu")
        with pytest.raises(ValueError, match="needs HGCAL"):
            CaloDiffusion(cfg, device="cpu")


# ---------------------------------------------------------------------------
# the model: pre-embed, and the in-model GLaM frozen and trainable
# ---------------------------------------------------------------------------

def _loss_inputs(cfg):
    data, E, layers = _batch(cfg, 2, seed=11)
    rng = np.random.default_rng(12)
    return (data, E, layers, rng.standard_normal(data.shape).astype(np.float32),
            rng.standard_normal(2).astype(np.float32))


def _jax_outputs(jm, params, cfg, embed):
    """What the tests hold the port to, from one jit a model: a denoise; the
    loss with the pre-embed and the trainable GLaM; the round trip through
    the in-model GLaM; with the pre-embed, a 4-step DDim."""
    x, E, layers = _batch(cfg, 2, seed=10)
    sig = np.full((2,) + (1,) * (x.ndim - 1), 0.7, np.float32)
    data, E2, layers2, noise, rnd = _loss_inputs(cfg)
    start, E3, layers3 = _batch(cfg, 2, seed=13)
    x_rt = np.abs(_batch(cfg, 3, seed=14)[0])
    key = jax.random.PRNGKey(0)

    def outputs(p):
        out = dict(denoise=jm.denoise(p, x, E=E, sigma=sig, layers=layers))
        if embed != "frozen":
            out["loss"] = jm.compute_loss(p, key, data, E2, noise=noise, layers=layers2,
                                          rnd_normal=rnd)
        if embed != "pre-embed":
            out["roundtrip"] = jm.embed_roundtrip(p, x_rt)
        else:
            out["ddim"] = jax_get_sampler("DDim")(cfg)(jm, p, jnp.asarray(start),
                                                      jnp.asarray(E3), jnp.asarray(layers3),
                                                      4, 0, key, False)
        return out

    return jax.tree_util.tree_map(np.asarray, jax.jit(outputs)(params))


@pytest.fixture(scope="module")
def pairs(geom_file):
    """By embed, built at first use: the JAX model and its port from the
    same random weights (a trainable GLaM's near its geometric init), and
    the JAX outputs (_jax_outputs)."""
    built = {}

    def get(embed):
        if embed not in built:
            cfg = hgcal_config(geom_file, embed)
            jm = JaxModel(dict(cfg), n_steps=10)
            if "shapes" not in built:  # the U-Net's are the same in the three
                built["shapes"] = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            params = random_params(built["shapes"], seed=0)
            if embed == "trainable":
                rng = np.random.default_rng(1)
                conv = jm.net.hgcal_converter
                params["params"]["NN_embed"] = {
                    k: (conv[init] + 1e-2 * rng.standard_normal(conv[init].shape)
                        ).astype(np.float32)
                    for k, init in (("enc_mat", "enc_init"), ("dec_mat", "dec_init"))}
            tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
            tm.load_state_dict(params_to_state_dict(params, cfg))
            built[embed] = (embed, cfg, jm, params, tm, _jax_outputs(jm, params, cfg, embed))
        return built[embed]

    return get


def _batch(cfg, batch, seed):
    """(showers in the model's layout, E of 3 gen-info columns, layers)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, *cfg["SHAPE_PAD"][1:])).astype(np.float32),
            rng.uniform(0.1, 1.0, (batch, 3)).astype(np.float32),
            rng.standard_normal((batch, 5)).astype(np.float32))


@pytest.mark.parametrize("embed", EMBEDS)
def test_the_model_holds_the_glam_as_jax_does(pairs, embed):
    """cond_size + 2 (three gen-info columns); the in-model GLaM under the
    reference names: parameters when trainable (masks as buffers), nothing
    in state_dict when frozen; params_to_state_dict carries JAX's
    enc_mat / dec_mat."""
    embed, cfg, jm, params, tm, _ = pairs(embed)
    assert tm.cond_size == jm.cond_size == 2 + 4 + 2
    assert tm._data_shape == jm._data_shape
    keys = {k for k in tm.state_dict() if k.startswith("NN_embed.")}
    named = {k for k, _ in tm.named_parameters() if k.startswith("NN_embed.")}
    if embed == "trainable":
        assert keys == named == {"NN_embed.embeder.mat", "NN_embed.decoder.mat"}
        sd = params_to_state_dict(params, cfg)
        for k, jk in (("embeder", "enc_mat"), ("decoder", "dec_mat")):
            assert sd[f"NN_embed.{k}.mat"].numpy().tobytes() == \
                params["params"]["NN_embed"][jk].tobytes()
            mat = getattr(tm.net.NN_embed, k)
            assert mat.mask.dtype == torch.float32 and not mat.mask.requires_grad
    else:
        assert keys == named == set()
    if embed == "frozen":
        conv = jm.net.hgcal_converter
        assert tm.net.NN_embed.embeder.mat.numpy().tobytes() == conv["enc_init"].tobytes()
        assert tm.net.NN_embed.decoder.mat.numpy().tobytes() == conv["dec_init"].tobytes()
    assert (tm.net.NN_embed is None) == (embed == "pre-embed")


@pytest.mark.parametrize("embed", EMBEDS)
def test_denoise_matches_jax(pairs, embed):
    embed, cfg, jm, params, tm, jax_out = pairs(embed)
    x, E, layers = _batch(cfg, 2, seed=10)
    sig = np.full((2,) + (1,) * (x.ndim - 1), 0.7, np.float32)
    want = jax_out["denoise"]
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig),
                         layers=torch.from_numpy(layers))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


@pytest.mark.parametrize("embed", ["pre-embed", "trainable"])
def test_hybrid_weight_loss_matches_jax(pairs, embed):
    """The loss within 1e-5 relative; with the trainable GLaM its matrices
    get gradients, exactly 0 where their masks are."""
    embed, cfg, jm, params, tm, jax_out = pairs(embed)
    data, E, layers, noise, rnd = _loss_inputs(cfg)
    want = float(jax_out["loss"])
    tm.net.zero_grad()
    got = tm.compute_loss(*(torch.from_numpy(a) for a in (data, E)),
                          noise=torch.from_numpy(noise), layers=torch.from_numpy(layers),
                          rnd_normal=torch.from_numpy(rnd))
    assert abs(got.item() - want) <= 1e-5 * abs(want)
    if embed == "trainable":
        got.backward()
        for k in ("embeder", "decoder"):
            mat = getattr(tm.net.NN_embed, k)
            g, mask = mat.mat.grad.numpy(), mat.mask.numpy()
            assert (g[mask == 0] == 0).all() and np.abs(g[mask == 1]).max() > 0


def test_ddim_from_an_injected_start_matches_jax(pairs):
    embed, cfg, jm, params, tm, jax_out = pairs("pre-embed")
    start, E, layers = _batch(cfg, 2, seed=13)
    want = jax_out["ddim"]
    with torch.no_grad():
        got = get_sampler("DDim")(cfg)(tm, torch.from_numpy(start), torch.from_numpy(E),
                                       torch.from_numpy(layers), 4, 0, None, False)
    assert got.shape == want.shape == start.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DENOISE_ATOL)


@pytest.mark.parametrize("embed", EMBEDS)
def test_embed_roundtrip_matches_jax(pairs, embed):
    """Through the in-model GLaM's enc and dec; identity with the pre-embed,
    as in the JAX package."""
    embed, cfg, jm, params, tm, jax_out = pairs(embed)
    x = np.abs(_batch(cfg, 3, seed=14)[0])
    got = tm.embed_roundtrip(x).numpy()
    want = jax_out.get("roundtrip", x)
    assert got.shape == want.shape == x.shape
    if embed == "pre-embed":
        assert got.tobytes() == x.tobytes() == np.asarray(jm.embed_roundtrip(params, x)).tobytes()
    assert _max_norm_rel(got, want) <= 1e-5


@pytest.mark.parametrize("sparse", [False, True])
def test_generate_roundtrip_decodes_as_jax(pairs, sparse, monkeypatch):
    """generate(roundtrip=True) on the pre-embed: the loader's grids through
    reverse_norm_hgcal's GLaM decode, dense (torch) or sparse (one seeded
    rng; the JAX package's fresh Generator patched to it), in SHAPE_ORIG."""
    embed, cfg, jm, params, tm, _ = pairs("pre-embed")
    loader = [(E, np.clip(layers, -1, 1), 0.3 * x)
              for x, E, layers in (_batch(cfg, 3, seed=s) for s in (15, 16))]
    got, got_E = tm.generate(loader, 1, roundtrip=True, sparse_decoding=sparse,
                             rng=np.random.default_rng(17))
    if sparse:
        shared = np.random.default_rng(17)
        monkeypatch.setattr(np.random, "default_rng", lambda *a, **k: shared)
    want, want_E = jm.generate(params, jax.random.PRNGKey(0), loader, 1, roundtrip=True,
                               sparse_decoding=sparse)
    assert got.shape == want.shape == (6, 4, NCELL)
    assert got_E.tobytes() == want_E.tobytes() and got_E.shape == (6, 3)
    assert np.isfinite(got).all() and (got >= 0).all()
    if sparse:
        assert got.tobytes() == want.tobytes()
        assert (got > 0).sum() < (tm.generate(loader, 1, roundtrip=True)[0] > 0).sum()
    else:
        assert _max_norm_rel(got, want) <= 1e-5


# ---------------------------------------------------------------------------
# int8 (W8A8) sampling, pre-embed and in-model GLaM (tests/test_torch_int8_family.py)
# ---------------------------------------------------------------------------

INT8_EMBEDS = ("pre-embed", "trainable")


@pytest.fixture(scope="module")
def int8_runs(pairs):
    """By embed, computed at first use: E the three gen-info columns, the
    GLaM outside the quantized U-Net."""
    runs = {}

    def get(embed):
        if embed not in runs:
            _, cfg, jm, params, tm, _ = pairs(embed)
            x, E, layers = _batch(cfg, 2, seed=30)
            start = _batch(cfg, 2, seed=31)[0]
            sigma = np.full((2,) + (1,) * (x.ndim - 1), 0.7, np.float32)
            runs[embed] = Int8Runs(cfg, jm, params, tm, x, E, layers, sigma, start, seed=32)
        return runs[embed]

    return get


@pytest.mark.parametrize("embed", INT8_EMBEDS)
def test_int8_calibration_table_matches_jax(int8_runs, embed):
    """E (B, 3) and layers (B, 5); JAX's key set with and without the
    transposes (none of NN_embed), the values within 1e-4."""
    runs = int8_runs(embed)
    runs.check_tables()
    assert all(k.startswith("CondUnet_0/") for k in runs.tables[1])


@pytest.mark.parametrize("embed", INT8_EMBEDS)
def test_each_conv_of_an_int8_denoise_matches_the_jax_op(int8_runs, embed):
    int8_runs(embed).check_convs()


@pytest.mark.parametrize("what", ["denoise", "ddim"])
@pytest.mark.parametrize("embed", INT8_EMBEDS)
def test_int8_call_lies_within_int8_noise_of_jax(int8_runs, embed, what):
    int8_runs(embed).check_within_int8_noise(what)


@pytest.mark.parametrize("embed", INT8_EMBEDS)
def test_int8_generate_calibrates_on_the_first_batch(pairs, embed):
    """generate --int8, then reverse_norm_hgcal (the pre-embed's GLaM decode
    on the CPU, or the in-model GLaM's in the network): (n, 4, 91) cells."""
    _, cfg, _, _, tm, _ = pairs(embed)
    loader = [(E, np.clip(layers, -1, 1), None)
              for _, E, layers in (_batch(cfg, 2, seed=s) for s in (33, 34))]
    assert check_int8_generate(tm, loader).shape == (4, 4, NCELL)


def test_layer_cascade_generates_hgcal_showers(geom_file):
    """The cascade on HGCal: the layer net conditioned on the three gen-info
    columns, each batch decoded by the process's one pre-embed converter,
    dense and sparse."""
    cfg = hgcal_config(geom_file)
    m = LayerDiffusion(cfg, n_steps=4, device="cpu", generator=torch.Generator().manual_seed(0))
    assert m.layer_net.cond_mlp[0].weight.shape[1] == 3
    _, E, layers = _batch(cfg, 2, seed=18)
    calls = []
    real = th.HGCalConverter.init
    th._converter_cache.clear()
    try:
        th.HGCalConverter.init = lambda self, *a, **k: calls.append(1) or real(self, *a, **k)
        for sparse in (False, True):
            showers, energies = m.generate([(E, layers, None)] * 2, 2, sparse_decoding=sparse,
                                           generator=torch.Generator().manual_seed(1),
                                           rng=np.random.default_rng(2))
            assert showers.shape == (4, 4, NCELL) and energies.shape == (4, 3)
            assert np.isfinite(showers).all() and (showers >= 0).all()
    finally:
        th.HGCalConverter.init = real
    assert len(calls) == 1


def test_trainable_glam_rides_adam_ema_and_checkpoints(geom_file, tmp_path):
    """One Adam step moves the trainable GLaM's matrices only where their
    masks are set; the EMA and final.ckpt hold them, and a model loads them
    back."""
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    cfg = hgcal_config(geom_file, "trainable", EMA_DECAY=0.9, BATCH=2)
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3), cfg,
                       load_data=False, device="cpu")
    t.init_model()
    t.make_optimizer(1e-3)
    keys = {"NN_embed.embeder.mat", "NN_embed.decoder.mat"}
    before = {k: t.model.state_dict()[k].clone() for k in keys}
    assert keys <= set(t.ema_params)
    data, E, layers = (torch.from_numpy(a) for a in _batch(cfg, 2, seed=19))
    assert torch.isfinite(t.train_step(data, E, layers))
    after = t.model.state_dict()
    for k in keys:
        mask = getattr(t.model.net.NN_embed, k.split(".")[1]).mask != 0
        moved = after[k] != before[k]
        assert moved.any() and not (moved & ~mask).any(), k
        assert not torch.equal(t.ema_params[k], before[k])
    t.loader_train, t.loader_val = [], None
    t.config = dict(cfg, MAXEPOCH=0)
    t.train()
    saved = torch.load(tmp_path / f"{cfg['CHECKPOINT_NAME']}_Diffusion" / "final.ckpt",
                       weights_only=True)
    for key in ("params", "ema_params"):
        assert keys <= set(saved[key])
    m = CaloDiffusion(dict(cfg), device="cpu")
    m.load_state_dict(saved["params"])
    for k in keys:
        assert torch.equal(m.state_dict()[k], after[k])


# ---------------------------------------------------------------------------
# the shipped configs at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", ["config_HGCal.json", "config_HGCal_photons.json",
                                    "config_HGCal_pions.json"])
def test_hgcal_configs_build_at_full_width(config, monkeypatch):
    """The three shipped HGCal configs (the GLaM pre-embed: no geometry in
    the model) at full width: 4 input channels, cond 2 + L + 1 + 2, and one
    denoise's 7 attention blocks at chip_smoke's (C, N)."""
    from calodiffusion_tpu_torch.ops import linear_attention as tattn

    with open(os.path.join(CONFIGS, config)) as f:
        cfg = dict(json.load(f), PRECISION="f32")
    name = {"config_HGCal.json": "hgcal", "config_HGCal_photons.json": "hgcal_photons",
            "config_HGCal_pions.json": "hgcal_pions"}[config]
    m = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert m.net.NN_embed is None and m.net.unet.init_conv.weight.shape[1] == 4
    assert m.cond_size == cfg["SHAPE_FINAL"][2] + 4
    blocks = []

    def spy(x, *args, **kw):
        blocks.append((x.shape[2], x.shape[1]))
        return tattn.attention_block_reference(x, *args, **kw)

    monkeypatch.setattr("calodiffusion_tpu_torch.models.nn_modules.fused_attention_block", spy)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, *cfg["SHAPE_PAD"][1:])).astype(np.float32)
    with torch.no_grad():
        out = m.denoise(torch.from_numpy(x), E=torch.full((1, 3), 0.5),
                        sigma=torch.full((1, 1, 1, 1, 1), 0.7),
                        layers=torch.zeros(1, cfg["SHAPE_FINAL"][2] + 1))
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert blocks == chip_smoke.HGCAL_ATTENTION_BLOCKS[name]


def test_chip_smoke_geometries_hold_the_configs_cells(tmp_path):
    """chip_smoke's synthetic geometries: MAX_CELLS cells in every layer of
    SHAPE_FINAL's, every ring inside the R bins; built by the port and
    loaded by the JAX package alike."""
    for name, spec in chip_smoke.HGCAL_DATA.items():
        with open(os.path.join(CONFIGS, spec["config"])) as f:
            cfg = json.load(f)
        path = chip_smoke.hgcal_geom_file(tmp_path, name, cfg)
        g = jh.load_geom(path)
        assert g.nlayers == cfg["SHAPE_FINAL"][2] and g.max_ncell == cfg["MAX_CELLS"]
        assert chip_smoke.hgcal_r_bin(g.ring_map.max()) < cfg["SHAPE_FINAL"][-1]
        with open(path, "rb") as f:
            assert pickle.load(f).nlayers == g.nlayers


def test_k1_is_held_to_the_f32_plain_block_at_hgcal_widths():
    """K1's bf16 reference (ops/tolerances.py): at an HGCal block (C = 96,
    N = 180, chip_smoke's inputs at B = 128) the plain block run in bf16 lies
    beyond K1_TOL of float64, the f32 plain block rounded to bf16 within it;
    in f32 the two references are one."""
    from calodiffusion_tpu_torch.ops import linear_attention as tattn
    from calodiffusion_tpu_torch.ops.tolerances import K1_TOL

    g = torch.Generator().manual_seed(96 + 180)  # chip_smoke.block_inputs(128, 180, 96, ...)
    shapes = [((128, 180, 96), 1.0, 0.0), ((96,), 0.1, 1.0), ((96,), 0.1, 0.0),
              ((96, 96), 0.2, 0.0), ((32, 96), 0.2, 0.0), ((96,), 0.1, 0.0),
              ((96,), 0.1, 1.0), ((96,), 0.1, 0.0)]
    args = [torch.randn(*sh, generator=g) * sc + off for sh, sc, off in shapes]
    assert torch.equal(
        tattn.attention_block_reference_f32(*args), tattn.attention_block_reference(*args))
    for i in (0, 3, 4):
        args[i] = args[i].to(torch.bfloat16)
    exact = tattn.attention_block_reference(*(a.double() for a in args))
    atol, rtol = K1_TOL[torch.bfloat16]

    def excess(got):
        return ((got.double() - exact).abs() - (atol + rtol * exact.abs())).max().item()

    assert excess(tattn.attention_block_reference_f32(*args)) < 0
    assert excess(tattn.attention_block_reference(*args)) > 0
