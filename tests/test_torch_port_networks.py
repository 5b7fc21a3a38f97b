"""The network variants of calodiffusion_tpu_torch against the JAX package on
the CPU, at f32 and tiny widths: the dense FCN shower model (``ResNetDense``
under ``SHOWER_EMBED: "FCN-orig"``) and the ``FCN`` module, ``CondUnet``'s
ConvNext blocks, ``no_time`` and ``REMAT``, and ControlNet's
``ControlledUnet``.  Weights and inputs are made with numpy from a seed and
carried to the port by ``tools/jax_import``; outputs are held within 2e-4
(the weight-transfer bound of docs/DESIGN.md:32) unless a test says
otherwise.  The attention kernels' launches are counted with the kernels'
autograd wiring as on the card and their plain versions in place of the
launches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from calodiffusion_tpu.models import controlnet as jcontrolnet
from calodiffusion_tpu.models import nn_modules as jnn
from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.ops import quant as jquant
from calodiffusion_tpu_torch.models import controlnet, nn_modules
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.ops import linear_attention as tla
from calodiffusion_tpu_torch.tools.jax_import import (
    _Writer,
    controlled_unet_params_to_state_dict,
    module_params_to_state_dict,
    params_to_state_dict,
)
from tests.utils_test import fake_batch, tiny_ds2_config

ATOL = 2e-4  # docs/DESIGN.md:32
WIDTHS = (8, 8, 16, 8)
# a small grid for the U-Nets built here (the XLA CPU depthwise 7^3 conv is
# slow at ds2's 6480 voxels): three levels, phi 16 -> 8 -> 4, so the
# cylindrical wrap of 3 fits each
GRID = (5, 16, 4)
# the CondUnet options of these tests: block and mid attention, sinusoidal
# time and cond stems
UNET = dict(layer_sizes=WIDTHS, cond_dim=16, block_attn=True, mid_attn=True,
            data_shape=GRID, channels=1, compress_Z=True)
UNET_CONFIG = dict(LAYER_SIZE_UNET=list(WIDTHS), BLOCK_ATTN=True, MID_ATTN=True,
                   TIME_EMBED="sin", COND_EMBED="sin")


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


def random_params(shapes, seed):
    """numpy params for a flax tree of ShapeDtypeStructs: kernels at torch's
    default bound, GroupNorm scales near 1, ControlNet's gates in [0.2, 0.8]
    (so that both U-Nets matter)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("kernel", "ds_kernel"):
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if name.startswith("gate_mu_"):
            return rng.uniform(0.2, 0.8, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def unet_inputs(batch, channels=1, seed=0):
    """x channels-last (B, Z, A, R, C), cond (B, 1), time (B,)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, *GRID, channels)).astype(np.float32),
            rng.uniform(0.1, 1.0, (batch, 1)).astype(np.float32),
            rng.uniform(-1.0, 1.0, (batch,)).astype(np.float32))


def ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def jax_unet(seed=0, **kw):
    """A JAX CondUnet (UNET + kw), its random params and the port's copy."""
    net = jnn.CondUnet(**UNET, **kw)
    x, c, t = unet_inputs(1)
    params = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, c, t), seed)
    port = nn_modules.CondUnet(**UNET, **kw)
    port.load_state_dict(params_to_state_dict(params, UNET_CONFIG))
    return net, params, port


class CountedBlocks:
    """K1 and K2 wired as on the card (``_FusedAttentionBlock``: the forward
    launch where the block runs, the backward launch only where autograd
    reaches it), the launches replaced by their plain versions and counted."""

    def __init__(self, monkeypatch):
        self.k1 = self.k2 = 0

        def forward(*a):
            self.k1 += 1
            return tla.attention_block_reference(*a)

        def backward(*a):
            self.k2 += 1
            return tla.attention_block_backward_reference(*a)

        monkeypatch.setattr(tla, "attention_block_forward", forward)
        monkeypatch.setattr(tla, "attention_block_backward", backward)
        monkeypatch.setattr(nn_modules, "fused_attention_block",
                            lambda *a, dim_head=32: tla._FusedAttentionBlock.apply(
                                *a, dim_head, 1e-5))


# -- FCN: the dense shower model and the FCN module -------------------------

def _fcn_cfg(**kw):
    return tiny_ds2_config(SHOWER_EMBED="FCN-orig", NUM_LAYERS_LINEAR=3, COND_SIZE_UNET=16,
                           PRECISION="f32", **kw)


@pytest.fixture(scope="module")
def fcn_pair():
    cfg = _fcn_cfg()
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=1)
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return cfg, jm, params, tm


def _flat_batch(cfg, batch, seed):
    data, E, layers = fake_batch(cfg, batch=batch, seed=seed)
    return data.reshape(batch, -1), E, layers


def test_fcn_orig_denoise_and_loss_match_jax(fcn_pair):
    """"FCN-orig" builds ResNetDense(SHAPE_ORIG[1], NUM_LAYERS_LINEAR, 512)
    on flat showers, as the JAX package: its denoise within 2e-4, its loss
    with injected noise and sigma draws within 1e-5 relative."""
    cfg, jm, params, tm = fcn_pair
    assert isinstance(tm.net.unet, nn_modules.ResNetDense) and tm.net.images is None
    assert tm._data_shape == (6480,) and tm.quantizable_convs() == {}
    x, E, layers = _flat_batch(cfg, 3, seed=2)
    sig = np.asarray([[0.05], [0.7], [5.0]], np.float32)
    want = np.asarray(jm.denoise(params, x, E=E, sigma=sig, layers=layers))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig),
                         layers=torch.from_numpy(layers))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)

    rng = np.random.default_rng(3)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    rnd = rng.standard_normal(3).astype(np.float32)
    want = float(jm.compute_loss(params, jax.random.PRNGKey(0), x, E, noise=noise,
                                 layers=layers, rnd_normal=rnd))
    with torch.no_grad():
        got = tm.compute_loss(*map(torch.from_numpy, (x, E)), noise=torch.from_numpy(noise),
                              layers=torch.from_numpy(layers), rnd_normal=torch.from_numpy(rnd))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_fcn_generates_flat_showers(fcn_pair):
    """generate gives flat showers of SHAPE_ORIG with a SHOWERMAP without
    layers; with ds2's layer map the inverse preprocessing of flat showers
    fails in both packages alike (ROADMAP Queue 3)."""
    cfg, _, _, tm = fcn_pair
    m = CaloDiffusion(_fcn_cfg(SHOWERMAP="logit-norm"), n_steps=10, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    loader = [fake_batch(cfg, batch=2, seed=s)[1:] + (None,) for s in (4, 5)]
    showers, energies = m.generate(loader, 2, generator=torch.Generator().manual_seed(0))
    assert showers.shape == (4, 6480) and energies.shape == (4, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()

    from calodiffusion_tpu.utils import preprocessing as jprep

    flat, E, layers = _flat_batch(cfg, 2, seed=6)
    kw = dict(shape=cfg["SHAPE_FINAL"], config=cfg, emax=cfg["EMAX"], emin=cfg["EMIN"],
              layerE=layers, logE=True, binning_file="", max_deposit=cfg["MAXDEP"],
              showerMap=cfg["SHOWERMAP"], dataset_num=2, orig_shape=True,
              ecut=float(cfg["ECUT"]))
    with pytest.raises(np.exceptions.AxisError):
        jprep.reverse_norm(flat.copy(), E, **kw)
    with pytest.raises(np.exceptions.AxisError):
        tm.reverse_norm(flat.copy(), E, layers)


@pytest.mark.parametrize("embed", [True, False], ids=["sinusoidal", "linear"])
def test_fcn_module_matches_jax(embed):
    """The FCN module alone (no config builds it), its stems sinusoidal or
    linear: forward within 2e-4."""
    kw = dict(dim_in=40, num_layers=4, cond_emb_dim=16, time_embed=embed, cond_embed=embed)
    net = jnn.FCN(**kw)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, (3, 1)).astype(np.float32)
    t = rng.uniform(-1.0, 1.0, (3,)).astype(np.float32)
    params = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, c, t), seed=7)
    want = np.asarray(net.apply(params, x, c, t))
    port = nn_modules.FCN(**kw)
    port.load_state_dict(module_params_to_state_dict(params, "FCN"))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (x, c, t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# -- ConvNext blocks, no_time ---------------------------------------------------

@pytest.mark.parametrize("cylindrical", [True, False], ids=["cylindrical", "zero_pad"])
def test_convnext_unet_forward_and_input_gradient_match_jax(cylindrical):
    """CondUnet(use_convnext=True): the output and the gradient of a fixed
    projection of it with respect to the input, within 2e-4."""
    net, params, port = jax_unet(seed=8, use_convnext=True, cylindrical=cylindrical)
    assert isinstance(port.downs[0][0], nn_modules.ConvNextBlock)
    x, c, t = unet_inputs(2, seed=9)
    proj = np.random.default_rng(10).standard_normal((2, *GRID, 1)).astype(np.float32)

    def f(x):
        out = net.apply(params, x, c, t)
        return jnp.sum(out * proj), out

    (_, want), want_dx = jax.jit(jax.value_and_grad(f, has_aux=True))(x)
    xt = ncdhw(x).requires_grad_(True)
    out = port(xt, torch.from_numpy(c), torch.from_numpy(t))
    (out * ncdhw(proj)).sum().backward()
    np.testing.assert_allclose(np.moveaxis(out.detach().numpy(), 1, -1), np.asarray(want),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.moveaxis(xt.grad.numpy(), 1, -1), np.asarray(want_dx),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("conditioned", [True, False], ids=["cond", "no_cond"])
def test_convnext_block_matches_jax(conditioned):
    """One ConvNextBlock (8 -> 16 channels: the residual conv), with its
    conditioning Dense and without (the U-Net's last block): within 2e-4."""
    block = jnn.ConvNextBlock(features=16, cond_emb_dim=12 if conditioned else None,
                              cylindrical=True)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 8, 6, 8)).astype(np.float32)
    cond = rng.standard_normal((2, 12)).astype(np.float32) if conditioned else None
    params = random_params(jax.eval_shape(block.init, jax.random.PRNGKey(0), x, cond), seed=12)
    want = np.asarray(block.apply(params, x, cond))
    w = _Writer(params["params"])
    w.convnext_block([], "b")
    port = nn_modules.ConvNextBlock(8, 16, 12 if conditioned else None, cylindrical=True)
    port.load_state_dict({k[2:]: v for k, v in w.sd.items()})
    with torch.no_grad():
        got = port(ncdhw(x), None if cond is None else torch.from_numpy(cond))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=0, atol=ATOL)


def test_no_time_unet_matches_jax():
    """no_time: no time MLP, the cond MLP out to cond_dim (JAX
    nn_modules.py:727-738): within 2e-4 and no time_mlp weights."""
    net, params, port = jax_unet(seed=13, no_time=True)
    assert port.time_mlp is None and not any(k.startswith("time_mlp") for k in port.state_dict())
    x, c, t = unet_inputs(2, seed=14)
    want = np.asarray(jax.jit(net.apply)(params, x, c, t))
    with torch.no_grad():
        got = port(ncdhw(x), torch.from_numpy(c))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=0, atol=ATOL)


def test_quantizable_conv_paths_match_jax_calibration_keys():
    """The int8 paths of a ConvNext and a REMAT U-Net are the JAX
    calibration table's keys (Conv3d_0/1/2 inside ConvNextBlock_N,
    CheckpointResnetBlock_N under remat)."""
    for kw in (dict(use_convnext=True), dict(remat=True),
               dict(use_convnext=True, remat=True)):
        net = jnn.CondUnet(**UNET, **kw)
        x, c, t = unet_inputs(1)
        params = jax.eval_shape(net.init, jax.random.PRNGKey(0), x, c, t)
        with jquant.calibration():  # the sown statistics' shapes name the convs
            _, aux = jax.eval_shape(
                lambda p: net.apply(p, x, c, t, mutable=[jquant.STATS_COL]), params)
        want = {"CondUnet_0/" + "/".join(k[:-1])
                for k in traverse_util.flatten_dict(aux[jquant.STATS_COL])}
        # the JAX package quantizes the upsampling transposes only under
        # CALODIFF_INT8_TRANSPOSE=1
        got = {k for k in nn_modules.quantizable_convs(nn_modules.CondUnet(**UNET, **kw))
               if "Conv3dTranspose" not in k}
        assert got == want, (kw, sorted(got ^ want))


# -- REMAT -----------------------------------------------------------------------

@pytest.mark.parametrize("convnext", [False, True], ids=["resnet", "convnext"])
def test_remat_equals_plain_bit_for_bit(convnext, monkeypatch):
    """A REMAT train step's loss and every gradient equal the plain step's
    bit for bit from the same weights, batch, noise and sigma draws; the
    attention blocks are outside the recomputed blocks, so K1 runs 7 times a
    step and K2 7 times, both ways."""
    counts = CountedBlocks(monkeypatch)
    opts = dict(use_convnext=True) if convnext else None
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=list(WIDTHS), COND_SIZE_UNET=16, BLOCK_ATTN=True,
                          MID_ATTN=True, PRECISION="f32")
    data, E, layers = fake_batch(cfg, batch=2, seed=15)
    rng = np.random.default_rng(16)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)
    results = []
    for remat in (False, True):
        m = CaloDiffusion(dict(cfg, REMAT=remat), n_steps=10, device="cpu",
                          generator=torch.Generator().manual_seed(0), unet_options=opts)
        assert m.net.unet.remat is remat
        counts.k1 = counts.k2 = 0
        loss = m.compute_loss(*map(torch.from_numpy, (data, E)), noise=torch.from_numpy(noise),
                              layers=torch.from_numpy(layers), rnd_normal=torch.from_numpy(rnd))
        loss.backward()
        assert (counts.k1, counts.k2) == (7, 7)
        results.append((loss.detach(), {k: p.grad.clone() for k, p in m.named_parameters()}))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_remat_tree_from_jax_gives_jax_denoise():
    """A REMAT-initialised JAX tree (CheckpointResnetBlock_N) carried across
    gives JAX's denoise within 2e-4."""
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=list(WIDTHS), COND_SIZE_UNET=16, BLOCK_ATTN=True,
                          MID_ATTN=True, PRECISION="f32", REMAT=True)
    jm = JaxModel(dict(cfg), n_steps=10)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=17)
    assert "CheckpointResnetBlock_0" in params["params"]["CondUnet_0"]
    tm = CaloDiffusion(dict(cfg), n_steps=10, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    x, E, layers = fake_batch(cfg, batch=2, seed=18)
    sig = np.full((2, 1, 1, 1, 1), 0.7, np.float32)
    want = np.asarray(jax.jit(jm.denoise)(params, x, E=E, sigma=sig, layers=layers))
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), E=torch.from_numpy(E), sigma=torch.from_numpy(sig),
                         layers=torch.from_numpy(layers))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


# -- ControlNet ------------------------------------------------------------------

@pytest.fixture(scope="module")
def controlled():
    net = jcontrolnet.ControlledUnet(unet_kwargs=dict(UNET, cylindrical=True))
    x, c, t = unet_inputs(1)
    params = random_params(jax.eval_shape(net.init, jax.random.PRNGKey(0), x, x, c, t), seed=19)
    port = controlnet.ControlledUnet(dict(UNET, cylindrical=True))
    port.load_state_dict(controlled_unet_params_to_state_dict(params, UNET_CONFIG))
    return net, params, port


def test_controlled_unet_matches_jax(controlled):
    net, params, port = controlled
    x, c, t = unet_inputs(2, seed=20)
    xc = np.random.default_rng(21).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jax.jit(net.apply)(params, x, xc, c, t))
    with torch.no_grad():
        got = port(ncdhw(x), ncdhw(xc), torch.from_numpy(c), torch.from_numpy(t))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=0, atol=ATOL)
    assert [g.dtype for g in port.gates()] == [torch.float32] * 4


def test_controlnet_gates_start_at_jax_init():
    """The gates' initial values are the JAX init's (1e-6 in f32), one a
    level and one for the middle; a one-level U-Net keeps the init cheap."""
    kw = dict(layer_sizes=(8, 8), cond_dim=16, data_shape=(2, 4, 2), channels=1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 2, 4, 2, 1)).astype(np.float32)
    c, t = np.ones((1, 1), np.float32), np.ones((1,), np.float32)
    params = jax.jit(jcontrolnet.ControlledUnet(unet_kwargs=kw).init)(
        jax.random.PRNGKey(0), x, x, c, t)["params"]
    gates = controlnet.ControlledUnet(kw).gates()
    assert len(gates) == 2 == sum(k.startswith("gate_mu_") for k in params)
    for i, g in enumerate(gates):
        assert g.dtype == torch.float32 and g.item() == float(params[f"gate_mu_{i}"])
        assert g.item() == float(np.float32(1e-6))


def test_frozen_set_equals_base_param_filter(controlled):
    """freeze_base freezes exactly the parameters JAX's base_param_filter
    names: a tree whose filtered leaves are 1 and others 0, carried
    across, is 1 exactly on the port's frozen parameters."""
    _, params, _ = controlled
    flat = traverse_util.flatten_dict(params["params"])
    marked = traverse_util.unflatten_dict({
        k: np.full(np.shape(v), float(jcontrolnet.base_param_filter(k, v)), np.float32)
        for k, v in flat.items()})
    sd = controlled_unet_params_to_state_dict({"params": marked}, UNET_CONFIG)
    net = controlnet.ControlledUnet(dict(UNET, cylindrical=True))
    trained = controlnet.freeze_base(net)
    frozen = {k for k, p in net.named_parameters() if not p.requires_grad}
    assert frozen == {k for k, v in sd.items() if bool((v == 1).all())}
    assert set(trained) == {k for k, v in sd.items() if bool((v == 0).all())}
    assert {f"gate_mu_{i}" for i in range(4)} <= set(trained)


def test_controlnet_launch_counts_with_the_base_frozen(monkeypatch):
    """K1 11 times a forward (the control U-Net's 3 down and middle blocks,
    the base's 7); with the base frozen K2 7 times a step: the control's 4
    and the base's 3 up-path blocks (its down path and middle need no
    backward).  The gradients reach the control U-Net and every gate."""
    counts = CountedBlocks(monkeypatch)
    port = controlnet.ControlledUnet(dict(UNET, cylindrical=True))
    controlnet.freeze_base(port)
    x, c, t = unet_inputs(2, seed=22)
    out = port(ncdhw(x), ncdhw(x * 0.5), torch.from_numpy(c), torch.from_numpy(t))
    assert (counts.k1, counts.k2) == (11, 0)
    out.square().mean().backward()
    assert counts.k2 == 7
    assert all(p.grad is None for k, p in port.named_parameters() if k.startswith("model."))
    assert all(g.grad is not None for g in port.gates())
    assert port.control_model.init_conv.weight.grad is not None
