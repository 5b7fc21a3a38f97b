"""calodiffusion_tpu_torch's W8A8 int8 sampling against the JAX package's
(``calodiffusion_tpu/ops/quant.py``) on the CPU, where the port runs Q1's
plain version: the quantization primitives bit for bit, the int8 conv and
the int8 transpose (equal int8 values and s32 sums, outputs within one ulp),
the flax path of every quantizable conv, the calibration, the exclusion
fence, each conv of an int8 denoise against the JAX op on its input, the
denoise, an 8-step sample, the W8A16 mode, int8 off and training, and the
cascade.  The JAX package runs int8 off the TPU under
``CALODIFF_INT8=force``, as its own tests do.  Weights, inputs and noise are
made with numpy from a seed and given to both packages; the tolerances and
their reasons are in ``ops/tolerances.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.models.layerdiffusion import LayerDiffusion as JaxLayer
from calodiffusion_tpu.ops import quant as jq
from calodiffusion_tpu.ops.conv import DIMS, wrap_pad_phi
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
from calodiffusion_tpu_torch.ops import conv as tconv
from calodiffusion_tpu_torch.ops import int8_conv
from calodiffusion_tpu_torch.ops import quant as tq
from calodiffusion_tpu_torch.ops.tolerances import INT8_NOISE_RMS, Q1_ULPS
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import (layer_params_to_state_dict,
                                                       params_to_state_dict)
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags, load_config
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# the weight-transfer bound of docs/DESIGN.md:32: W8A16 runs no activation quantization
WEIGHT_ONLY_ATOL = 2e-4
CALIB_RTOL = 1e-5
B = 4  # the batch of the network calls
N_SIGMAS = 3


@pytest.fixture(autouse=True)
def force_int8(monkeypatch):
    monkeypatch.setenv("CALODIFF_INT8", "force")
    monkeypatch.delenv("CALODIFF_INT8_TRANSPOSE", raising=False)


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


def _to_t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def assert_within_ulps(got, want, dtype, ulps=Q1_ULPS):
    """|got - want| <= ulps units in the last place of want in ``dtype``."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    mant = 23 if dtype == torch.float32 else 7
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - mant)
    assert g.shape == w.shape
    assert (np.abs(g - w) <= ulps * ulp).all(), np.abs(g - w).max()


def rms_rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(b ** 2)))


# ---------------------------------------------------------------------------
# the primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_weight_per_cout_matches_jax(dtype):
    """Per-output-channel int8 of the weights cast to the layer's dtype, the
    port's torch layout (Cout, Cin, k..) against flax's (k.., Cin, Cout)."""
    td, jd = DTYPES[dtype]
    w = np.random.default_rng(0).standard_normal((3, 3, 3, 8, 16)).astype(np.float32)
    w[..., 3] = 0.0  # a channel of zeros takes the 1e-12 floor
    wq_j, sw_j = jq.quantize_weight_per_cout(jnp.asarray(w).astype(jd))
    wq_t, sw_t = tq.quantize_weight_per_cout(_to_t(w.transpose(4, 3, 0, 1, 2), td))
    assert wq_t.dtype == torch.int8 and sw_t.dtype == torch.float32
    np.testing.assert_array_equal(wq_t.numpy(), np.asarray(wq_j).transpose(4, 3, 0, 1, 2))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(sw_j))
    deq_j = np.asarray(jq.dequantized_weight(jnp.asarray(w).astype(jd)))
    deq_t = tq.dequantized_weight(_to_t(w.transpose(4, 3, 0, 1, 2), td))
    np.testing.assert_array_equal(deq_t.numpy(), deq_j.transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_act_matches_jax(dtype):
    """The JAX test's saturation cases (test_quant.py:40-45), ties at half a
    step (round half to even) and random values, in the activation dtype."""
    td, jd = DTYPES[dtype]
    sat = np.array([-10.0, -1.0, 0.0, 0.5, 10.0], np.float32)
    np.testing.assert_array_equal(tq.quantize_act(_to_t(sat), 1.0 / 127.0).numpy(),
                                  [-127, -127, 0, 64, 127])
    rng = np.random.default_rng(1)
    x = np.concatenate([sat, np.arange(-8, 8) + 0.5, 3 * rng.standard_normal(400)]
                       ).astype(np.float32)
    for scale in (1.0, 0.03, 1.0 / 127.0):
        want = np.asarray(jq.quantize_act(jnp.asarray(x).astype(jd), scale))
        got = tq.quantize_act(_to_t(x, td), scale)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


# the JAX test's cases (test_quant.py:401-415) and ResnetBlock_1/ against
# ResnetBlock_10..14
PATH_CASES = [
    ("CondUnet_0/Conv3d_1/kernel", "CondUnet_0/Conv3d_1", True),
    ("CondUnet_0/Conv3d_10/kernel", "CondUnet_0/Conv3d_1", False),
    ("CondUnet_0/Conv3d_12", "Conv3d_1", False),
    ("CondUnet_0/ResnetBlock_0/Block_1/Conv3d_0", "ResnetBlock_0/", True),
    ("CondUnet_0/ResnetBlock_01/Block_1", "ResnetBlock_0/", False),
    ("a/b/c/d", "b/c", True),
    ("a/b/x/c", "b/c", False),
    ("a/b", "", False),
] + [(f"CondUnet_0/ResnetBlock_{i}/Block_0/Conv3d_0", "ResnetBlock_1/", i == 1)
     for i in (1, 10, 11, 14)]


@pytest.mark.parametrize("path,pattern,matches", PATH_CASES)
def test_path_matches_equals_jax(path, pattern, matches):
    assert tq.path_matches(path, pattern) == jq.path_matches(path, pattern) == matches


def test_scales_and_merge_equal_jax():
    """The JAX test's stats tree (test_quant.py:176-207) with a margin: the
    port's {path: absmax} -> scales equals scales_from_stats, and merge_stats
    takes the max alike."""
    stats = {"CondUnet_0": {"Conv3d_3": {"absmax": (jnp.asarray(12.7),)},
                            "ResnetBlock_0": {"Conv3d_0": {"absmax": jnp.asarray(2.54)}},
                            "Conv3d_4": {"absmax": (jnp.asarray(0.0),)}}}
    absmax = {"CondUnet_0/Conv3d_3": np.float32(12.7),
              "CondUnet_0/ResnetBlock_0/Conv3d_0": np.float32(2.54),
              "CondUnet_0/Conv3d_4": np.float32(0.0)}
    for margin in (1.0, 1.1):
        want = jq.scales_from_stats(stats, margin=margin)
        assert tq.scales_from_absmax(absmax, margin) == want
    other = {"CondUnet_0/Conv3d_3": 0.2, "CondUnet_0/Conv3d_9": 0.01}
    assert tq.merge_stats(want, other) == jq.merge_stats(want, other)


def test_int8_gating(monkeypatch):
    """The port runs int8 wherever QUANT_INT8 is set (a departure: the JAX
    package only on a TPU or under force); CALODIFF_INT8=0 turns it off and
    CALODIFF_INT8_TRANSPOSE=1 opts the transposes in, as in JAX."""
    monkeypatch.delenv("CALODIFF_INT8")
    assert tq.int8_allowed()
    monkeypatch.setenv("CALODIFF_INT8", "0")
    assert not tq.int8_allowed() and not jq.int8_allowed()
    assert not tq.transpose_allowed()
    monkeypatch.setenv("CALODIFF_INT8_TRANSPOSE", "1")
    assert tq.transpose_allowed()


# ---------------------------------------------------------------------------
# the int8 convolutions
# ---------------------------------------------------------------------------

# (kernel, stride, padding): a block conv, a residual 1x1, the downsample
CONV_KINDS = {"3x3x3": ((3, 3, 3), 1, 1), "1x1": ((1, 1, 1), 1, 0),
              "down": ((3, 4, 4), (2, 2, 2), 1)}


def _conv_inputs(kernel, seed, cin=12, cout=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, 8, 6, cin)).astype(np.float32)  # NDHWC
    w = (0.1 * rng.standard_normal((*kernel, cin, cout))).astype(np.float32)
    b = (0.01 * rng.standard_normal(cout)).astype(np.float32)
    return x, w, b, float(np.abs(x).max()) / 127.0 * 0.8  # 0.8: a saturated tail


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cyl", [False, True], ids=["zero", "cylindrical"])
@pytest.mark.parametrize("kind", list(CONV_KINDS))
def test_int8_conv3d_matches_jax(kind, cyl, dtype):
    """The int8 values and the s32 sums equal, the outputs within one ulp;
    Cin 12, so K is no multiple of 32."""
    td, jd = DTYPES[dtype]
    kernel, stride, pad = CONV_KINDS[kind]
    x, w, b, sx = _conv_inputs(kernel, seed=len(kind) + cyl)
    xj, wj, bj = (jnp.asarray(a).astype(jd) for a in (x, w, b))
    want = jq.int8_conv3d(xj, wj, bj, sx, stride=stride, padding=pad, cylindrical=cyl)
    xt = _to_t(x.transpose(0, 4, 1, 2, 3), td)
    wt = _to_t(w.transpose(4, 3, 0, 1, 2), td)
    got = tq.int8_conv3d(xt, wt, _to_t(b, td), sx, stride, pad, cyl)
    assert got.dtype == td
    assert_within_ulps(got.permute(0, 2, 3, 4, 1), want, td)

    xq_j = jq.quantize_act(xj, sx)
    np.testing.assert_array_equal(tq.quantize_act(xt, sx).permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(xq_j))
    p = (pad,) * 3 if isinstance(pad, int) else pad
    wq_j, _ = jq.quantize_weight_per_cout(wj)
    xq_p = wrap_pad_phi(xq_j, p[1]) if cyl else xq_j
    pads = [(p[0],) * 2, (0, 0) if cyl else (p[1],) * 2, (p[2],) * 2]
    sums_j = jax.lax.conv_general_dilated(xq_p, wq_j, window_strides=tconv.triple(stride),
                                          padding=pads, dimension_numbers=DIMS,
                                          preferred_element_type=jnp.int32)
    wq_t, _ = tq.quantize_weight_per_cout(wt)
    sums_t = int8_conv.int8_sums(xt, wq_t, tq.inv_scale(sx), stride, pad, cyl)
    np.testing.assert_array_equal(sums_t.permute(0, 2, 3, 4, 1).numpy(), np.asarray(sums_j))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("cyl", [False, True], ids=["zero", "cylindrical"])
@pytest.mark.parametrize("stride,out_pad", [((1, 2, 2), 0), ((2, 2, 2), (0, 1, 1))],
                         ids=["s122", "s222-op011"])
def test_int8_conv3d_transpose_matches_jax(stride, out_pad, cyl, dtype):
    """The subpixel decomposition with per-(phase, cout) weight scales, the
    bias after the crop: within one ulp of the JAX package's."""
    td, jd = DTYPES[dtype]
    rng = np.random.default_rng(sum(stride) + cyl)
    x = rng.standard_normal((2, 5, 8, 6, 4)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 4, 4, 4, 8))).astype(np.float32)
    b = (0.01 * rng.standard_normal(8)).astype(np.float32)
    sx = float(np.abs(x).max()) / 127.0
    want = jq.int8_conv3d_transpose(*(jnp.asarray(a).astype(jd) for a in (x, w, b)), sx,
                                    stride=stride, padding=1, output_padding=out_pad,
                                    cylindrical=cyl)
    got = tconv.int8_conv3d_transpose(_to_t(x.transpose(0, 4, 1, 2, 3), td),
                                      _to_t(w.transpose(3, 4, 0, 1, 2), td), _to_t(b, td), sx,
                                      stride, 1, out_pad, cyl)
    assert got.dtype == td
    assert_within_ulps(got.permute(0, 2, 3, 4, 1), want, td)


def test_int8_conv3d_transpose_stride_one_is_the_float_transpose():
    rng = np.random.default_rng(5)
    x = _to_t(rng.standard_normal((1, 4, 5, 6, 4)))
    w = _to_t(0.1 * rng.standard_normal((4, 8, 3, 3, 3)))
    b = _to_t(0.01 * rng.standard_normal(8))
    got = tconv.int8_conv3d_transpose(x, w, b, 0.02, 1, 1, 0, True)
    assert torch.equal(got, tconv.cylindrical_conv3d_transpose(x, w, b, 1, 1, 0))


# ---------------------------------------------------------------------------
# the model: names, calibration, the exclusion fence
# ---------------------------------------------------------------------------

def _pair(cfg):
    jm = JaxModel(dict(cfg), n_steps=8)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    tm = CaloDiffusion(dict(cfg), n_steps=8, device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    """tiny_ds2 (widths 16, f32) in both packages, with QUANT_INT8."""
    cfg = tiny_ds2_config(PRECISION="f32", QUANT_INT8=True)
    return (cfg, *_pair(cfg))


def _calibrate_both(jm, params, tm, seed, n_sigmas=N_SIGMAS, batch=B):
    """Both packages' tables from the same unit noise per sigma, E and
    layers (the JAX model's noise_generation hands it the same arrays)."""
    cfg = tm.config
    rng = np.random.default_rng(seed)
    noise = [rng.standard_normal((batch, *tm._data_shape)).astype(np.float32)
             for _ in range(n_sigmas)]
    _, E, layers = fake_batch(cfg, batch=batch, seed=seed)
    it = iter(noise)
    jm.noise_generation = lambda key, shape: jnp.asarray(next(it))
    try:
        want = jm.prepare_int8(params, n_sigmas=n_sigmas, batch=batch, E=E, layers=layers)
    finally:
        del jm.noise_generation
    got = tm.prepare_int8(n_sigmas=n_sigmas, E=E, layers=layers, noise=noise)
    return got, want


@pytest.fixture(scope="module")
def tables(pair):
    """(port's, JAX's) table of pair's model from the same inputs."""
    cfg, jm, params, tm = pair
    return _calibrate_both(jm, params, tm, seed=1)


def test_calibration_matches_jax(tables):
    """The abs-max table from the same inputs within 1e-5 relative (the f32
    activations differ by the orders of their sums); the same keys."""
    got, want = tables
    assert set(got) == set(want) and len(got) == 35
    for k, v in want.items():
        assert abs(got[k] / v - 1) <= CALIB_RTOL, (k, got[k], v)


def test_conv_names_equal_the_jax_table_with_residuals_and_transposes(monkeypatch):
    """Widths [8, 8, 16, 8] put residual 1x1 convs in the down path too; with
    CALODIFF_INT8_TRANSPOSE=1 both tables gain the upsampling transposes."""
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16, PRECISION="f32",
                          QUANT_INT8=True)
    jm, params, tm = _pair(cfg)
    monkeypatch.setenv("CALODIFF_INT8_TRANSPOSE", "1")
    got, want = _calibrate_both(jm, params, tm, seed=2, n_sigmas=1, batch=1)
    assert set(got) == set(want) == set(tm.quantizable_convs())
    assert {k for k in got if "Transpose" in k} == {"CondUnet_0/Conv3dTranspose_0",
                                                    "CondUnet_0/Conv3dTranspose_1"}
    assert {k for k in got if k.endswith("ResnetBlock_2/Conv3d_0")}
    monkeypatch.delenv("CALODIFF_INT8_TRANSPOSE")
    assert set(tm.quantizable_convs()) == {k for k in want if "Transpose" not in k}


def test_ds2_full_width_has_the_36_convs_of_the_jax_table():
    """configs/config_dataset2.json: the 30 Block convs, the residual convs
    of ResnetBlock_{2,4,10,12} and the two downsampling convs, as a JAX
    calibration of that config names them."""
    tm = CaloDiffusion(load_config("configs/config_dataset2.json"), device="cpu")
    want = {f"CondUnet_0/ResnetBlock_{i}/Block_{j}/Conv3d_0" for i in range(15) for j in (0, 1)}
    want |= {f"CondUnet_0/ResnetBlock_{i}/Conv3d_0" for i in (2, 4, 10, 12)}
    want |= {"CondUnet_0/Conv3d_0", "CondUnet_0/Conv3d_1"}
    assert set(tm.quantizable_convs()) == want and len(want) == 36


def test_exclude_drops_the_same_convs(pair, capsys):
    cfg, jm, params, tm = pair
    fence = ["ResnetBlock_1/", "CondUnet_0/Conv3d_1", "Block_1/Conv3d_0"]
    for m in (jm, tm):
        m.config["QUANT_INT8_EXCLUDE"] = fence
    try:
        got, want = _calibrate_both(jm, params, tm, seed=3, n_sigmas=1, batch=1)
    finally:
        for m in (jm, tm):
            del m.config["QUANT_INT8_EXCLUDE"]
    assert set(got) == set(want) and len(got) == 35 - 17
    out = capsys.readouterr().out
    assert out.count(f"int8: excluding 17 convs matching {fence}") == 2


# ---------------------------------------------------------------------------
# the int8 network: each conv, the denoise, a sample
# ---------------------------------------------------------------------------

_JAX_DENOISE = {}  # one trace for each (model, scale table)


def _denoise_jax(jm, params, x, E, sigma, layers, table=None):
    key = (id(jm), None if table is None else tuple(sorted(table.items())))
    if key not in _JAX_DENOISE:
        _JAX_DENOISE[key] = jax.jit(lambda p, x, E, s, lay: jm.denoise(p, x, E=E, sigma=s,
                                                                       layers=lay))
    with jq.quant_scales(table):  # traced on its first call, inside the table's scope
        return np.asarray(_JAX_DENOISE[key](params, x, E, sigma, layers))


def _denoise_port(tm, x, E, sigma, layers, table=None):
    tm._int8_scales = table
    enabled = table is not None
    prev = tm.config["QUANT_INT8"]
    tm.config["QUANT_INT8"] = enabled
    try:
        with torch.no_grad(), tm.int8_scope():
            return tm.denoise(_to_t(x), E=_to_t(E), sigma=_to_t(sigma), layers=_to_t(layers))
    finally:
        tm.config["QUANT_INT8"] = prev


def _flax_conv(params, path):
    node = params["params"]
    for k in path.split("/"):
        node = node[k]
    return node["kernel"], node["bias"]


def test_each_conv_of_an_int8_denoise_matches_the_jax_op(pair, tables):
    """Every quantized conv of one int8 denoise, on the input it met there:
    its output within one ulp of the JAX package's int8_conv3d with the
    flax weights of its path, the table's scale and its site's geometry
    (JAX nn_modules.py: Block 3x3x3 pad 1, residual 1x1, downsample (3, 4,
    4) stride (2, 2, 2) pad 1; cylindrical)."""
    cfg, jm, params, tm = pair
    table = tables[1]
    x, E, layers = fake_batch(cfg, batch=2, seed=4)
    seen = {}
    convs = tm.quantizable_convs()
    hooks = [c.register_forward_hook(lambda m, a, out, p=p: seen.__setitem__(p, (a[0], out)))
             for p, c in convs.items()]
    try:
        _denoise_port(tm, x, E, np.full((2, 1, 1, 1, 1), 0.7, np.float32), layers, table)
    finally:
        for h in hooks:
            h.remove()
    assert set(seen) == set(table)
    for path, (inp, out) in seen.items():
        kind = ("down" if path.count("/") == 1 else
                "3x3x3" if "/Block_" in path else "1x1")
        _, stride, pad = CONV_KINDS[kind]
        kernel, bias = _flax_conv(params, path)
        want = jq.int8_conv3d(jnp.asarray(inp.permute(0, 2, 3, 4, 1).numpy()),
                              jnp.asarray(kernel), jnp.asarray(bias), table[path],
                              stride=stride, padding=pad, cylindrical=True)
        assert_within_ulps(out.permute(0, 2, 3, 4, 1), want, torch.float32)


@pytest.mark.parametrize("sigma", [0.05, 0.7, 5.0])
def test_int8_denoise_lies_within_int8_noise_of_jax(pair, tables, sigma):
    """Given the JAX table, the port's int8 denoise differs from JAX's by int8
    noise alone (INT8_NOISE_RMS; elementwise agreement is out of reach, see
    ops/tolerances.py), its own int8-vs-float gap is JAX's within that
    factor, and the float denoises agree within 2e-4."""
    cfg, jm, params, tm = pair
    table = tables[1]
    x, E, layers = fake_batch(cfg, batch=B, seed=5)
    sig = np.full((B, 1, 1, 1, 1), sigma, np.float32)
    jf, jq8 = (_denoise_jax(jm, params, x, E, sig, layers, t) for t in (None, table))
    tf, tq8 = (_denoise_port(tm, x, E, sig, layers, t) for t in (None, table))
    np.testing.assert_allclose(_np(tf), jf, rtol=0, atol=WEIGHT_ONLY_ATOL)
    gap = rms_rel(jq8, jf)
    assert gap > 0
    assert rms_rel(tq8, jq8) <= INT8_NOISE_RMS * gap
    assert gap / INT8_NOISE_RMS <= rms_rel(tq8, tf) <= INT8_NOISE_RMS * gap


def test_weight_only_denoise_matches_jax(pair, tables):
    """A table of WEIGHT_ONLY runs the int8-dequantized weights with float
    activations: no activation rounding, so the weight-transfer bound."""
    cfg, jm, params, tm = pair
    table = {k: jq.WEIGHT_ONLY for k in tables[1]}
    x, E, layers = fake_batch(cfg, batch=B, seed=6)
    sig = np.full((B, 1, 1, 1, 1), 0.7, np.float32)
    want = _denoise_jax(jm, params, x, E, sig, layers, table)
    got = _denoise_port(tm, x, E, sig, layers, table)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=WEIGHT_ONLY_ATOL)
    assert rms_rel(want, _denoise_jax(jm, params, x, E, sig, layers)) > 1e-4


def test_int8_ddim_sample_lies_within_int8_noise_of_jax(pair, tables):
    """8 DDim steps from the same start: as the denoise test."""
    cfg, jm, params, tm = pair
    table = tables[1]
    start, E, layers = fake_batch(cfg, batch=B, seed=7)
    args = (jnp.asarray(start), jnp.asarray(E), jnp.asarray(layers), 8, 0,
            jax.random.PRNGKey(0), False)
    js, ts = jax_get_sampler("DDim")(cfg), get_sampler("DDim")(cfg)
    jf = np.asarray(js(jm, params, *args))
    jm._int8_scales = table
    with jm._int8_ctx(params):
        jq8 = np.asarray(js(jm, params, *args))
    targs = (_to_t(start), _to_t(E), _to_t(layers), 8, 0, None, False)
    with torch.no_grad():
        tf = ts(tm, *targs)
        tm._int8_scales = table
        with tm.int8_scope():
            tq8 = ts(tm, *targs)
    gap = rms_rel(jq8, jf)
    assert rms_rel(tq8, jq8) <= INT8_NOISE_RMS * gap
    assert gap / INT8_NOISE_RMS <= rms_rel(tq8, tf) <= INT8_NOISE_RMS * gap


def _counting(monkeypatch):
    """Count the plain version's calls (the CPU's int8 convs)."""
    calls = []
    ref = int8_conv.int8_conv3d_reference

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return ref(*a, **kw)

    monkeypatch.setattr(int8_conv, "int8_conv3d_reference", counted)
    return calls


def test_sample_runs_every_table_conv_int8_and_off_is_bit_identical(pair, tables, monkeypatch):
    """With QUANT_INT8 each evaluation runs the 35 convs of the table int8;
    without it (a table set or not) the float path's showers bit for bit."""
    cfg, jm, params, tm = pair
    calls = _counting(monkeypatch)
    _, E, layers = fake_batch(cfg, batch=2, seed=8)
    E, layers = _to_t(E), _to_t(layers)

    def sample(int8):
        tm.config["QUANT_INT8"] = int8
        try:
            return tm.sample(E, layers, 3, torch.Generator().manual_seed(9))
        finally:
            tm.config["QUANT_INT8"] = True

    tm._int8_scales = None
    plain = sample(False)
    assert calls == []
    tm._int8_scales = dict(tables[1])
    assert torch.equal(sample(False), plain) and calls == []
    q = sample(True)
    assert len(calls) == 3 * 35 and torch.isfinite(q).all() and not torch.equal(q, plain)
    assert all(c.int8_scale is None for c in tm.quantizable_convs().values())


def test_training_never_runs_int8(pair, tables, monkeypatch, tmp_path):
    """compute_loss and a trainer step call neither Q1 nor its plain version,
    with QUANT_INT8 set and a table on the model; the loss is the float one."""
    cfg, jm, params, tm = pair
    calls = _counting(monkeypatch)
    data, E, layers = (_to_t(a) for a in fake_batch(cfg, batch=2, seed=10))
    noise = _to_t(np.random.default_rng(11).standard_normal(data.shape))
    rnd = _to_t(np.random.default_rng(12).standard_normal((2, 1, 1, 1, 1)))
    tm._int8_scales = None
    want = tm.compute_loss(data, E, noise=noise, layers=layers, rnd_normal=rnd)
    tm._int8_scales = dict(tables[1])
    got = tm.compute_loss(data, E, noise=noise, layers=layers, rnd_normal=rnd)
    assert torch.equal(got, want)

    trainer = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3), dict(cfg),
                             load_data=False, device="cpu")
    trainer.init_model()
    trainer.make_optimizer(1e-3)
    trainer.model._int8_scales = dict(tables[1])
    loss = trainer.train_step(data, E, layers)
    assert torch.isfinite(torch.as_tensor(loss)) and calls == []


def test_generate_calibrates_on_the_first_batch(pair):
    """generate() with QUANT_INT8 and no table calibrates one on the first
    batch's conditioning (35 convs) and gives finite showers."""
    cfg, jm, params, tm = pair
    tm._int8_scales = None
    loader = [fake_batch(cfg, batch=2, seed=s)[1:] + (None,) for s in (13, 14)]
    showers, energies = tm.generate(loader, 2, generator=torch.Generator().manual_seed(0))
    assert tm._int8_scales is not None and len(tm._int8_scales) == 35
    assert showers.shape == (4, 6480) and np.isfinite(showers).all() and (showers >= 0).all()


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

def test_cascade_calibrates_the_base_unet_and_warns_without_a_fence(capsys):
    """Both packages calibrate the base U-Net alone and print the warning
    without QUANT_INT8_EXCLUDE; with the fence, no warning.  The port's
    int8 sample leaves stage 1 as it was and runs stage 2 int8."""
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, LAYER_STEPS=4,
                          NSTEPS=4, PRECISION="f32", QUANT_INT8=True)
    jm = JaxLayer(dict(cfg), n_steps=4)
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    tm = LayerDiffusion(dict(cfg), n_steps=4, device="cpu")
    tm.load_state_dict(layer_params_to_state_dict(params, cfg))
    _, E, layers = fake_batch(cfg, batch=2, seed=15)
    want = jm.prepare_int8(params, n_sigmas=1, batch=2, E=E, layers=layers)
    got = tm.prepare_int8(n_sigmas=1, E=E, layers=layers)
    assert set(got) == set(want) == set(tm.quantizable_convs())
    assert capsys.readouterr().out.count("WARNING: QUANT_INT8 on the layer cascade without "
                                         "QUANT_INT8_EXCLUDE") == 2
    fence = [f"ResnetBlock_{i}/" for i in range(6)] + ["CondUnet_0/Conv3d_0",
                                                       "CondUnet_0/Conv3d_1"]
    tm.config["QUANT_INT8_EXCLUDE"] = fence
    fenced = tm.prepare_int8(n_sigmas=1, E=E, layers=layers)
    assert "WARNING" not in capsys.readouterr().out and len(fenced) == len(got) - 14

    gen = {}
    for int8 in (False, True):
        tm.config["QUANT_INT8"] = int8
        gen[int8] = tm.sample(_to_t(E), num_steps=2, generator=torch.Generator().manual_seed(1),
                              return_layers=True)
    assert torch.equal(gen[True]["layers"], gen[False]["layers"])
    assert torch.isfinite(gen[True]["x"]).all() and not torch.equal(gen[True]["x"],
                                                                     gen[False]["x"])


def test_int8_convs_take_contiguous_inputs_after_attention(monkeypatch):
    """With block and mid attention (K1's output is a channels-last view) the
    quantized convs hand Q1 their activations as they come, with no copy:
    contiguous NCDHW or, after attention, a channels_last_3d view; Q1's
    quantize pass reads either through its strides."""
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16, BLOCK_ATTN=True,
                          MID_ATTN=True, PRECISION="f32", QUANT_INT8=True)
    tm = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    layouts = []
    ref = int8_conv.int8_conv3d_reference

    def layout(x):
        return ("ncdhw" if x.is_contiguous() else
                "channels_last" if x.is_contiguous(memory_format=torch.channels_last_3d) else
                "other")

    monkeypatch.setattr(int8_conv, "int8_conv3d_reference",
                        lambda x, *a: layouts.append(layout(x)) or ref(x, *a))
    x, E, layers = (_to_t(a) for a in fake_batch(cfg, batch=2, seed=16))
    tm.prepare_int8(n_sigmas=1, batch=2)
    with torch.no_grad(), tm.int8_scope():
        y = tm.denoise(x, E=E, sigma=torch.full((2, 1, 1, 1, 1), 0.7), layers=layers)
    assert torch.isfinite(y).all() and len(layouts) == 36
    assert set(layouts) == {"ncdhw", "channels_last"}, layouts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_int8_conv3d_takes_channels_last_inputs(dtype):
    """int8_conv3d on a channels_last_3d view (K1's output layout) equals it
    on the contiguous tensor, bit for bit, for a 3x3x3 phi-wrapped conv and
    the stride-2 downsample."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 8, 6)).astype(np.float32)).to(dtype)
    x_cl = x.to(memory_format=torch.channels_last_3d)
    assert not x_cl.is_contiguous()
    for kernel, stride in (((3, 3, 3), 1), ((3, 4, 4), 2)):
        wq = torch.from_numpy(rng.integers(-127, 128, (16, 8, *kernel), dtype=np.int8))
        scale = torch.full((16,), 1e-3)
        bias = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
        args = (wq, scale, bias, 127 / 2.5, stride, 1, True)
        assert torch.equal(int8_conv.int8_conv3d(x_cl, *args), int8_conv.int8_conv3d(x, *args))


def test_int8_weights_keep_the_kernel_order_once():
    """``Int8Weights`` makes Q1's weight image, (Cout, kz, ka, kr, Cp) with
    the channels zero-padded to a multiple of 32, once and keeps it; the
    int8 conv gives the same output from it as from the bare weights."""
    rng = np.random.default_rng(7)
    wq = torch.from_numpy(rng.integers(-127, 128, (4, 40, 3, 3, 3), dtype=np.int8))
    weights = int8_conv.Int8Weights(wq)
    image = weights.kernel()
    assert image.shape == (4, 3, 3, 3, 64) and image.is_contiguous()
    assert torch.equal(image[..., :40], wq.permute(0, 2, 3, 4, 1)) and not image[..., 40:].any()
    assert weights.kernel() is image and int8_conv.Int8Weights.of(weights) is weights
    x = torch.from_numpy(rng.standard_normal((2, 40, 4, 6, 5)).astype(np.float32))
    args = (torch.full((4,), 1e-3), None, 127 / 2.5, 1, 1, True)
    assert torch.equal(int8_conv.int8_conv3d(x, weights, *args),
                       int8_conv.int8_conv3d(x, wq, *args))
