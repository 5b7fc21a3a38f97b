"""W8A8 int8 sampling of one model family, the port against the JAX package
on the CPU: what the family test files (tests/test_torch_port_ds1.py,
_ds3.py, _hgcal.py) hold, computed once a model by ``Int8Runs``.  This
module holds no tests of its own.

Both packages calibrate from the same unit noise per sigma, E and layers
(the JAX model's ``noise_generation`` hands it the port's arrays), with and
without the upsampling transposes.  The JAX scale table then drives both
sides: the JAX package's int8 denoise and int8 DDim sample from an
injected start, one jit each, which record while they trace the geometry
(stride, padding, phi wrap) of each quantized conv they dispatch; and the
port's float and int8 calls, its quantized convs' inputs and outputs
hooked.  Each of those convs is held to the JAX op on its own input with
the JAX geometry, run eagerly as the JAX package's own tests run it.  The
JAX package runs int8 off the TPU only under ``CALODIFF_INT8=force``, set
while it runs; the tolerances are in ``ops/tolerances.py``.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.ops import quant as jq
from calodiffusion_tpu.samplers import get_sampler as jax_get_sampler
from calodiffusion_tpu_torch.ops.tolerances import INT8_NOISE_RMS
from calodiffusion_tpu_torch.samplers import get_sampler
from tests.test_torch_port_quant import assert_within_ulps, rms_rel

N_SIGMAS = 2
DDIM_STEPS = 4
# a scale of the two tables: an activation's abs-max from the same inputs.
# The families' float calls agree within the 2e-4 weight-transfer bound, not
# ds2's 1e-5 (tests/test_torch_port_quant.py's CALIB_RTOL): an embed in
# front of the U-Net sums in other orders (1.4e-5 measured at HGCal's
# in-model GLaM), so 1e-4 relative
TABLE_RTOL = 1e-4


@contextlib.contextmanager
def env(**values):
    """os.environ with ``values`` set (None: removed), restored after."""
    prev = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32))


def calibrate_both(jm, params, tm, E, layers, seed, n_sigmas=N_SIGMAS, transposes=False):
    """(port's table, JAX's) from the same noise, E and layers."""
    rng = np.random.default_rng(seed)
    batch = E.shape[0]
    noise = [rng.standard_normal((batch, *tm._data_shape)).astype(np.float32)
             for _ in range(n_sigmas)]
    it = iter(noise)
    jm.noise_generation = lambda key, shape: jnp.asarray(next(it))
    with env(CALODIFF_INT8="force", CALODIFF_INT8_TRANSPOSE="1" if transposes else None):
        try:
            want = jm.prepare_int8(params, n_sigmas=n_sigmas, batch=batch, E=E, layers=layers)
        finally:
            del jm.noise_generation
        got = tm.prepare_int8(n_sigmas=n_sigmas, E=E, layers=layers, noise=noise)
        convs = set(tm.quantizable_convs())
    return got, want, convs


@contextlib.contextmanager
def recording_sites(sites):
    """While a JAX trace runs inside: {path: (stride, padding, cylindrical)}
    of each conv it dispatches to ``quant.int8_conv3d`` (the path is the
    one its ``scale_for`` was just asked for)."""
    scale_for, conv = jq.scale_for, jq.int8_conv3d
    asked = []

    def scale_for_recorded(path):
        asked.append(path)
        return scale_for(path)

    def conv_recorded(x, w, b, sx, stride=1, padding=0, cylindrical=False):
        sites[asked[-1]] = (stride, padding, cylindrical)
        return conv(x, w, b, sx, stride=stride, padding=padding, cylindrical=cylindrical)

    jq.scale_for, jq.int8_conv3d = scale_for_recorded, conv_recorded
    try:
        yield
    finally:
        jq.scale_for, jq.int8_conv3d = scale_for, conv


def _flax_conv(params, path):
    node = params["params"]
    for k in path.split("/"):
        node = node[k]
    return node["kernel"], node["bias"]


class Int8Runs:
    """Everything the family tests hold for one model pair, computed once:
    ``tables`` (port's, JAX's, the port's quantizable paths), ``tables_t``
    (the same with CALODIFF_INT8_TRANSPOSE=1), ``jax`` (int8 denoise and
    DDim), ``port`` (float and int8 denoise and DDim), ``sites`` (JAX's geometry by
    path) and ``convs`` ({path: (port output, JAX op output)}).  ``x``,
    ``sigma``, ``start`` in the model's layout; ``E``/``layers`` as the
    loader yields them (``layers`` None without layer conditioning)."""

    def __init__(self, cfg, jm, params, tm, x, E, layers, sigma, start, seed):
        self.tables = calibrate_both(jm, params, tm, E, layers, seed)
        self.tables_t = calibrate_both(jm, params, tm, E[:1],
                                       None if layers is None else layers[:1], seed + 1,
                                       n_sigmas=1, transposes=True)
        table = self.tables[1]
        lay = None if layers is None else jnp.asarray(layers)

        def denoise(p):
            return jm.denoise(p, x, E=E, sigma=sigma, layers=lay)

        def ddim(p):
            return jax_get_sampler("DDim")(cfg)(jm, p, jnp.asarray(start), jnp.asarray(E), lay,
                                                DDIM_STEPS, 0, jax.random.PRNGKey(0), False)

        # two jits: one holding both compiles in ~1.8x their sum
        self.sites, self.jax = {}, {}
        with env(CALODIFF_INT8="force"), recording_sites(self.sites), jq.quant_scales(table):
            for name, fn in (("denoise_int8", denoise), ("ddim_int8", ddim)):
                self.jax[name] = np.asarray(jax.jit(fn)(params))

        # the port: the float calls, then the int8 ones from the JAX table,
        # the int8 denoise's quantized convs hooked
        seen, self.port = {}, {}
        args = (_t(x),), dict(E=_t(E), sigma=_t(sigma), layers=_t(layers))

        def ddim():
            return get_sampler("DDim")(cfg)(tm, _t(start), _t(E), _t(layers), DDIM_STEPS, 0,
                                            None, False).numpy()

        prev = tm.config.get("QUANT_INT8"), tm._int8_scales
        try:
            with torch.no_grad():
                tm.config["QUANT_INT8"], tm._int8_scales = False, None
                self.port["denoise_float"] = tm.denoise(*args[0], **args[1]).numpy()
                self.port["ddim_float"] = ddim()
                tm.config["QUANT_INT8"], tm._int8_scales = True, dict(table)
                with tm.int8_scope():
                    hooks = [c.register_forward_hook(
                                 lambda m, a, out, p=p: seen.__setitem__(p, (a[0], out)))
                             for p, c in tm.quantizable_convs().items()]
                    try:
                        self.port["denoise_int8"] = tm.denoise(*args[0], **args[1]).numpy()
                    finally:
                        for h in hooks:
                            h.remove()
                    self.port["ddim_int8"] = ddim()
        finally:
            tm.config["QUANT_INT8"], tm._int8_scales = prev

        # each quantized conv of the int8 denoise: the JAX op, run eagerly (a
        # jit may fuse its dequantization), on the conv's input there
        paths = sorted(set(seen) & set(self.sites))
        want = {p: jq.int8_conv3d(jnp.asarray(seen[p][0].permute(0, 2, 3, 4, 1).numpy()),
                                  *_flax_conv(params, p), table[p], stride=self.sites[p][0],
                                  padding=self.sites[p][1], cylindrical=self.sites[p][2])
                for p in paths}
        self.port_convs = set(seen)
        self.convs = {p: (seen[p][1].permute(0, 2, 3, 4, 1), np.asarray(want[p])) for p in paths}

    # -- the checks --------------------------------------------------------
    def check_tables(self):
        """The same keys (the port's quantizable convs), values within
        TABLE_RTOL; with the transposes, the two Conv3dTranspose more."""
        for (got, want, convs), extra in ((self.tables, 0), (self.tables_t, 2)):
            assert set(got) == set(want) == convs, (set(got) ^ set(want), set(got) ^ convs)
            assert len({k for k in want if "Conv3dTranspose" in k}) == extra
            for k, v in want.items():
                assert abs(got[k] / v - 1) <= TABLE_RTOL, (k, got[k], v)
        assert set(self.tables_t[1]) - set(self.tables[1]) == {
            k for k in self.tables_t[1] if "Conv3dTranspose" in k}

    def check_convs(self):
        """Every conv of the table ran int8 on both sides, each port output
        within one ulp of the JAX op on its input."""
        assert self.port_convs == set(self.sites) == set(self.tables[1]) == set(self.convs)
        for path, (got, want) in self.convs.items():
            assert_within_ulps(got, want, torch.float32)

    def check_within_int8_noise(self, what):
        """``what`` ("denoise" or "ddim"): the port's int8 call within
        INT8_NOISE_RMS of the JAX package's int8-vs-float gap, and its own
        gap that gap's size.  The float call is the port's, which the
        family's float tests hold to JAX's within 2e-4 (steps x for DDim):
        ~1e-6 relative, against int8 gaps of ~1e-2."""
        j8, tf, t8 = self.jax[f"{what}_int8"], self.port[f"{what}_float"], \
            self.port[f"{what}_int8"]
        assert t8.shape == j8.shape == tf.shape
        assert np.isfinite(t8).all()
        gap = rms_rel(j8, tf)
        assert gap > 0
        assert rms_rel(t8, j8) <= INT8_NOISE_RMS * gap, (rms_rel(t8, j8), gap)
        assert gap / INT8_NOISE_RMS <= rms_rel(t8, tf) <= INT8_NOISE_RMS * gap


def check_int8_generate(tm, loader, steps=2):
    """``generate`` with QUANT_INT8 and no table: it calibrates once, on the
    first batch's E (its first 64 rows) and layers, as the JAX package's
    generate does (diffusion.py:569-573); then every denoise of every batch
    runs the table's convs int8 (Q1's plain version on the CPU) and the
    inverse preprocessing gives finite showers >= 0 of SHAPE_ORIG.
    Returns the showers."""
    from unittest import mock

    from calodiffusion_tpu_torch.ops import int8_conv

    asked, calls = [], []
    prepare, reference = tm.prepare_int8, int8_conv.int8_conv3d_reference

    def prepare_recorded(**kw):
        asked.append(kw)
        return prepare(**kw)

    def reference_counted(*a, **kw):
        calls.append(a[0].shape)
        return reference(*a, **kw)

    prev = tm.config.get("QUANT_INT8"), tm._int8_scales
    tm.config["QUANT_INT8"], tm._int8_scales = True, None
    try:
        with mock.patch.object(tm, "prepare_int8", prepare_recorded), \
                mock.patch.object(int8_conv, "int8_conv3d_reference", reference_counted):
            showers, energies = tm.generate(loader, steps,
                                            generator=torch.Generator().manual_seed(0))
        table = tm._int8_scales
    finally:
        tm.config["QUANT_INT8"], tm._int8_scales = prev
    E0, layers0 = loader[0][:2]
    assert len(asked) == 1 and np.array_equal(asked[0]["E"].numpy(), E0[:64])
    if tm.layer_cond:
        assert np.array_equal(asked[0]["layers"].numpy(), layers0)
    else:
        assert asked[0]["layers"] is None
    n = sum(len(b[0]) for b in loader)
    assert table and set(table) == set(tm.quantizable_convs())
    assert len(calls) == len(table) * steps * len(loader)
    assert showers.shape == (n, *tm.config["SHAPE_ORIG"][1:]) and energies.shape[0] == n
    assert np.isfinite(showers).all() and (showers >= 0).all()
    return showers
