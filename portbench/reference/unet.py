"""The CaloDiffusion U-Net in plain PyTorch, written out from its equations.

A frozen copy of the architecture of CaloDiffusion's ``CondUnet``
(OzAmram/CaloDiffusion ``calodiffusion/models/models.py``: CondUnet,
ResnetBlock, Block, LinearAttention under PreNorm and Residual, the
cylindrical convolutions) as functions of a dict of parameters.  It imports
nothing of the program under test and runs in whatever precision its
inputs have (float32 for the comparison).  ``fake_quant`` rounds the
inputs and weights of every product (convolutions, dense layers, the
attention's projections and context products) and the output of every
layer, as a program that computes and stores in a lower precision would:
the control of the comparison passes a float8 rounding there.

Parameter names are the published ones (``init_conv.weight``,
``downs.0.0.block1.proj.weight``, ``downs_attn.0.fn.fn.to_qkv.weight``, ...),
so that one dict of weights made by the benchmark loads into the program and
feeds this reference alike.  ``param_specs`` lists them, with their shapes
and fan-ins, from the configuration alone.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

DIM_HEAD = 32
GN_GROUPS = 8  # BLOCK_GROUPS' default
EPS = 1e-5


def identity(t):
    return t


# ---------------------------------------------------------------------------
# Shapes from the configuration
# ---------------------------------------------------------------------------

def cond_size(config) -> int:
    """Columns of the conditioning: the incident energy, and with a
    layer-conditioned map the total and per-layer energies."""
    if "layer" in config.get("SHOWERMAP", ""):
        return 2 + config["SHAPE_FINAL"][2]
    return 1


def in_channels(config) -> int:
    return 3 if config.get("R_Z_INPUT", False) else 1


def down_shape(shape, compress_z):
    """The grid after a (3, 4, 4) convolution of stride (2 or 1, 2, 2),
    padding 1 (phi wrapped by 1 where cylindrical: the same sizes)."""
    z, a, r = shape
    zs = 2 if compress_z else 1
    return ((z + 2 - 3) // zs + 1, (a + 2 - 4) // 2 + 1, (r + 2 - 4) // 2 + 1)


def level_shapes(config) -> list:
    """The grid (Z, A, R) of each U-Net level."""
    shape = tuple(config["SHAPE_FINAL"][2:])
    n = len(config["LAYER_SIZE_UNET"]) - 1
    out = [shape]
    for _ in range(n - 1):
        shape = down_shape(shape, config.get("COMPRESS_Z", False))
        out.append(shape)
    return out


def extra_upsamples(config) -> list:
    """Output paddings of the upsampling convolutions, the deepest first
    (the reference's compute_extra_upsamples, popped from its end)."""
    cur = tuple(config["SHAPE_FINAL"][2:])
    extras = []
    for _ in range(len(config["LAYER_SIZE_UNET"]) - 2):
        extras.append(((cur[0] + 1) % 2, cur[1] % 2, cur[2] % 2))
        z = math.ceil(cur[0] / 2.0) if config.get("COMPRESS_Z", False) else cur[0]
        cur = (z, cur[1] // 2, cur[2] // 2)
    return extras[::-1]


def structure(config) -> dict:
    """The U-Net's blocks in call order: {"downs": [(cin, cout, attn,
    down)], "mid": width, "ups": [(cin, cout, attn, up, extra)], ...}."""
    ls = list(config["LAYER_SIZE_UNET"])
    in_out = list(zip(ls[:-1], ls[1:]))
    n = len(in_out)
    block_attn = bool(config.get("BLOCK_ATTN", False))
    extras = extra_upsamples(config)
    downs = [(i, o, block_attn, k < n - 1) for k, (i, o) in enumerate(in_out)]
    ups = []
    for k, (i, o) in enumerate(reversed(in_out)):
        up = k < n - 1
        ups.append((2 * o, i, block_attn, up, extras[k] if up else None))
    return {"downs": downs, "mid": ls[-1], "mid_attn": bool(config.get("MID_ATTN", False)),
            "ups": ups, "first": ls[0]}


def param_specs(config) -> dict:
    """{name: (shape, fan_in, kind)} of every parameter, kind "weight",
    "bias", "norm_weight" or "norm_bias"; fan_in sets the init bound of a
    weight or bias (torch's default: 1 / sqrt(fan_in))."""
    if "sin" in (config.get("TIME_EMBED", "sin"), config.get("COND_EMBED", "sin")):
        raise NotImplementedError("the sinusoidal time and energy embeddings are not written out")
    specs: dict = {}
    cond_dim = config["COND_SIZE_UNET"]
    half = cond_dim // 2

    def conv(name, cin, cout, k):
        fan = cin * math.prod(k)
        specs[name + ".weight"] = ((cout, cin, *k), fan, "weight")
        specs[name + ".bias"] = ((cout,), fan, "bias")

    def conv_t(name, cin, cout, k):
        specs[name + ".weight"] = ((cin, cout, *k), cin * math.prod(k), "weight")
        specs[name + ".bias"] = ((cout,), cout * math.prod(k), "bias")

    def dense(name, fin, fout):
        specs[name + ".weight"] = ((fout, fin), fin, "weight")
        specs[name + ".bias"] = ((fout,), fin, "bias")

    def norm(name, c):
        specs[name + ".weight"] = ((c,), 0, "norm_weight")
        specs[name + ".bias"] = ((c,), 0, "norm_bias")

    def resnet(name, cin, cout, cond=True):
        conv(name + ".block1.proj", cin, cout, (3, 3, 3))
        norm(name + ".block1.norm", cout)
        if cond:
            dense(name + ".mlp.1", cond_dim, cout)
        conv(name + ".block2.proj", cout, cout, (3, 3, 3))
        norm(name + ".block2.norm", cout)
        if cin != cout:
            conv(name + ".res_conv", cin, cout, (1, 1, 1))

    def attn(name, c):
        norm(name + ".fn.norm", c)
        specs[name + ".fn.fn.to_qkv.weight"] = ((3 * DIM_HEAD, c, 1, 1, 1), c, "weight")
        conv(name + ".fn.fn.to_out.0", DIM_HEAD, c, (1, 1, 1))
        norm(name + ".fn.fn.to_out.1", c)

    st = structure(config)
    conv("init_conv", in_channels(config), st["first"], (3, 3, 3))
    # time MLP: Unflatten, Dense, GELU, Dense, GELU, Dense (no sinusoid)
    dense("time_mlp.1", 1, half // 2)
    dense("time_mlp.3", half // 2, half)
    dense("time_mlp.5", half, half)
    hidden = max(cond_size(config), half // 2)
    dense("cond_mlp.0", cond_size(config), hidden)
    dense("cond_mlp.2", hidden, half)
    dense("cond_mlp.4", half, half)
    for k, (cin, cout, has_attn, down) in enumerate(st["downs"]):
        resnet(f"downs.{k}.0", cin, cout)
        resnet(f"downs.{k}.1", cout, cout)
        if down:
            conv(f"downs.{k}.2", cout, cout, (3, 4, 4))
        if has_attn:
            attn(f"downs_attn.{k}", cout)
    resnet("mid_block1", st["mid"], st["mid"])
    if st["mid_attn"]:
        attn("mid_attn", st["mid"])
    resnet("mid_block2", st["mid"], st["mid"])
    for k, (cin, cout, has_attn, up, extra) in enumerate(st["ups"]):
        resnet(f"ups.{k}.0", cin, cout)
        resnet(f"ups.{k}.1", cout, cout)
        if up:
            conv_t(f"ups.{k}.2", cout, cout, (4 if extra[0] > 0 else 3, 4, 4))
        if has_attn:
            attn(f"ups_attn.{k}", cout)
    resnet("final_conv.0", st["first"], st["first"], cond=False)
    conv("final_conv.1", st["first"], 1, (1, 1, 1))
    return specs


# ---------------------------------------------------------------------------
# The forward pass
# ---------------------------------------------------------------------------

def _pad_phi(x, pad):
    return x if pad == 0 else F.pad(x, (0, 0, pad, pad, 0, 0), mode="circular")


class UNet:
    """The denoiser network of one configuration over parameters ``p``."""

    def __init__(self, config, params: dict, fake_quant: Callable = identity):
        self.c = config
        self.p = params
        self.q = fake_quant
        self.cyl = bool(config.get("CYLINDRICAL", False))
        self.zs = 2 if config.get("COMPRESS_Z", False) else 1
        self.st = structure(config)

    # -- primitives --------------------------------------------------------
    def conv(self, name, x, stride=1, padding=0):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        pz = pa = pr = padding
        if self.cyl:
            x, pa = _pad_phi(x, pa), 0
        return self.q(F.conv3d(self.q(x), self.q(w), b, stride=stride, padding=(pz, pa, pr)))

    def conv_t(self, name, x, extra):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        pad = [1, 1, 1]
        if self.cyl:
            x, pad[1] = _pad_phi(x, 1), w.shape[3] - 1
        return self.q(F.conv_transpose3d(self.q(x), self.q(w), b, stride=(self.zs, 2, 2),
                                         padding=tuple(pad),
                                         output_padding=(0, extra[1], extra[2])))

    def dense(self, name, x):
        return self.q(F.linear(self.q(x), self.q(self.p[name + ".weight"]),
                               self.p[name + ".bias"]))

    def group_norm(self, name, x, groups):
        return self.q(F.group_norm(x, groups, self.p[name + ".weight"], self.p[name + ".bias"],
                                   EPS))

    # -- blocks ------------------------------------------------------------
    def block(self, name, x):
        return self.q(F.silu(self.group_norm(name + ".norm",
                                             self.conv(name + ".proj", x, padding=1), GN_GROUPS)))

    def resnet(self, name, x, cond=None):
        h = self.block(name + ".block1", x)
        if cond is not None:
            h = h + self.dense(name + ".mlp.1", F.silu(cond))[:, :, None, None, None]
        h = self.block(name + ".block2", h)
        res = self.conv(name + ".res_conv", x) if name + ".res_conv.weight" in self.p else x
        return self.q(h + res)

    def attention(self, name, x):
        """x + GN1(LinearAttention(GN1(x))), one head of 32: softmax of q
        over its features, of k over the positions."""
        b, c = x.shape[:2]
        q = self.q
        xn = self.group_norm(name + ".fn.norm", x, 1)
        xf = xn.reshape(b, c, -1).transpose(1, 2)  # (B, N, C)
        w_qkv = self.p[name + ".fn.fn.to_qkv.weight"].reshape(3 * DIM_HEAD, c)
        qkv = q(xf) @ q(w_qkv).t()
        qh, kh, vh = qkv.split(DIM_HEAD, dim=-1)
        qh = torch.softmax(qh, dim=-1) * DIM_HEAD ** -0.5
        kh = torch.softmax(kh, dim=1)
        ctx = q(kh).transpose(1, 2) @ q(vh)  # (B, D, D)
        out = q(qh) @ q(ctx)  # (B, N, D)
        w_out = self.p[name + ".fn.fn.to_out.0.weight"].reshape(c, DIM_HEAD)
        y = q(out) @ q(w_out).t() + self.p[name + ".fn.fn.to_out.0.bias"]
        y = y.transpose(1, 2).reshape(x.shape)
        return self.q(x + self.group_norm(name + ".fn.fn.to_out.1", y, 1))

    def mlp(self, prefix, idx, x):
        for k, i in enumerate(idx):
            x = self.dense(f"{prefix}.{i}", x)
            if k < len(idx) - 1:
                x = F.gelu(x)
        return x

    # -- the network ---------------------------------------------------------
    def __call__(self, x, cond, time):
        """x (B, C_in, Z, A, R), cond (B, cond_size), time (B,) -> (B, 1, Z, A, R)."""
        st = self.st
        x = self.conv("init_conv", x, padding=1)
        cond = torch.cat([self.mlp("time_mlp", (1, 3, 5), time.reshape(-1, 1)),
                          self.mlp("cond_mlp", (0, 2, 4), cond)], dim=-1)
        hs = []
        for k, (_, _, has_attn, down) in enumerate(st["downs"]):
            x = self.resnet(f"downs.{k}.0", x, cond)
            x = self.resnet(f"downs.{k}.1", x, cond)
            if has_attn:
                x = self.attention(f"downs_attn.{k}", x)
            hs.append(x)
            if down:
                x = self.conv(f"downs.{k}.2", x, stride=(self.zs, 2, 2), padding=1)
        x = self.resnet("mid_block1", x, cond)
        if st["mid_attn"]:
            x = self.attention("mid_attn", x)
        x = self.resnet("mid_block2", x, cond)
        for k, (_, _, has_attn, up, extra) in enumerate(st["ups"]):
            x = torch.cat([x, hs.pop()], dim=1)
            x = self.resnet(f"ups.{k}.0", x, cond)
            x = self.resnet(f"ups.{k}.1", x, cond)
            if has_attn:
                x = self.attention(f"ups_attn.{k}", x)
            if up:
                x = self.conv_t(f"ups.{k}.2", x, extra)
        x = self.resnet("final_conv.0", x)
        return self.conv("final_conv.1", x)


# ---------------------------------------------------------------------------
# The constant R and Z images beside the shower
# ---------------------------------------------------------------------------

R_BIN_EDGES = {
    2: [0.0, 4.65, 9.3, 13.95, 18.6, 23.25, 27.9, 32.55, 37.2, 41.85],
    3: [0.0, 2.325, 4.65, 6.975, 9.3, 11.625, 13.95, 16.275, 18.6, 20.925,
        23.25, 25.575, 27.9, 30.225, 32.55, 34.875, 37.2, 39.525, 41.85],
}


def rz_images(config) -> Optional[np.ndarray]:
    """(2, Z, A, R): the radius of each bin's centre over the last one's, and
    the layer index over Z (CaloDiffusion's create_R_Z_image, scaled)."""
    if not config.get("R_Z_INPUT", False):
        return None
    z, a, r = config["SHAPE_FINAL"][2:]
    edges = np.asarray(R_BIN_EDGES[config["DATASET_NUM"]], np.float32)
    centres = (edges[:-1] + edges[1:]) / 2.0
    if len(centres) != r:
        raise ValueError(f"dataset {config['DATASET_NUM']} has {len(centres)} radial bins, "
                         f"the grid {r}")
    r_img = np.broadcast_to(centres[None, None, :] / centres[-1], (z, a, r))
    z_img = np.broadcast_to((np.arange(z, dtype=np.float32) / z)[:, None, None], (z, a, r))
    return np.stack([r_img, z_img]).astype(np.float32)
