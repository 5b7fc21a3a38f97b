"""Operations and bytes of the network's work, from the configuration alone.

The counts follow the architecture as ``reference/unet.py`` writes it out
and never the operations the program happens to run, so that a later
change to the program's kernels leaves them as they are.

- A convolution's operations are 2 x output positions x C_out x C_in x taps;
  a transposed one's 2 x input positions x C_in x C_out x taps, over its
  input as it enters the product (phi wrapped by 1 where cylindrical).
- A dense layer's are 2 x rows x in x out.
- The fused attention block's (K1) are ``2 B N (96 C + 2 32 32 + 32 C)``: the
  qkv and output projections and the two 32 x 32 context products a
  position (``k1_flops``); its backward's (K2) ``2 B N (12 C D + 8 D D)``,
  the products of the kernel's body, which recomputes the forward.
- In a training step every product of the forward runs twice more, once for
  its input's gradient and once for its weight's, except the input
  gradients nothing needs (the first convolution's, the first dense layers
  of the time and energy MLPs).
- Bytes, for a bound: each input element read once, each output element
  written once, each weight read once, in bfloat16.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bfloat16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from portbench.reference.unet import (DIM_HEAD, cond_size, in_channels, level_shapes,
                                      structure)

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
D = DIM_HEAD


@dataclass(frozen=True)
class Op:
    """One product of a network evaluation at batch 1: ``kind`` "conv",
    "conv_t", "dense" or "attn"; ``positions``: the output positions of a
    convolution, the input positions of a transposed one, the positions N
    of an attention block, 1 for a dense layer; ``cin``, ``cout``, ``taps``;
    ``in_elems``, ``out_elems``: activations read and written; ``grad_in``:
    whether training needs its input's gradient."""
    kind: str
    positions: int
    cin: int
    cout: int
    taps: int = 1
    in_elems: int = 0
    out_elems: int = 0
    grad_in: bool = True

    def flops(self, batch: int) -> int:
        if self.kind == "attn":
            return k1_flops(batch, self.positions, self.cin)
        return 2 * batch * self.positions * self.cin * self.cout * self.taps

    def backward_flops(self, batch: int) -> int:
        if self.kind == "attn":
            return k2_flops(batch, self.positions, self.cin)
        return self.flops(batch) * (2 if self.grad_in else 1)

    def nbytes(self, batch: int, elt: int = 2) -> int:
        if self.kind == "attn":
            return attention_bytes(batch, self.positions, self.cin, elt)
        weights = self.cin * self.cout * self.taps + self.cout
        return (batch * (self.in_elems + self.out_elems) + weights) * elt

    def bound_s(self, batch: int, elt: int = 2) -> float:
        return bound_s(self.nbytes(batch, elt), self.flops(batch))


def k1_flops(B: int, N: int, C: int) -> int:
    return 2 * B * N * (3 * D * C + D * D + D * D + D * C)


def k2_flops(B: int, N: int, C: int) -> int:
    return 2 * B * N * (12 * C * D + 8 * D * D)


def attention_bytes(B: int, N: int, C: int, elt: int = 2) -> int:
    """K1: x read once, out written once, weights once, five f32 vectors."""
    return 2 * B * N * C * elt + (C * 3 * D + D * C) * elt + 5 * C * 4


def bound_s(nbytes: float, flops: float) -> float:
    """The card's least time: bytes over the HBM rate or operations over
    the bf16 peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def network_ops(config) -> list[Op]:
    """Every product of one evaluation of the denoiser network, in order."""
    st = structure(config)
    shapes = level_shapes(config)
    cyl = bool(config.get("CYLINDRICAL", False))
    zs = 2 if config.get("COMPRESS_Z", False) else 1
    cond_dim = config["COND_SIZE_UNET"]
    half = cond_dim // 2
    ops: list[Op] = []

    def vox(s):
        return math.prod(s)

    def conv(cin, cout, k, s_in, s_out, grad_in=True):
        ops.append(Op("conv", vox(s_out), cin, cout, math.prod(k), cin * vox(s_in),
                      cout * vox(s_out), grad_in))

    def dense(fin, fout, grad_in=True):
        ops.append(Op("dense", 1, fin, fout, 1, fin, fout, grad_in))

    def resnet(cin, cout, s, cond=True):
        conv(cin, cout, (3, 3, 3), s, s)
        if cond:
            dense(cond_dim, cout)
        conv(cout, cout, (3, 3, 3), s, s)
        if cin != cout:
            conv(cin, cout, (1, 1, 1), s, s)

    def attn(c, s):
        ops.append(Op("attn", vox(s), c, c, 1, c * vox(s), c * vox(s)))

    conv(in_channels(config), st["first"], (3, 3, 3), shapes[0], shapes[0], grad_in=False)
    for fin, fout, first in ((1, half // 2, True), (half // 2, half, False), (half, half, False)):
        dense(fin, fout, grad_in=not first)
    hidden = max(cond_size(config), half // 2)
    for fin, fout, first in ((cond_size(config), hidden, True), (hidden, half, False),
                             (half, half, False)):
        dense(fin, fout, grad_in=not first)
    for k, (cin, cout, has_attn, down) in enumerate(st["downs"]):
        s = shapes[k]
        resnet(cin, cout, s)
        resnet(cout, cout, s)
        if has_attn:
            attn(cout, s)
        if down:
            conv(cout, cout, (3, 4, 4), s, shapes[k + 1])
    deep = shapes[-1]
    resnet(st["mid"], st["mid"], deep)
    if st["mid_attn"]:
        attn(st["mid"], deep)
    resnet(st["mid"], st["mid"], deep)
    for k, (cin, cout, has_attn, up, extra) in enumerate(st["ups"]):
        s = shapes[len(shapes) - 1 - k]
        resnet(cin, cout, s)
        resnet(cout, cout, s)
        if has_attn:
            attn(cout, s)
        if up:
            kz = 4 if extra[0] > 0 else 3
            s_out = shapes[len(shapes) - 2 - k]
            s_in = (s[0], s[1] + 2, s[2]) if cyl else s  # phi wrapped by 1
            ops.append(Op("conv_t", vox(s_in), cout, cout, kz * 16, cout * vox(s),
                          cout * vox(s_out)))
            expect = ((s[0] - 1) * zs - 2 + kz, 2 * s[1] + extra[1], 2 * s[2] + extra[2])
            if expect != tuple(s_out):
                raise ValueError(f"upsampling {s} gives {expect}, the skip is {s_out}")
    resnet(st["first"], st["first"], shapes[0], cond=False)
    conv(st["first"], 1, (1, 1, 1), shapes[0], shapes[0])
    return ops


def denoise_flops(config, batch: int) -> int:
    """Operations of one network evaluation of ``batch`` showers."""
    return sum(op.flops(batch) for op in network_ops(config))


def train_step_flops(config, batch: int) -> int:
    """Operations of one training step: the forward, and the backward's
    products (K2's count for the attention blocks)."""
    return sum(op.flops(batch) + op.backward_flops(batch) for op in network_ops(config))


def conv_ops(config) -> list[Op]:
    return [op for op in network_ops(config) if op.kind in ("conv", "conv_t")]


def attention_ops(config) -> list[Op]:
    return [op for op in network_ops(config) if op.kind == "attn"]
