"""PyTorch network modules of the conditional 3D U-Net, main-path subset.

Port of ``calodiffusion_tpu/models/nn_modules.py`` (reference:
calodiffusion/models/models.py - CondUnet :523-777, ResnetBlock/Block
:147-200, Attention :246-278, LinearAttention :281-318, Upsample/Downsample
:335-370).

Activations are NCDHW ``(B, C, Z, A, R)``.  Parameters are f32; ``dtype``
is the compute dtype every layer casts its input and weights to, while
GroupNorm statistics and affines stay f32, as in the JAX package.
Submodule names follow the reference state_dict keys that
``calodiffusion_tpu/tools/torch_import.py`` reads (``init_conv``,
``time_mlp.N``, ``downs.i.j``, ``downs_attn.i.fn.norm``, ...).

Modules are built on the CPU, initialised from an optional
``torch.Generator`` with torch's default uniform bounds, and moved to their
device by the caller.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from calodiffusion_tpu_torch.ops.conv import (
    conv3d,
    conv3d_transpose,
    cylindrical_conv3d,
    cylindrical_conv3d_transpose,
    triple,
    uniform_,
)
from calodiffusion_tpu_torch.ops.attention import blockwise_attention
from calodiffusion_tpu_torch.ops.linear_attention import (
    DIM_HEAD,
    fused_attention_block,
    fused_linear_attention,
)


class Conv3d(nn.Module):
    """3D convolution, optionally cylindrical (circular phi padding)."""

    def __init__(self, in_ch, out_ch, kernel_size=3, stride=1, padding=0,
                 cylindrical=False, bias=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        k = triple(kernel_size)
        self.stride, self.padding = stride, padding
        self.cylindrical, self.dtype = cylindrical, dtype
        fan_in = in_ch * math.prod(k)
        self.weight = nn.Parameter(uniform_(torch.empty(out_ch, in_ch, *k), fan_in, generator))
        self.bias = (
            nn.Parameter(uniform_(torch.empty(out_ch), fan_in, generator)) if bias else None
        )

    def forward(self, x):
        op = cylindrical_conv3d if self.cylindrical else conv3d
        b = None if self.bias is None else self.bias.to(self.dtype)
        return op(x.to(self.dtype), self.weight.to(self.dtype), b,
                  stride=self.stride, padding=self.padding)


class Conv3dTranspose(nn.Module):
    """Transpose 3D convolution, optionally cylindrical."""

    def __init__(self, in_ch, out_ch, kernel_size=(3, 4, 4), stride=(1, 2, 2),
                 padding=1, output_padding=0, cylindrical=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        k = triple(kernel_size)
        self.stride, self.padding, self.output_padding = stride, padding, output_padding
        self.cylindrical, self.dtype = cylindrical, dtype
        self.weight = nn.Parameter(
            uniform_(torch.empty(in_ch, out_ch, *k), in_ch * math.prod(k), generator)
        )
        # torch ConvTranspose bias bound: fan_in = C_out * prod(k)
        self.bias = nn.Parameter(
            uniform_(torch.empty(out_ch), out_ch * math.prod(k), generator)
        )

    def forward(self, x):
        op = cylindrical_conv3d_transpose if self.cylindrical else conv3d_transpose
        return op(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype),
                  stride=self.stride, padding=self.padding,
                  output_padding=self.output_padding)


class Dense(nn.Module):
    """Linear layer (torch (out, in) weight layout) in the compute dtype."""

    def __init__(self, in_features, out_features, dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            uniform_(torch.empty(out_features, in_features), in_features, generator)
        )
        self.bias = nn.Parameter(uniform_(torch.empty(out_features), in_features, generator))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics and affine, cast back to the input dtype."""

    def __init__(self, num_groups, channels, eps=1e-5):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class SinusoidalPositionEmbeddings(nn.Module):
    """sin/cos positional embedding of a scalar (reference models.py:132-144)."""

    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        half_dim = self.dim // 2
        freq = math.log(10000) / (half_dim - 1)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=torch.float32, device=t.device) * -freq
        )
        args = t.reshape(-1).float()[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def cond_mlp(in_features, hidden, mid, out, embed, unflatten, dtype, generator):
    """Time / energy conditioning MLP (reference models.py:578-608).

    embed=True  -> [Sinusoidal(hidden), Dense(mid), GELU, Dense(out)]
    embed=False -> [(Unflatten,) Dense(hidden), GELU, Dense(mid), GELU, Dense(out)]
    The time path of the reference starts with an Unflatten turning (B,)
    into (B, 1), which shifts its Linear indices to 1, 3, 5."""
    gelu = nn.GELU(approximate="none")
    if embed:
        return nn.Sequential(
            SinusoidalPositionEmbeddings(hidden),
            Dense(2 * (hidden // 2), mid, dtype, generator), gelu,
            Dense(mid, out, dtype, generator),
        )
    layers = [nn.Unflatten(-1, (-1, 1))] if unflatten else []
    layers += [
        Dense(in_features, hidden, dtype, generator), gelu,
        Dense(hidden, mid, dtype, generator), gelu,
        Dense(mid, out, dtype, generator),
    ]
    return nn.Sequential(*layers)


class Block(nn.Module):
    """conv(k3, p1) -> GroupNorm -> SiLU (reference :147-169)."""

    def __init__(self, in_ch, out_ch, groups=8, cylindrical=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.proj = Conv3d(in_ch, out_ch, 3, padding=1, cylindrical=cylindrical,
                           dtype=dtype, generator=generator)
        self.norm = GroupNorm(groups, out_ch)

    def forward(self, x):
        return F.silu(self.norm(self.proj(x)))


class ResnetBlock(nn.Module):
    """Two conv blocks with a conditioning bias and a residual (reference :172-200)."""

    def __init__(self, in_ch, out_ch, cond_dim=None, groups=8, cylindrical=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.block1 = Block(in_ch, out_ch, groups, cylindrical, dtype, generator)
        self.mlp = (
            nn.Sequential(nn.SiLU(), Dense(cond_dim, out_ch, dtype, generator))
            if cond_dim is not None else None
        )
        self.block2 = Block(out_ch, out_ch, groups, cylindrical, dtype, generator)
        self.res_conv = (
            Conv3d(in_ch, out_ch, 1, cylindrical=cylindrical, dtype=dtype,
                   generator=generator)
            if in_ch != out_ch else None
        )

    def forward(self, x, cond=None):
        h = self.block1(x)
        if self.mlp is not None and cond is not None:
            h = h + self.mlp(cond)[:, :, None, None, None]
        h = self.block2(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class LinearAttention(nn.Module):
    """O(N) linear attention (reference :281-318; JAX nn_modules.py:471-603):
    the qkv and output 1x1 convs and the output GroupNorm(1).

    heads = 1 runs ``fused_linear_attention`` (K3 on the card, its plain
    version on the CPU) and then the output GroupNorm; heads > 1 the generic
    einsum formulation in plain PyTorch, as the JAX package computes it in
    XLA.  ``prenorm=(scale, bias)`` applies GroupNorm(1) with those
    parameters first, and ``residual=True`` then adds the input back: the
    entry of `PreNormResidual`.  With both and heads = 1 the whole block is
    one ``fused_attention_block`` (K1 forward and K2 backward on the
    card)."""

    def __init__(self, dim, heads=1, dim_head=DIM_HEAD, cylindrical=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        hidden = heads * dim_head
        self.to_qkv = Conv3d(dim, 3 * hidden, 1, cylindrical=cylindrical, bias=False,
                             dtype=dtype, generator=generator)
        self.to_out = nn.Sequential(
            Conv3d(hidden, dim, 1, cylindrical=cylindrical, dtype=dtype,
                   generator=generator),
            GroupNorm(1, dim),
        )

    def _matrices(self, c):
        """The 1x1 convs as (C, 3*hidden) and (hidden, C) matrices in the
        compute dtype, and the output bias in f32."""
        hidden = self.heads * self.dim_head
        w_qkv = self.to_qkv.weight.reshape(3 * hidden, c).t().to(self.dtype).contiguous()
        w_out = self.to_out[0].weight.reshape(c, hidden).t().to(self.dtype).contiguous()
        return w_qkv, w_out, self.to_out[0].bias.float()

    def forward(self, x, prenorm=None, residual=False):
        b, c, *spatial = x.shape
        w_qkv, w_out, b_out = self._matrices(c)
        if prenorm is not None and residual and self.heads == 1:
            post_gn = self.to_out[1]
            out = fused_attention_block(
                _to_bnc(x.to(self.dtype)), prenorm[0], prenorm[1], w_qkv, w_out, b_out,
                post_gn.weight, post_gn.bias, dim_head=self.dim_head,
            )
            return _to_ncdhw(out, spatial)
        skip = x
        if prenorm is not None:
            x = group_norm1(x, *prenorm)
        xf = _to_bnc(x.to(self.dtype))
        if self.heads == 1:
            out = fused_linear_attention(xf, w_qkv, w_out, b_out, self.dim_head)
        else:  # generic multi-head path (JAX nn_modules.py:579-598)
            n, h, d = xf.shape[1], self.heads, self.dim_head
            q, k, v = (t.reshape(b, n, h, d) for t in (xf @ w_qkv).split(h * d, dim=-1))
            q = torch.softmax(q.float(), dim=-1).to(v.dtype)
            k = torch.softmax(k.float(), dim=1).to(v.dtype)
            q = q * (d ** -0.5)
            context = torch.einsum("bnhd,bnhe->bhde", k, v)
            out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(b, n, h * d)
            out = out @ w_out + b_out.to(out.dtype)
        out = self.to_out[1](_to_ncdhw(out, spatial))
        if prenorm is not None and residual:
            out = skip + out
        return out


def _to_bnc(x):
    """NCDHW (B, C, Z, A, R) -> contiguous (B, N, C)."""
    return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1, x.shape[1]).contiguous()


def _to_ncdhw(t, spatial):
    """(B, N, C) -> NCDHW (B, C, *spatial), a view."""
    return t.reshape(t.shape[0], *spatial, t.shape[2]).permute(0, 4, 1, 2, 3)


def group_norm1(x, scale, bias, eps=1e-5):
    """GroupNorm(num_groups=1) with explicit parameters: f32 statistics over
    all non-batch axes, cast back to x's dtype (JAX ``_group_norm1``)."""
    return F.group_norm(x.float(), 1, scale, bias, eps).to(x.dtype)


class Attention(nn.Module):
    """Full softmax attention over the flattened voxel grid (reference
    :246-278; JAX nn_modules.py:368-401): a 1x1 qkv conv without bias,
    ``blockwise_attention`` over (B, heads, N, dim_head), a 1x1 output conv.
    Channel index of q, k, v = h * dim_head + d.  On the card the attention
    is K4 at every N, differentiated by its backward kernel."""

    def __init__(self, dim, heads=4, dim_head=DIM_HEAD, cylindrical=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = Conv3d(dim, 3 * hidden, 1, cylindrical=cylindrical, bias=False,
                             dtype=dtype, generator=generator)
        self.to_out = Conv3d(hidden, dim, 1, cylindrical=cylindrical, dtype=dtype,
                             generator=generator)

    def forward(self, x):
        b, _, *spatial = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = (t.reshape(b, h, d, -1).transpose(2, 3).contiguous()
                   for t in self.to_qkv(x).chunk(3, dim=1))  # (B, H, N, D)
        out = blockwise_attention(q, k, v)
        return self.to_out(out.transpose(2, 3).reshape(b, h * d, *spatial))


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.norm = GroupNorm(1, dim)
        self.fn = fn


class PreNormResidual(nn.Module):
    """x + fn(GroupNorm1(x)) (reference Residual(PreNorm(...)) :111-117,
    :321-329; JAX nn_modules.py:606-633).  When fn is a heads-1
    `LinearAttention`, the whole block is one `fused_attention_block`: the
    K1/K2 kernels on the card, their plain versions on the CPU."""

    def __init__(self, dim, fn):
        super().__init__()
        self.fn = PreNorm(dim, fn)

    def forward(self, x):
        norm, fn = self.fn.norm, self.fn.fn
        if isinstance(fn, LinearAttention) and fn.heads == 1:
            return fn(x, prenorm=(norm.weight, norm.bias), residual=True)
        return x + fn(norm(x))


def downsample_module(dim, cylindrical, compress_Z, dtype, generator):
    z_stride = 2 if compress_Z else 1
    return Conv3d(dim, dim, (3, 4, 4), stride=(z_stride, 2, 2), padding=1,
                  cylindrical=cylindrical, dtype=dtype, generator=generator)


def upsample_module(dim, extra_upsample, cylindrical, compress_Z, dtype, generator):
    z_stride = 2 if compress_Z else 1
    z_kernel = 4 if extra_upsample[0] > 0 else 3
    extra = (0, extra_upsample[1], extra_upsample[2])
    return Conv3dTranspose(dim, dim, (z_kernel, 4, 4), stride=(z_stride, 2, 2),
                           padding=1, output_padding=extra, cylindrical=cylindrical,
                           dtype=dtype, generator=generator)


class CondUnet(nn.Module):
    """Conditional 3D U-Net (reference models.py:523-777); NCDHW in and out."""

    def __init__(self, channels=1, out_dim=1, layer_sizes: Sequence[int] = (32, 32, 64, 32),
                 cond_dim=128, resnet_block_groups=8, mid_attn=False, block_attn=False,
                 compress_Z=False, cylindrical=False, data_shape=(45, 16, 9),
                 time_embed=True, cond_embed=True, cond_size=1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        ls = list(layer_sizes)
        in_out = list(zip(ls[:-1], ls[1:]))
        self.num_resolutions = len(in_out)
        self.data_shape, self.compress_Z = tuple(data_shape), compress_Z
        self.dtype = dtype
        half = cond_dim // 2
        kw = dict(cylindrical=cylindrical, dtype=dtype, generator=generator)

        def resnet(i, o, cond=cond_dim):
            return ResnetBlock(i, o, cond, resnet_block_groups, **kw)

        def attn_block(dim):
            return PreNormResidual(dim, LinearAttention(dim, **kw))

        self.init_conv = Conv3d(channels, ls[0], 3, padding=1, **kw)
        self.time_mlp = cond_mlp(1, half // 2, half, half, time_embed, True, dtype, generator)
        self.cond_mlp = cond_mlp(
            cond_size, half // 2 if cond_embed else max(cond_size, half // 2), half, half,
            cond_embed, False, dtype, generator,
        )

        self.downs, self.downs_attn = nn.ModuleList(), nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            level = [resnet(dim_in, dim_out), resnet(dim_out, dim_out)]
            if ind < self.num_resolutions - 1:
                level.append(downsample_module(dim_out, cylindrical, compress_Z, dtype, generator))
            self.downs.append(nn.ModuleList(level))
            if block_attn:
                self.downs_attn.append(attn_block(dim_out))

        mid = ls[-1]
        self.mid_block1 = resnet(mid, mid)
        self.mid_attn = attn_block(mid) if mid_attn else None
        self.mid_block2 = resnet(mid, mid)

        extras = self.compute_extra_upsamples(data_shape, self.num_resolutions, compress_Z)
        self.ups, self.ups_attn = nn.ModuleList(), nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(reversed(in_out)):
            level = [resnet(2 * dim_out, dim_in), resnet(dim_in, dim_in)]
            if ind < self.num_resolutions - 1:
                level.append(upsample_module(dim_in, extras.pop(), cylindrical, compress_Z,
                                             dtype, generator))
            self.ups.append(nn.ModuleList(level))
            if block_attn:
                self.ups_attn.append(attn_block(dim_in))

        self.final_conv = nn.Sequential(
            resnet(ls[0], ls[0], cond=None), Conv3d(ls[0], out_dim, 1, **kw)
        )

    @staticmethod
    def compute_extra_upsamples(data_shape, num_resolutions, compress_Z):
        """Shape bookkeeping for odd dims (reference models.py:621-635)."""
        cur = tuple(data_shape)
        extras = []
        for _ in range(num_resolutions - 1):
            extras.append(((cur[0] + 1) % 2, cur[1] % 2, cur[2] % 2))
            z = cur[0] if not compress_Z else math.ceil(cur[0] / 2.0)
            cur = (z, cur[1] // 2, cur[2] // 2)
        return extras

    def forward(self, x, cond, time):
        x = self.init_conv(x.to(self.dtype))
        conditions = torch.cat([self.time_mlp(time), self.cond_mlp(cond)], dim=-1)

        hs = []
        for ind, level in enumerate(self.downs):
            x = level[0](x, conditions)
            x = level[1](x, conditions)
            if len(self.downs_attn):
                x = self.downs_attn[ind](x)
            hs.append(x)
            if len(level) > 2:
                x = level[2](x)

        x = self.mid_block1(x, conditions)
        if self.mid_attn is not None:
            x = self.mid_attn(x)
        x = self.mid_block2(x, conditions)

        for ind, level in enumerate(self.ups):
            x = torch.cat([x, hs.pop()], dim=1)
            x = level[0](x, conditions)
            x = level[1](x, conditions)
            if len(self.ups_attn):
                x = self.ups_attn[ind](x)
            if len(level) > 2:
                x = level[2](x)

        x = self.final_conv[0](x)
        return self.final_conv[1](x).float()
