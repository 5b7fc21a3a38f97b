"""In-model (optionally trainable) HGCal GLaM converter.

Port of ``calodiffusion_tpu/models/hgcal_converter.py`` (reference:
calodiffusion/utils/HGCal_utils.py Embeder/Decoder :295-353, HGCalConverter
:517-690).  Used when ``HGCAL`` is set without "pre-embed": the U-Net sees
the regular (alpha x R) embedded grid, and the encode and decode run inside
the network's forward.  ``embeder.mat`` (L, out, ncell) and ``decoder.mat``
(L, ncell, out), the reference names, start at the geometric maps and their
pseudo-inverses (``HGCalConverter.init(norm=False)``).  With
``TRAINABLE_EMBED`` they are parameters, multiplied by the masks of the
local geometric neighbourhood in every forward, so that a masked entry
gets no gradient; frozen, they are non-persistent buffers (the JAX package
keeps them as module constants, outside its parameter tree).  Each
contraction is one batched f32 product over the layer stack, whatever the
network's precision.
"""

from __future__ import annotations

import torch
from torch import nn

from calodiffusion_tpu_torch.utils import hgcal_utils


class _Mat(nn.Module):
    """One GLaM matrix stack under the reference name ``.mat``, with its mask."""

    def __init__(self, mat, mask, trainable: bool):
        super().__init__()
        mat = torch.from_numpy(mat.copy())
        if trainable:
            self.mat = nn.Parameter(mat)
        else:
            self.register_buffer("mat", mat, persistent=False)
        self.register_buffer("mask", torch.from_numpy(mask.astype("float32")),
                             persistent=False)
        self.trainable = trainable

    def forward(self):
        return self.mat * self.mask if self.trainable else self.mat


class HGCalConverterModule(nn.Module):
    """GLaM encode (B, L, ncell) -> (B, L, alpha, r) and decode back, f32."""

    def __init__(self, config: dict, device=None):
        """The geometric maps of ``config`` (``HGCalConverter.init(norm=
        False)``, its pseudo-inverses taken on ``device``'s kind, the card
        unless it is the CPU)."""
        super().__init__()
        conv = hgcal_utils.cached_converter(config, norm=False, device=device)
        trainable = bool(config.get("TRAINABLE_EMBED", False))
        self.embeder = _Mat(conv.enc_mat, conv.enc_mask, trainable)
        self.decoder = _Mat(conv.dec_mat, conv.dec_mask, trainable)
        self.num_alpha_bins = conv.num_alpha_bins
        self.num_r_bins = conv.num_r_bins

    def enc(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, ncell) or the SHAPE_PAD layout (B, 1, L, ncell) -> (B, L,
        alpha, r) (JAX diffusion.py:63-68)."""
        x = x.reshape(x.shape[0], *x.shape[-2:]).float()
        out = torch.einsum("len,bln->ble", self.embeder(), x)
        return out.reshape(*out.shape[:-1], self.num_alpha_bins, self.num_r_bins)

    def dec(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L, alpha, r) -> (B, L, ncell)."""
        flat = x.float().reshape(*x.shape[:-2], self.num_alpha_bins * self.num_r_bins)
        return torch.einsum("lne,ble->bln", self.decoder(), flat)

    def forward(self, x):
        return self.enc(x)
