"""CaloDiffusion model: conditional denoiser + diffusion plumbing.

Port of ``calodiffusion_tpu/models/diffusion.py`` for configs without a
geometry embed (reference: calodiffusion/models/diffusion.py,
calodiffusion.py).  Showers enter and leave as ``(B, 1, Z, A, R)``, as in
the JAX package; the network inside is NCDHW.

Not ported yet: geometry embeds (``SHOWER_EMBED``), HGCal, the phi image,
the cold-diffusion prior and int8 sampling.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np
import torch
from torch import nn

from calodiffusion_tpu_torch.models.losses import get_loss
from calodiffusion_tpu_torch.models.nn_modules import CondUnet
from calodiffusion_tpu_torch.samplers.base import randn
from calodiffusion_tpu_torch.utils import preprocessing
from calodiffusion_tpu_torch.utils.config import load_config
from calodiffusion_tpu_torch.utils.device import resolve_device

_NOT_PORTED = ("HGCAL", "PHI_INPUT", "COLD_DIFFU", "QUANT_INT8")


class CaloDiffusionNet(nn.Module):
    """The denoiser network without a geometry embed: the constant R/Z
    images concatenated to the shower on channels, then the U-Net.

    forward(x, E, t_emb, layers) -> prediction with x's (B, 1, Z, A, R) layout.
    """

    def __init__(self, unet_kwargs: dict, layer_cond: bool, rz_images, dtype, generator=None):
        super().__init__()
        self.layer_cond = layer_cond
        self.unet = CondUnet(**unet_kwargs, dtype=dtype, generator=generator)
        if rz_images is None:
            self.rz_images = None
        else:  # (2, Z, A, R): R image, Z image
            self.register_buffer(
                "rz_images", torch.as_tensor(np.stack(rz_images))[None], persistent=False
            )

    def forward(self, x, E, t_emb, layers=None):
        if self.layer_cond and layers is not None:
            E = torch.cat([E, layers], dim=1)
        if self.rz_images is not None:
            rz = self.rz_images.expand(x.shape[0], -1, *x.shape[2:])
            x = torch.cat([x, rz.to(x.dtype)], dim=1)
        return self.unet(x, cond=E, time=t_emb)


class CaloDiffusion:
    """Config-driven diffusion model (reference CaloDiffusion class parity).

    ``device`` defaults to the CUDA card; the weights are initialised from
    ``generator`` (a CPU ``torch.Generator``) or loaded with
    ``load_state_dict``."""

    def __init__(self, config, n_steps: int = 400, loss_type: str = "l2",
                 device=None, generator: Optional[torch.Generator] = None):
        self.config = load_config(config)
        c = self.config
        self.device = resolve_device(device)
        self.nsteps = n_steps
        self.loss_type = loss_type

        if c.get("SHOWER_EMBED", ""):
            raise NotImplementedError(
                f"SHOWER_EMBED={c['SHOWER_EMBED']!r} is not yet ported to "
                "calodiffusion_tpu_torch"
            )
        unported = [k for k in _NOT_PORTED if c.get(k, False)]
        if unported:
            raise NotImplementedError(
                f"{unported} not yet ported to calodiffusion_tpu_torch"
            )

        self.time_embed = c.get("TIME_EMBED", "sin")
        self.dataset_num = c.get("DATASET_NUM", 2)
        self.training_objective = c.get("TRAINING_OBJ", "noise_pred")
        self.layer_cond = "layer" in c.get("SHOWERMAP", "")
        self.loss_function = get_loss(self.training_objective)(
            c, self.nsteps, self.loss_type
        )
        self._data_shape = tuple(c["SHAPE_PAD"][1:])

        shape_final = c["SHAPE_FINAL"][1:]
        rz_images = None
        if c.get("R_Z_INPUT", False):
            R_image, Z_image = preprocessing.create_R_Z_image(
                dataset_num=self.dataset_num, scaled=True, shape=shape_final
            )
            rz_images = (R_image[0], Z_image[0])  # (Z, A, R)

        # network sizing (reference calodiffusion.py:39-81)
        in_channels = 3 if rz_images is not None else 1
        cond_size = 2 + c["SHAPE_FINAL"][2] if self.layer_cond else 1
        unet_kwargs = dict(
            cond_dim=c["COND_SIZE_UNET"],
            out_dim=1,
            channels=in_channels,
            layer_sizes=tuple(c["LAYER_SIZE_UNET"]),
            block_attn=c.get("BLOCK_ATTN", False),
            mid_attn=c.get("MID_ATTN", False),
            cylindrical=c.get("CYLINDRICAL", False),
            compress_Z=c.get("COMPRESS_Z", False),
            resnet_block_groups=c.get("BLOCK_GROUPS", 8),
            data_shape=tuple(shape_final[1:]),  # (Z, A, R)
            cond_embed=(c.get("COND_EMBED", "sin") == "sin"),
            cond_size=cond_size,
            time_embed=(c.get("TIME_EMBED", "sin") == "sin"),
        )
        self.cond_size = cond_size
        self.dtype = torch.bfloat16 if c.get("PRECISION", "f32") == "bf16" else torch.float32
        self.net = CaloDiffusionNet(
            unet_kwargs, self.layer_cond, rz_images, self.dtype, generator
        ).to(self.device).eval()

    # -- weights -------------------------------------------------------------
    def state_dict(self) -> dict:
        """U-Net weights under the reference CondUnet state_dict names."""
        return self.net.unet.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        self.net.unet.load_state_dict(state_dict)

    def parameters(self):
        """The trainable tensors (the U-Net's f32 parameters), for an optimizer."""
        return self.net.unet.parameters()

    def named_parameters(self):
        return self.net.unet.named_parameters()

    # -- diffusion math ------------------------------------------------------
    def do_time_embed(self, sigma):
        """sigma -> scalar time feature (reference calodiffusion.py:144-152)."""
        if self.time_embed == "sigma":
            return sigma / torch.sqrt(1 + sigma**2)
        if self.time_embed in ("log", "id", "sin"):
            return 0.5 * torch.log(sigma)
        raise ValueError(f"Unknown TIME_EMBED {self.time_embed}")

    def denoise(self, x, E=None, sigma=None, layers=None):
        """x0 estimate from the network prediction with the objective's
        in/skip/out scalings (reference calodiffusion.py:154-169)."""
        t_emb = self.do_time_embed(sigma.reshape(-1))
        scales = self.loss_function.get_scaling(sigma)
        pred = self.net(x * scales["c_in"], E, t_emb, layers)

        name = self.training_objective
        if "noise_pred" in name:
            return x - sigma * pred
        if "mean_pred" in name:
            return pred
        if "hybrid" in name or "minsnr" in name:
            return scales["c_skip"] * x + scales["c_out"] * pred
        raise ValueError(f"??? Training obj {name}")

    def denoise_fn(self):
        def fn(x, E=None, sigma=None, layers=None):
            return self.denoise(x, E=E, sigma=sigma, layers=layers)

        return fn

    def compute_loss(self, data, energy, generator: Optional[torch.Generator] = None,
                     noise=None, layers=None, time=None, rnd_normal=None):
        """The training loss of one batch (reference calodiffusion.py
        compute_loss); randomness not injected is drawn from ``generator``."""
        return self.loss_function(
            self.denoise_fn(), data, energy, generator,
            noise=noise, time=time, layers=layers, rnd_normal=rnd_normal,
        )

    # -- sampling ------------------------------------------------------------
    def make_sampler(self, sampler_name: Optional[str] = None):
        from calodiffusion_tpu_torch.samplers import get_sampler

        name = sampler_name or self.config.get("SAMPLER", "DDim")
        return get_sampler(name)(self.config)

    @torch.inference_mode()
    def sample(self, energy, layers=None, num_steps: int = 400,
               generator: Optional[torch.Generator] = None,
               sample_offset: int = 0, debug: bool = False, sampler=None):
        """Generate one batch of showers (reference diffusion.py:77-104).

        Batches above ``SAMPLE_MICROBATCH`` (default 128) that it divides
        run as sequential microbatches of that size."""
        if sampler is None:
            sampler = self.make_sampler()
        B = energy.shape[0]
        start = randn((B, *self._data_shape), generator, self.device)

        micro = int(self.config.get("SAMPLE_MICROBATCH", 128) or 0)
        if not debug and micro and B > micro and B % micro == 0:
            outs = []
            for lo in range(0, B, micro):
                sl = slice(lo, lo + micro)
                outs.append(sampler(
                    self, start[sl], energy[sl],
                    None if layers is None else layers[sl],
                    num_steps, sample_offset, generator, False,
                ))
            return torch.cat(outs)
        return sampler(self, start, energy, layers, num_steps, sample_offset,
                       generator, debug)

    def generate(self, data_loader: Iterable, sample_steps: int,
                 generator: Optional[torch.Generator] = None,
                 sample_offset: int = 0, sampler=None) -> tuple[Any, Any]:
        """Sample every ``(E, layers, batch)`` of ``data_loader`` and invert
        the preprocessing (reference diffusion.py:118-197).  Returns numpy
        (showers of SHAPE_ORIG, energies)."""
        c = self.config
        if sampler is None:
            sampler = self.make_sampler()

        generated, energies, layers_all = [], [], []
        for E, layers_, _ in data_loader:
            E_t = torch.as_tensor(np.asarray(E, np.float32), device=self.device)
            lay = (torch.as_tensor(np.asarray(layers_, np.float32), device=self.device)
                   if self.layer_cond else None)
            out = self.sample(E_t, layers=lay, num_steps=sample_steps,
                              generator=generator, sample_offset=sample_offset,
                              sampler=sampler)
            generated.append(out.float().cpu().numpy())
            energies.append(np.asarray(E, np.float32))
            if self.layer_cond:
                layers_all.append(np.asarray(layers_, np.float32))

        generated = np.concatenate(generated)
        energies = np.concatenate(energies)
        layers_np = np.concatenate(layers_all) if layers_all else None
        generated, energies = preprocessing.reverse_norm(
            generated, energies,
            shape=c["SHAPE_FINAL"], config=c,
            emax=c["EMAX"], emin=c["EMIN"], layerE=layers_np,
            logE=c["logE"], binning_file=c["BIN_FILE"],
            max_deposit=c["MAXDEP"], showerMap=c["SHOWERMAP"],
            dataset_num=self.dataset_num, orig_shape=False,
            ecut=float(c["ECUT"]),
        )
        generated = generated.reshape(c["SHAPE_ORIG"])
        energies = np.reshape(energies, (energies.shape[0], -1))
        return generated, energies
