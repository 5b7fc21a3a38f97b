"""CaloDiffusion model: conditional denoiser + diffusion plumbing.

Port of ``calodiffusion_tpu/models/diffusion.py`` (reference:
calodiffusion/models/diffusion.py, calodiffusion.py).  Showers enter and
leave as ``(B, 1, Z, A, R)``, flat ``(B, N)`` for dataset 1's in-model
geometry embed (``SHOWER_EMBED: "orig-NN"``), or HGCal's cells ``(B, L,
ncell)`` through the in-model GLaM (``HGCAL`` without "pre-embed"), as in
the JAX package; the network inside is NCDHW.  HGCal's shipped configs
(``"NN-pre-embed"``) take the loader's GLaM-encoded grid, and ``generate``
decodes it in ``hgcal_utils.reverse_norm_hgcal`` (dense on the model's
device, or the sparse draws).

With ``QUANT_INT8`` sampling runs the U-Net's block, residual and
downsampling convolutions in W8A8 int8 (``ops/quant.py``; Q1 on the card):
``prepare_int8`` calibrates their static activation scales, ``sample``
calibrates lazily and ``generate`` on the first batch's conditioning.
Training and the validation loss never run int8.

``SHOWER_EMBED`` with "FCN" (and "orig") runs the dense ``ResNetDense`` on
flat showers in place of the U-Net; ``REMAT`` recomputes the U-Net's blocks
in the backward pass; ``unet_options`` passes the CondUnet options no config
key sets (``use_convnext``, ``convnext_mult``, ``no_time``).  With
``COLD_DIFFU`` sampling starts from the cold prior (``gen_cold_image``: the
energy-binned average shower plus ``COLD_NOISE`` times the noise times the
binned std), loaded by ``init_cold_diffu`` from ``AVG_SHOWER_LOC`` or given
by ``set_cold_prior``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterable, Optional

import numpy as np
import torch
from torch import nn

from calodiffusion_tpu_torch.models.converters import NNConverter
from calodiffusion_tpu_torch.models.hgcal_converter import HGCalConverterModule
from calodiffusion_tpu_torch.models.losses import get_loss
from calodiffusion_tpu_torch.models.nn_modules import CondUnet, ResNetDense, quantizable_convs
from calodiffusion_tpu_torch.ops import quant
from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import randn
from calodiffusion_tpu_torch.utils import hgcal_utils, preprocessing
from calodiffusion_tpu_torch.utils.config import load_config
from calodiffusion_tpu_torch.utils.device import resolve_device
from calodiffusion_tpu_torch.utils.geom import GeomConverter
from calodiffusion_tpu_torch.utils.xml_handler import XMLHandler

EMBED = "NN_embed."  # the state_dict prefix of the in-model embed's weights


def net_key(key: str) -> str:
    """The name within ``CaloDiffusionNet`` of a ``CaloDiffusion.state_dict``
    key: the embed's keep theirs, the U-Net's take ``unet.``."""
    return key if key.startswith(EMBED) else "unet." + key


class CaloDiffusionNet(nn.Module):
    """The denoiser network: the optional in-model geometry embed
    (``NN_embed``: dataset 1's ``NNConverter`` or HGCal's
    ``HGCalConverterModule``), the constant R/Z and phi images concatenated
    to the shower on channels ([x, R, Z, phi]), the U-Net, and the embed's
    decode.

    forward(x, E, t_emb, layers) -> prediction with x's layout: (B, 1, Z, A,
    R), or the embed's cells: flat (B, N), or HGCal's (B, [1,] L, ncell).
    """

    def __init__(self, unet_kwargs: dict, layer_cond: bool, rz_images, dtype, generator=None,
                 phi_image=None, nn_embed: Optional[nn.Module] = None,
                 fully_connected: bool = False):
        super().__init__()
        self.layer_cond = layer_cond
        # the dense shower model ("FCN" embeds) keeps the U-Net's name, so
        # its state_dict carries the reference's ResNet keys unprefixed
        net = ResNetDense if fully_connected else CondUnet
        self.unet = net(**unet_kwargs, dtype=dtype, generator=generator)
        self.fully_connected = fully_connected
        self.NN_embed = nn_embed
        images = ([] if rz_images is None else list(rz_images)) + (
            [] if phi_image is None else [phi_image])
        if images:  # (n, Z, A, R): R image, Z image, phi image
            self.register_buffer(
                "images", torch.as_tensor(np.stack(images))[None], persistent=False
            )
        else:
            self.images = None

    def forward(self, x, E, t_emb, layers=None):
        if self.layer_cond and layers is not None:
            E = torch.cat([E, layers], dim=1)
        if self.fully_connected:
            return self.unet(x, E, t_emb).float()
        orig_shape = x.shape
        if self.NN_embed is not None:  # cells -> (B, 1, Z, A, R), f32
            x = self.NN_embed.enc(x)[:, None]
        if self.images is not None:
            img = self.images.expand(x.shape[0], -1, *x.shape[2:])
            x = torch.cat([x, img.to(x.dtype)], dim=1)
        out = self.unet(x, cond=E, time=t_emb)
        if self.NN_embed is not None:
            out = self.NN_embed.dec(out[:, 0]).reshape(orig_shape)
        return out


class CaloDiffusion:
    """Config-driven diffusion model (reference CaloDiffusion class parity).

    ``device`` defaults to the CUDA card; the weights are initialised from
    ``generator`` (a CPU ``torch.Generator``) or loaded with
    ``load_state_dict``.  ``unet_options``: CondUnet options that no config
    key sets (``use_convnext``, ``convnext_mult``, ``no_time``)."""

    def __init__(self, config, n_steps: int = 400, loss_type: str = "l2",
                 device=None, generator: Optional[torch.Generator] = None,
                 unet_options: Optional[dict] = None):
        self.config = load_config(config)
        c = self.config
        self.device = resolve_device(device)
        self.nsteps = n_steps
        self.loss_type = loss_type

        shower_embed = c.get("SHOWER_EMBED", "")
        self.hgcal = bool(c.get("HGCAL", False))
        self.pre_embed = "pre-embed" in shower_embed
        self.fully_connected = "FCN" in shower_embed
        if self.fully_connected and "orig" not in shower_embed:
            # the JAX package's dense layers would act on the padded grid's
            # last axis and fail at batch > 1 (the reference's latent bug)
            raise ValueError(
                f"SHOWER_EMBED={shower_embed!r}: the dense FCN model takes flat showers; "
                "add \"orig\" (e.g. \"FCN-orig\")"
            )
        if self.pre_embed and not self.hgcal:
            # the JAX package fails here too: its loader unpickles BIN_FILE
            # as an HGCal geometry (and its model at an "orig-" layout)
            raise ValueError(
                f"SHOWER_EMBED={shower_embed!r} needs HGCAL: the pre-embed is the "
                "loader's HGCal GLaM encode and BIN_FILE an HGCal geometry pickle"
            )
        self.time_embed = c.get("TIME_EMBED", "sin")
        self.dataset_num = c.get("DATASET_NUM", 2)
        self.training_objective = c.get("TRAINING_OBJ", "noise_pred")
        self.layer_cond = "layer" in c.get("SHOWERMAP", "")
        self.loss_function = get_loss(self.training_objective)(
            c, self.nsteps, self.loss_type
        )
        # flat showers through the embed (JAX diffusion.py:128-131)
        self.orig_shape = "orig" in shower_embed
        self._data_shape = tuple(c["SHAPE_ORIG" if self.orig_shape else "SHAPE_PAD"][1:])

        # constant conditioning images over SHAPE_FINAL (Z, A, R)
        shape_final = c["SHAPE_FINAL"][1:]
        rz_images = phi_image = None
        if not self.fully_connected and c.get("R_Z_INPUT", False):
            R_image, Z_image = preprocessing.create_R_Z_image(
                dataset_num=self.dataset_num, scaled=True, shape=shape_final
            )
            rz_images = (R_image[0], Z_image[0])  # (Z, A, R)
        if not self.fully_connected and c.get("PHI_INPUT", False):
            phi_image = preprocessing.create_phi_image(shape=shape_final)[0]

        # the in-model embed: dataset 1's (its pion configs set DATASET_NUM
        # 0), or HGCal's GLaM where the loader has not encoded (JAX
        # diffusion.py:147-157)
        nn_embed = None
        if self.fully_connected:  # the dense model takes the showers as they are
            pass
        elif "NN" in shower_embed and not self.hgcal:
            part = "photon" if self.dataset_num == 1 else "pion"
            nn_embed = NNConverter(GeomConverter(XMLHandler(part, c["BIN_FILE"])))
        elif self.hgcal and not self.pre_embed:
            nn_embed = HGCalConverterModule(c, device=self.device)

        # network sizing (reference calodiffusion.py:39-81); HGCal's E holds
        # three gen-info columns
        in_channels = (3 if rz_images is not None else 1) + (phi_image is not None)
        cond_size = (2 + c["SHAPE_FINAL"][2] if self.layer_cond else 1) + 2 * self.hgcal
        if self.fully_connected:  # JAX diffusion.py:160-166 (flax infers cond_size)
            unet_kwargs = dict(
                cond_emb_dim=c["COND_SIZE_UNET"],
                dim_in=c["SHAPE_ORIG"][1],
                num_layers=c["NUM_LAYERS_LINEAR"],
                hidden_dim=512,
                cond_size=cond_size,
            )
        else:
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
                remat=bool(c.get("REMAT", False)),
                **(unet_options or {}),
            )
        self.cond_size = cond_size
        self.dtype = torch.bfloat16 if c.get("PRECISION", "f32") == "bf16" else torch.float32
        self.net = CaloDiffusionNet(
            unet_kwargs, self.layer_cond, rz_images, self.dtype, generator,
            phi_image=phi_image, nn_embed=nn_embed, fully_connected=self.fully_connected,
        ).to(self.device).eval()
        # the module denoise calls: net, or a trainer's DDP wrapper of it
        self.forward_net: nn.Module = self.net
        self._int8_scales: Optional[dict] = None  # {flax path: activation scale}
        # the cold-diffusion prior (init_cold_diffu / set_cold_prior)
        self._avg_showers = self._std_showers = self._E_bins = None

    # -- weights -------------------------------------------------------------
    def state_dict(self) -> dict:
        """The network's weights under the reference names: the CondUnet's
        keys, and the embed's where the config has one: dataset 1's
        ``NN_embed.encs.{i}.weight`` and ``NN_embed.decs.{i}.weight``, a
        trainable GLaM's ``NN_embed.embeder.mat`` and
        ``NN_embed.decoder.mat`` (a frozen one's matrices are not weights:
        the geometry gives them)."""
        return {k.removeprefix("unet."): v for k, v in self.net.state_dict().items()}

    def load_state_dict(self, state_dict: dict) -> None:
        self.net.load_state_dict({net_key(k): v for k, v in state_dict.items()})

    def parameters(self):
        """The trainable tensors (the U-Net's and the embed's f32
        parameters), for an optimizer."""
        return self.net.parameters()

    def named_parameters(self):
        for k, p in self.net.named_parameters():
            yield k.removeprefix("unet."), p

    def embed_roundtrip(self, x):
        """Diagnostic: encode -> decode ``x`` (training-representation
        showers) through the model's geometry embed; identity when the model
        has none (JAX diffusion.py:250-281).  The rank-limited decode loses
        information even on real showers, so the embed's round trip is the
        fidelity ceiling of any model behind it."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        embed = self.net.NN_embed
        if embed is None:
            return x
        with torch.no_grad():
            return embed.dec(embed.enc(x)).reshape(x.shape)

    # -- cold diffusion ------------------------------------------------------
    def init_cold_diffu(self):
        """Load the per-energy-bin average and std showers and the bins'
        edges (``avg_showers``, ``std_showers``, ``E_bins``) from the h5 at
        ``AVG_SHOWER_LOC`` (``tools/create_average_showers.py`` writes it;
        JAX diffusion.py:206-220)."""
        import h5py as h5

        with h5.File(self.config["AVG_SHOWER_LOC"], "r") as f:
            return self.set_cold_prior(f["avg_showers"][:], f["std_showers"][:],
                                       f["E_bins"][:])

    def set_cold_prior(self, avg_showers, std_showers, E_bins):
        """Take the cold prior's arrays: (nbins, *shower shape) averages and
        stds in the loader's layout and the nbins bin edges, as f32 on the
        model's device."""
        def put(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._avg_showers, self._std_showers = put(avg_showers), put(std_showers)
        self._E_bins = put(E_bins)
        return self

    def has_cold_prior(self) -> bool:
        return self._avg_showers is not None

    def lookup_avg_std_shower(self, E):
        """The average and std showers of E's bins: searchsorted(E_bins, E)
        - 1 (left side, as ``jnp.searchsorted``), clipped to the bins."""
        idx = torch.searchsorted(self._E_bins, E.reshape(-1).float().contiguous()) - 1
        idx = idx.clamp(0, self._avg_showers.shape[0] - 1)
        return self._avg_showers[idx], self._std_showers[idx]

    def gen_cold_image(self, E, cold_noise_scale, noise):
        """The cold "noise": the binned average shower plus
        ``cold_noise_scale`` x noise x the binned std (JAX
        diffusion.py:229-232)."""
        avg, std = self.lookup_avg_std_shower(E)
        return avg + cold_noise_scale * noise * std

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
        pred = self.forward_net(x * scales["c_in"], E, t_emb, layers)

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

    # -- int8 sampling (ops/quant.py) ----------------------------------------
    def int8_sampling_enabled(self) -> bool:
        return bool(self.config.get("QUANT_INT8", False)) and quant.int8_allowed()

    def quantizable_convs(self) -> dict:
        """{flax path: conv} of the U-Net's quantizable convolutions; the
        upsampling transposes only under ``CALODIFF_INT8_TRANSPOSE=1``."""
        if self.fully_connected:  # the dense model has no convolutions
            return {}
        convs = quantizable_convs(self.net.unet)
        if quant.transpose_allowed():
            return convs
        return {k: v for k, v in convs.items() if "Conv3dTranspose" not in k}

    @torch.inference_mode()
    def prepare_int8(self, n_sigmas: int = 8, batch: int = 8, E=None, layers=None,
                     margin: float = 1.1, generator: Optional[torch.Generator] = None,
                     noise=None) -> dict:
        """Calibrate the static activation scales of W8A8 sampling (JAX
        diffusion.py:362-452): ``n_sigmas`` network calls on ``noise * sigma``
        (scaled by c_in), the sigmas geometric over the discrete table (floor
        1e-3), each quantizable conv's input abs-max recorded by a forward
        pre-hook; scale = max(absmax * margin, 1e-8) / 127, the max over the
        sigmas.  ``E`` / ``layers``: the real conditioning (its first 64 rows;
        layers tiled up to E's rows), else drawn (uniform E, normal layers).
        ``noise``: the unit normals of each sigma, (batch, *data shape), else
        drawn from ``generator`` (a fixed seed where None).  Then
        ``QUANT_INT8_EXCLUDE`` drops the paths it matches.  The table is kept
        on the model; call again after loading other weights."""
        dev = self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(4321)
        if E is not None:
            E = torch.as_tensor(E, dtype=torch.float32, device=dev)[:64]
            batch = E.shape[0]
        else:
            E = torch.rand((batch, 3 if self.hgcal else 1), generator=generator,
                           device=generator.device).to(dev)
        if not self.layer_cond:
            layers = None
        elif layers is not None:
            layers = torch.as_tensor(layers, dtype=torch.float32, device=dev)[:batch]
            if layers.shape[0] < batch:  # tile up to the E rows
                layers = layers.repeat(-(-batch // layers.shape[0]), 1)[:batch]
        else:
            layers = randn((batch, self.config["SHAPE_FINAL"][2] + 1), generator, dev)

        sig_tab = schedules.discrete_sigmas(max(self.nsteps, 2))
        lo, hi = max(float(sig_tab.min()), 1e-3), float(sig_tab.max())
        shape = (batch, *self._data_shape)
        absmax: dict = {}
        hooks = [conv.register_forward_pre_hook(
                     lambda _, args, path=path: absmax.__setitem__(
                         path, args[0].abs().max().float()))
                 for path, conv in self.quantizable_convs().items()]
        table: dict = {}
        try:
            for i, s in enumerate(np.geomspace(lo, hi, n_sigmas)):
                z = (randn(shape, generator, dev) if noise is None
                     else torch.as_tensor(noise[i], dtype=torch.float32, device=dev))
                sigma = torch.full((batch,) + (1,) * (len(shape) - 1), float(s), device=dev)
                t_emb = self.do_time_embed(sigma.reshape(-1))
                c_in = self.loss_function.get_scaling(sigma)["c_in"]
                absmax.clear()
                self.net(z * float(s) * c_in, E, t_emb, layers)
                table = quant.merge_stats(table, quant.scales_from_absmax(
                    {k: v.item() for k, v in absmax.items()}, margin))
        finally:
            for h in hooks:
                h.remove()
        # QUANT_INT8_EXCLUDE: the paths it matches (whole segments) stay float
        excl = self.config.get("QUANT_INT8_EXCLUDE") or []
        if excl:
            dropped = [p for p in table if any(quant.path_matches(p, e) for e in excl)]
            table = {p: v for p, v in table.items() if p not in dropped}
            print(f"int8: excluding {len(dropped)} convs matching {excl}", flush=True)
        self._int8_scales = table
        return table

    @contextlib.contextmanager
    def int8_scope(self):
        """Inside it, with ``QUANT_INT8`` on, each quantizable conv in the
        scale table runs int8 (calibrated first where there is no table);
        every conv runs float again after it.  Nothing happens otherwise."""
        if not self.int8_sampling_enabled():
            yield
            return
        if self._int8_scales is None:
            self.prepare_int8()
        convs = self.quantizable_convs()
        try:
            for path, conv in convs.items():
                conv.int8_scale = self._int8_scales.get(path)
            yield
        finally:
            for conv in convs.values():
                conv.int8_scale = None

    # -- sampling ------------------------------------------------------------
    def make_sampler(self, sampler_name: Optional[str] = None):
        from calodiffusion_tpu_torch.samplers import get_sampler

        name = sampler_name or self.config.get("SAMPLER", "DDim")
        return get_sampler(name)(self.config)

    @torch.inference_mode()
    def sample(self, energy, layers=None, num_steps: int = 400,
               generator: Optional[torch.Generator] = None,
               sample_offset: int = 0, debug: bool = False, sampler=None, mesh=None):
        """Generate one batch of showers (reference diffusion.py:77-104).

        With a ``parallel/mesh.py`` ``mesh``, ``energy`` and ``layers`` are
        the global batch's and each rank samples and returns its rows
        (``mesh.row_range``), from its rows of the global start noise and of
        every later draw or injected noise table (``mesh.row_draws``): the
        ranks' rows, concatenated, are one process's sample.

        Batches above ``SAMPLE_MICROBATCH`` (default 128) that it divides
        run as sequential microbatches of that size.  With ``QUANT_INT8``
        the convolutions run int8 (``int8_scope``).  With ``COLD_DIFFU`` and
        a cold prior loaded, the start is ``gen_cold_image`` of the unit
        noise, before the microbatches (JAX diffusion.py:490-503)."""
        if sampler is None:
            sampler = self.make_sampler()
        if mesh is not None:
            lo, hi = mesh_lib.row_range(mesh, energy.shape[0])
            with mesh_lib.row_draws(mesh, hi - lo):
                return self.sample(energy[lo:hi], None if layers is None else layers[lo:hi],
                                   num_steps, generator, sample_offset, debug, sampler)
        B = energy.shape[0]
        start = randn((B, *self._data_shape), generator, self.device)
        if self.config.get("COLD_DIFFU", False) and self.has_cold_prior():
            start = self.gen_cold_image(energy[:, :1], self.config.get("COLD_NOISE", 1.0), start)

        micro = int(self.config.get("SAMPLE_MICROBATCH", 128) or 0)
        with self.int8_scope():
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
                 sample_offset: int = 0, sampler=None,
                 debug: bool = False, roundtrip: bool = False,
                 sparse_decoding: bool = False, sparse_per_batch: bool = False,
                 rng: Optional[np.random.Generator] = None, mesh=None) -> tuple[Any, Any]:
        """Sample every ``(E, layers, batch)`` of ``data_loader`` and invert
        the preprocessing (reference diffusion.py:118-197).  Returns numpy
        (showers of SHAPE_ORIG, energies).  With a ``mesh`` each rank samples
        and inverts its rows of every batch (``sample``'s split) and returns
        them: with one batch the ranks' outputs, concatenated, are one
        process's.  With ``debug`` the first batch's
        reverse trajectory is plotted against the loader's showers
        (``_debug_sample_plot``).  ``roundtrip`` samples nothing: the
        loader's own showers pass through the embed's encode and decode
        (``embed_roundtrip``) before the inverse preprocessing, the showers
        of a perfect diffusion model behind this embed.  HGCal's decode
        takes ``sparse_decoding`` / ``sparse_per_batch`` and draws from
        ``rng`` (``reverse_norm``).  With ``QUANT_INT8`` and no scale table
        the first batch's conditioning calibrates one, its noise drawn from
        ``generator``."""
        if sampler is None:
            sampler = self.make_sampler()

        def to_numpy(t):
            return None if t is None else t.float().cpu().numpy()

        generated, energies, layers_all = [], [], []
        for i, (E, layers_, d_batch) in enumerate(data_loader):
            E_t = torch.as_tensor(np.asarray(E, np.float32), device=self.device)
            lay = (torch.as_tensor(np.asarray(layers_, np.float32), device=self.device)
                   if self.layer_cond else None)
            if i == 0 and self.int8_sampling_enabled() and self._int8_scales is None:
                self.prepare_int8(E=E_t, layers=lay, generator=generator)
            lo, hi = mesh_lib.row_range(mesh, len(E_t))
            E, layers_ = np.asarray(E)[lo:hi], (None if layers_ is None
                                                else np.asarray(layers_)[lo:hi])
            if roundtrip:
                out = self.embed_roundtrip(np.asarray(d_batch)[lo:hi])
            else:
                out = self.sample(E_t, layers=lay, num_steps=sample_steps,
                                  generator=generator, sample_offset=sample_offset,
                                  sampler=sampler, debug=debug, mesh=mesh)
            if debug and not roundtrip:
                out, xs, x0s = out
                if i == 0 and xs is not None:  # some samplers expose no trajectory
                    self._debug_sample_plot(to_numpy(xs), to_numpy(x0s),
                                            np.asarray(d_batch))
            generated.append(to_numpy(out))
            energies.append(np.asarray(E, np.float32))
            if self.layer_cond:
                layers_all.append(np.asarray(layers_, np.float32))

        layers_np = np.concatenate(layers_all) if layers_all else None
        generated, energies = self.reverse_norm(
            np.concatenate(generated), np.concatenate(energies), layers_np,
            sparse_decoding=sparse_decoding, sparse_per_batch=sparse_per_batch, rng=rng)
        if not self.orig_shape:
            generated = generated.reshape(self.config["SHAPE_ORIG"])
        energies = np.reshape(energies, (energies.shape[0], -1))
        return generated, energies

    def reverse_norm(self, generated, energies, layers=None, sparse_decoding: bool = False,
                     sparse_per_batch: bool = False,
                     rng: Optional[np.random.Generator] = None):
        """Invert the preprocessing of numpy showers and energies, with
        ``layers`` as the layer energies; HGCal's through
        ``hgcal_utils.reverse_norm_hgcal``: the pre-embed's GLaM decode
        (the process's one converter) dense on the model's device, or
        sparse, drawn from ``rng`` (a fresh Generator where None, as in the
        JAX package)."""
        c = self.config
        kwargs = dict(
            shape=c["SHAPE_FINAL"], config=c, emax=c["EMAX"], emin=c["EMIN"],
            layerE=layers, logE=c["logE"], binning_file=c["BIN_FILE"],
            max_deposit=c["MAXDEP"], showerMap=c["SHOWERMAP"],
            dataset_num=self.dataset_num, orig_shape=self.orig_shape,
            ecut=float(c["ECUT"]),
        )
        if not self.hgcal:
            return preprocessing.reverse_norm(generated, energies, **kwargs)
        return hgcal_utils.reverse_norm_hgcal(
            generated, energies, embed=self.pre_embed,
            NN_embed=(hgcal_utils.make_pre_embed_converter(c, device=self.device)
                      if self.pre_embed else None),
            sparse_decoding=sparse_decoding, sparse_per_batch=sparse_per_batch, rng=rng,
            device=self.device, **kwargs,
        )

    def _debug_sample_plot(self, xs, x0s, data_batch, plot_folder: str = "./plots/"):
        """Histogram the normalized-voxel distribution at checkpoints along
        the reverse trajectory vs Geant (reference diffusion.py:199-235)."""
        import os

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(plot_folder, exist_ok=True)
        n = xs.shape[0]
        steps = sorted(set([0, n // 4, n // 2, 3 * n // 4, 9 * n // 10,
                            max(n - 10, 0), max(n - 5, 0), n - 1]))
        name = self.config.get("CHECKPOINT_NAME", "debug")
        for j in steps:
            series = [("gen", xs[j])]
            if x0s is not None:  # some samplers expose no x0 trajectory
                series.append(("x0", x0s[j]))
            for tag, arr in series:
                fig = plt.figure(figsize=(8, 6))
                plt.hist(arr.reshape(-1), bins=40, density=True,
                         histtype="step", color="blue", label="Diffu")
                plt.hist(data_batch.reshape(-1), bins=40, density=True,
                         histtype="step", color="black", label="Geant4")
                plt.xlabel("Normalized Voxel Energy")
                plt.legend()
                fig.savefig(os.path.join(
                    plot_folder, f"{name}_norm_voxels_{tag}_step{j}.png"
                ))
                plt.close(fig)
