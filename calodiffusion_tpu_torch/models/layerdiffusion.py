"""Two-stage layer-energy cascade model.

Port of ``calodiffusion_tpu/models/layerdiffusion.py`` (reference:
calodiffusion/models/layerdiffusion.py).  A dense ResNet diffusion model
(``ResNetDense``) samples the (total energy + per-layer energy) vector
first; the base U-Net then samples the shower conditioned on it.

The model holds both networks: the base U-Net of ``CaloDiffusion`` and
``layer_net``.  Its ``state_dict`` is the JAX package's two-part tree,
flattened: ``base_model.<CondUnet key>``, ``layer_model.<ResNetDense key>``
and, once set, the per-dim whitening statistics ``layer_model.whiten.mean``
and ``layer_model.whiten.std``.  The statistics are buffers: no optimizer
sees them and no gradient reaches them (the JAX package's
``stop_gradient``), but the EMA, SWA and checkpoints carry them as the JAX
parameter tree does.  Absent statistics mean identity whitening, which
keeps parity with the reference cascade.

The layer net computes in f32 whatever ``PRECISION`` says: the JAX package
builds it without a dtype.  ``set_layer_state(True)`` makes
``compute_loss`` train the layer net alone (the base U-Net then gets no
gradient).  Dataset 1's flat showers through the in-model embed take the
same path (``generate`` inverts them in their ``SHAPE_ORIG`` layout), and so
does HGCal: its layer net is conditioned on the three gen-info columns,
and ``generate`` decodes each batch (the pre-embed's converter built once,
dense or sparse).  With ``QUANT_INT8`` stage 2 runs the U-Net's convs in
int8, calibrated on the base U-Net alone (the layer net has no
convolutions); ``generate`` calibrates on the true layers and a stage-1
sample.  With a ``parallel/mesh.py`` mesh, ``sample`` and ``generate`` run
both stages on this rank's rows of each batch, as ``CaloDiffusion``'s do.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.nn_modules import ResNetDense
from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
from calodiffusion_tpu_torch.samplers.base import randn

BASE, LAYER, WHITEN = "base_model.", "layer_model.", "layer_model.whiten."


def split_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """(base, layer) parts of a composite state_dict, prefixes stripped;
    a dict without ``base_model.`` keys is all base (a plain diffusion
    checkpoint), and one without ``layer_model.`` keys has no layer part."""
    if not any(k.startswith(BASE) for k in state_dict):
        base = {k: v for k, v in state_dict.items() if not k.startswith(LAYER)}
    else:
        base = {k[len(BASE):]: v for k, v in state_dict.items() if k.startswith(BASE)}
    layer = {k[len(LAYER):]: v for k, v in state_dict.items() if k.startswith(LAYER)}
    return base, layer


class _LayerModelView:
    """The layer net as a sampler sees a model (the samplers read
    ``denoise``, ``nsteps``, ``loss_function`` and ``device``): a
    denoiser of (B, SHAPE_FINAL[2] + 1) vectors in whitened space."""

    def __init__(self, parent: "LayerDiffusion"):
        self.parent = parent
        self.nsteps = parent.layer_steps
        self.loss_function = parent.loss_function
        self.device = parent.device

    def denoise(self, x, E=None, sigma=None, layers=None):
        return self.parent.denoise_layer(x, E=E, sigma=sigma)


class LayerDiffusion(CaloDiffusion):
    def __init__(self, config, n_steps: int = 400, loss_type: str = "l2",
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(config, n_steps, loss_type, device=device, generator=generator)
        c = self.config
        self.layer_loss = False
        self.layer_sampler_name = c.get("LAYER_SAMPLER", "DDim")
        self.layer_steps = c.get("LAYER_STEPS", n_steps)
        self.layer_net = ResNetDense(  # HGCal's E: three gen-info columns (JAX :49)
            dim_in=c["SHAPE_FINAL"][2] + 1, num_layers=5, cond_size=3 if self.hgcal else 1,
            generator=generator,
        ).to(self.device).eval()
        self.layer_forward_net = self.layer_net  # or a trainer's DDP wrapper of it
        self.whiten: Optional[dict] = None  # {"mean", "std"} f32 (dim,) buffers

    def set_layer_state(self, is_layer: bool = False):
        self.layer_loss = is_layer

    # -- weights -------------------------------------------------------------
    def set_whiten(self, mean, std) -> None:
        """Set the per-dim whitening statistics (f32 buffers on the device)."""
        self.whiten = {k: torch.as_tensor(v, dtype=torch.float32, device=self.device).clone()
                       for k, v in (("mean", mean), ("std", std))}

    def state_dict(self) -> dict:
        sd = {BASE + k: v for k, v in super().state_dict().items()}
        sd.update({LAYER + k: v for k, v in self.layer_net.state_dict().items()})
        if self.whiten is not None:
            sd.update({WHITEN + k: v.detach() for k, v in self.whiten.items()})
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a composite state_dict (both parts; the whitening statistics
        where present, else identity whitening)."""
        base, layer = split_state_dict(state_dict)
        self.load_base_state_dict(base)
        self.load_layer_state_dict(layer)

    def load_base_state_dict(self, base: dict) -> None:
        """The base part alone: the U-Net's keys (and the dataset-1 embed's)."""
        super().load_state_dict(base)

    def load_layer_state_dict(self, layer: dict) -> None:
        """The layer part alone: ResNetDense keys and ``whiten.mean`` /
        ``whiten.std`` where present."""
        stats = {k.removeprefix("whiten."): v for k, v in layer.items() if k.startswith("whiten.")}
        self.layer_net.load_state_dict(
            {k: v for k, v in layer.items() if not k.startswith("whiten.")})
        if stats:
            self.set_whiten(stats["mean"], stats["std"])
        else:
            self.whiten = None

    def parameters(self):
        """Both networks' parameters; in layer mode the base U-Net's get no
        gradient, and ``torch.optim.Adam`` leaves a parameter without one
        as it is (JAX's Adam makes a zero update of a zero gradient)."""
        yield from super().parameters()
        yield from self.layer_net.parameters()

    def named_parameters(self):
        for k, p in super().named_parameters():
            yield BASE + k, p
        for k, p in self.layer_net.named_parameters():
            yield LAYER + k, p

    # -- per-dim whitening (JAX layerdiffusion.py:61-115) --------------------
    def whiten_layers(self, layers):
        if self.whiten is None:
            return layers
        return (layers - self.whiten["mean"]) / self.whiten["std"]

    def unwhiten_layers(self, u):
        if self.whiten is None:
            return u
        return u * self.whiten["std"] + self.whiten["mean"]

    # -- denoisers -----------------------------------------------------------
    def denoise_layer(self, x, E=None, sigma=None):
        """x0 estimate in layer-energy space (reference layer_forward
        :109-112 with the shared scalings, calodiffusion.py:154-169)."""
        t_emb = self.do_time_embed(sigma.reshape(-1))
        scales = self.loss_function.get_scaling(sigma)
        pred = self.layer_forward_net(x * scales["c_in"], cond=E, time=t_emb)
        name = self.training_objective
        if "noise_pred" in name:
            return x - sigma * pred
        if "mean_pred" in name:
            return pred
        return scales["c_skip"] * x + scales["c_out"] * pred

    def compute_loss(self, data, energy, generator: Optional[torch.Generator] = None,
                     noise=None, layers=None, time=None, rnd_normal=None):
        """In layer mode the loss of the layer net on the whitened layer
        vector (``noise``, if given, has that vector's shape: the JAX
        package draws it from its key); otherwise the base model's."""
        if not self.layer_loss:
            return super().compute_loss(data, energy, generator, noise=noise,
                                        layers=layers, time=time, rnd_normal=rnd_normal)

        def denoise_fn(x, E=None, sigma=None, layers=None):
            return self.denoise_layer(x, E=E, sigma=sigma)

        target = self.whiten_layers(layers.float())
        return self.loss_function(denoise_fn, target, energy, generator, noise=noise,
                                  time=time, layers=layers, rnd_normal=rnd_normal)

    # -- int8 sampling -------------------------------------------------------
    def prepare_int8(self, **kw) -> dict:
        """int8 calibration of the base U-Net alone (JAX layerdiffusion.py
        :138-155); warns where no ``QUANT_INT8_EXCLUDE`` fences the down path."""
        if not self.config.get("QUANT_INT8_EXCLUDE"):
            print(
                "WARNING: QUANT_INT8 on the layer cascade without "
                "QUANT_INT8_EXCLUDE — down-path activation quantization "
                "measurably breaks cascade fidelity (docs/INT8_CASCADE"
                ".md).  Set QUANT_INT8_EXCLUDE, e.g. the down path "
                "(ResnetBlock_0..5 + the downsample convs).", flush=True,
            )
        return super().prepare_int8(**kw)

    # -- sampling ------------------------------------------------------------
    @torch.inference_mode()
    def sample_layers(self, energy, generator: Optional[torch.Generator] = None,
                      start=None, debug: bool = False, sample_offset: int = 0):
        """Stage 1: sample the layer vector with ``LAYER_SAMPLER`` over
        ``LAYER_STEPS`` and unwhiten it (the loader's consts-standardized
        layers).  ``start``: the sampler's unit-normal start, else drawn."""
        from calodiffusion_tpu_torch.samplers import get_sampler

        sampler = get_sampler(self.layer_sampler_name)(self.config)
        if start is None:  # the layer vector: total energy and Z layers
            start = randn((energy.shape[0], self.config["SHAPE_FINAL"][2] + 1), generator,
                          self.device)
        out = sampler(_LayerModelView(self), start, energy, None, self.layer_steps,
                      sample_offset or 0, generator, debug)
        return self.unwhiten_layers(out[0] if isinstance(out, tuple) else out)

    @torch.inference_mode()
    def sample(self, energy, layers=None, num_steps: int = 400,
               generator: Optional[torch.Generator] = None, sample_offset: int = 0,
               debug: bool = False, sampler=None, return_layers: bool = False,
               start=None, layer_start=None, mesh=None) -> dict:
        """Two-stage sampling of one batch (reference layerdiffusion.py
        :130-163): ``{"x": showers}`` (with ``"xs"``, ``"x0s"`` under
        ``debug``, ``"layers"`` with ``return_layers``).  ``layers`` skips
        stage 1 (the oracle-layers diagnostic).  Stage 2 runs the whole
        batch at once, as the JAX package does.  ``layer_start`` and
        ``start`` are the two stages' unit-normal starts, else drawn.  With
        ``QUANT_INT8`` stage 2 runs int8 (``int8_scope``).  With a
        ``parallel/mesh.py`` ``mesh`` the arguments are the global batch's
        and each rank runs both stages on its rows and returns them, as
        ``CaloDiffusion.sample`` does."""
        if sampler is None:
            sampler = self.make_sampler()
        if mesh is not None:
            lo, hi = mesh_lib.row_range(mesh, energy.shape[0])

            def rows(t):
                return None if t is None else t[lo:hi]

            with mesh_lib.row_draws(mesh, hi - lo):
                return self.sample(energy[lo:hi], rows(layers), num_steps, generator,
                                   sample_offset, debug, sampler, return_layers,
                                   rows(start), rows(layer_start))
        if layers is not None:
            gen_layers = layers
        else:
            gen_layers = self.sample_layers(energy, generator, start=layer_start,
                                            debug=debug, sample_offset=sample_offset)
        if start is None:
            start = randn((energy.shape[0], *self._data_shape), generator, self.device)
        with self.int8_scope():
            out = sampler(self, start, energy, gen_layers, num_steps, sample_offset or 0,
                          generator, debug)
        result = {}
        if debug:
            result["x"], result["xs"], result["x0s"] = out
        else:
            result["x"] = out
        if return_layers:
            result["layers"] = gen_layers
        return result

    def generate(self, data_loader: Iterable, sample_steps: int,
                 generator: Optional[torch.Generator] = None, sample_offset: int = 0,
                 sampler=None, debug: bool = False, oracle_layers: bool = False,
                 sparse_decoding: bool = False, sparse_per_batch: bool = False,
                 rng: Optional[np.random.Generator] = None, mesh=None):
        """Sample every ``(E, layers, batch)`` of ``data_loader`` through
        both stages and invert the preprocessing batch by batch with the
        stage-1 layers as ``layerE`` (reference layerdiffusion.py:165-256;
        HGCal's decode as ``CaloDiffusion.reverse_norm``).
        ``oracle_layers`` conditions stage 2 on the loader's layers instead.
        With ``QUANT_INT8`` and no scale table, the first batch calibrates
        one on E twice over and [the loader's layers, a stage-1 sample],
        m = min(32, B) rows each (JAX layerdiffusion.py:263-277), drawn from
        ``generator``.  Returns numpy (showers of SHAPE_ORIG, energies).
        With a ``mesh``, this rank's rows of each batch (``sample``'s split)."""
        c = self.config
        if sampler is None:
            sampler = self.make_sampler()
        generated, energies = [], []
        for E, true_layers, _ in data_loader:
            E_np = np.asarray(E, np.float32)
            E_t = torch.as_tensor(E_np, device=self.device)
            true_t = torch.as_tensor(np.asarray(true_layers, np.float32), device=self.device)
            lay = true_t if oracle_layers else None
            if self.int8_sampling_enabled() and self._int8_scales is None:
                m = min(32, E_t.shape[0])
                samp = self.sample_layers(E_t[:m], generator)
                self.prepare_int8(E=torch.cat([E_t[:m], E_t[:m]]),
                                  layers=torch.cat([true_t[:m], samp]), generator=generator)
            out = self.sample(E_t, layers=lay, num_steps=sample_steps, generator=generator,
                              sample_offset=sample_offset, debug=debug, sampler=sampler,
                              return_layers=True, mesh=mesh)
            lo, hi = mesh_lib.row_range(mesh, len(E_np))
            E_np = E_np[lo:hi]
            gen, E_out = self.reverse_norm(
                out["x"].float().cpu().numpy(), E_np, out["layers"].float().cpu().numpy(),
                sparse_decoding=sparse_decoding, sparse_per_batch=sparse_per_batch, rng=rng)
            generated.append(gen)
            energies.append(E_out)
        generated = np.concatenate(generated)
        if not self.orig_shape:
            generated = generated.reshape(c["SHAPE_ORIG"])
        energies = np.concatenate(energies)
        return generated, np.reshape(energies, (energies.shape[0], -1))
