"""Layer-energy model trainer.

Port of ``calodiffusion_tpu/train/train_layer_model.py`` (reference:
calodiffusion/train/train_layer_model.py): ``TrainDiffusion`` with a
``LayerDiffusion`` model that trains its layer net alone (unless built for
inference), on the whitened layer vectors of ``loader_train``.  The
checkpoints land in ``<CHECKPOINT_NAME>_LayerModel/``.

The val loss is the inherited one: the base model's ``denoise_fn``, the
frozen base U-Net's diffusion loss on the showers, as in the JAX package
(its ``val_step`` reaches ``LayerDiffusion.denoise``, the base U-Net).  It
drives the plateau LR, the early stop and ``best_val`` there as here
(ROADMAP Queue 3 records it as reference behaviour the port keeps).  On a
mesh the layer net is the network DDP wraps; the frozen base U-Net is
replicated (every rank loads the same weights).
"""

from __future__ import annotations

import numpy as np
import torch

from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion, split_state_dict
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion


class TrainLayerModel(TrainDiffusion):
    def __init__(self, flags, config, load_data: bool = True, save_model: bool = True,
                 inference: bool = False, device=None, loader_train=None, loader_val=None,
                 mesh=None):
        super().__init__(flags, config, load_data=load_data, save_model=save_model,
                         device=device, loader_train=loader_train, loader_val=loader_val,
                         mesh=mesh)
        self.inference = inference

    def _trained_net(self):
        return self.model.layer_net, "layer_forward_net"

    def init_model(self):
        self.model = LayerDiffusion(
            self.config, n_steps=self.config["NSTEPS"],
            loss_type=self.config["LOSS_TYPE"], device=self.device,
            generator=torch.Generator().manual_seed(self.seed),
        )
        # training trains only the layer model; inference runs the cascade
        self.model.set_layer_state(not self.inference)
        if not self.inference and self.loader_train is not None:
            self.model.set_whiten(*self._layer_whiten_stats())
        self._place_model()
        self._init_aux_params()
        return self.model

    def _layer_whiten_stats(self):
        """Per-dim (mean, std) of the training layer vectors: one float64
        numpy pass over the loader, std floored at 1e-3 so a near-constant
        dim does not blow up the unwhitened noise (JAX
        train_layer_model.py:78-97)."""
        s0, s1, s2 = 0, None, None
        for _, layers, _ in self.loader_train:
            lay = np.asarray(layers, dtype=np.float64)
            s0 += lay.shape[0]
            s1 = lay.sum(0) if s1 is None else s1 + lay.sum(0)
            s2 = (lay ** 2).sum(0) if s2 is None else s2 + (lay ** 2).sum(0)
        mean = s1 / s0
        var = np.maximum(s2 / s0 - mean ** 2, 0.0)
        std = np.maximum(np.sqrt(var), 1e-3)
        return mean.astype(np.float32), std.astype(np.float32)

    def load_for_inference(self):
        """The base U-Net from ``--model-loc`` (a plain or a composite
        checkpoint), the layer net from ``config["layer_model"]`` or from a
        composite ``--model-loc`` (reference layerdiffusion.py:58-107)."""
        if self.model is None:
            self.init_model()
        base, layer = split_state_dict(
            ckpt_io.load_inference_weights(self.flags.model_loc, self.device))
        layer_loc = self.config.get("layer_model")
        if layer_loc:
            stored = ckpt_io.load_inference_weights(layer_loc, self.device)
            _, layer = split_state_dict(stored)
            layer = layer or stored  # a layer net's own state_dict
        elif not layer:
            raise ValueError(
                "No layer model: set config['layer_model'] or use a composite checkpoint"
            )
        self.model.load_base_state_dict(base)
        self.model.load_layer_state_dict(layer)
        return self.model
