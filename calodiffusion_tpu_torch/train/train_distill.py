"""Consistency distillation: a trainer for the ``Consistency`` sampler.

Port of ``calodiffusion_tpu/train/train_distill.py``.  It distills a
trained diffusion model (the teacher) into a student whose denoise maps any
point of the teacher's probability-flow ODE trajectory to x0, so the
``Consistency`` sampler generates in a few network evaluations.  Consistency
distillation (arXiv:2303.01469) with the pseudo-Huber loss and the
1/(sigma_{i+1} - sigma_i) weighting of arXiv:2310.14189.  One train step:

    i ~ logits over 0..N-2 of the increasing grid
        schedules.discrete_sigmas(CONSIS_NSTEPS)[::-1] (the sampler's table)
    x_{i+1} = x0 + sigma_{i+1} * eps
    xhat_i  = one Heun step of the TEACHER from sigma_{i+1} to sigma_i
    target  = denoise_{EMA}(xhat_i, sigma_i)
    loss    = w(i) * pseudo_huber(denoise_student(x_{i+1}, sigma_{i+1}), target)

The teacher's two denoises and the target's run under ``torch.no_grad``
through ``torch.func.functional_call`` on the student's network with their
own weights, so they keep no activations; only the student's call is
differentiated.  The student starts from the teacher's weights; the EMA
state (decay ``DISTILL_TARGET_DECAY``, default 0.95, whatever ``EMA_DECAY``
says) is the target network, and since inference prefers EMA weights, a
distilled checkpoint is a plain ``CaloDiffusion`` checkpoint that
``sample ... diffusion --sample-algo Consistency`` samples from.

On a mesh with a "model" axis the student's network is sharded by FSDP2,
whose hooks gather only its own shards, so a swap of whole weights cannot
run through it.  There the teacher and the target are networks of their
own, built from the same config and sharded on the same mesh
(``mesh.shard_params_tp``, frozen, resharded after each call), and the EMA
update acts on the target's shards, which FSDP2 places as the student's:
shard by shard it is the whole-tensor update.  ``ema_params`` is the
target's state (its shards); an EMA restored from a checkpoint is loaded
into the target before the next step.  JAX replicates all three where
FSDP2 shards (ROADMAP Queue 3); the arithmetic is the same.

Config keys: TEACHER_LOC (or ``--teacher-loc``, or ``teacher_params=``),
CONSIS_NSTEPS (default 100), DISTILL_TARGET_DECAY, DISTILL_LOSS
("pseudo_huber" or "l2"), DISTILL_HUBER_C (default
0.00054 * sqrt(prod(SHAPE_PAD[1:]))), DISTILL_LR (overrides LR),
DISTILL_IDX_DIST ("lognormal": P_mean -1.1, P_std 2.0; or "uniform"),
DISTILL_EARLYSTOP (the early stop's patience, default 10**9).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion, net_key
from calodiffusion_tpu_torch.models.losses import share_of_mean
from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
from calodiffusion_tpu_torch.samplers import schedules
from calodiffusion_tpu_torch.samplers.base import bshape, multinomial, randn
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion, _copy


class _Denoiser(nn.Module):
    """``model.denoise`` as a module over the model's network, so that
    ``torch.func.functional_call`` runs it with other weights."""

    def __init__(self, model):
        super().__init__()
        self.net = model.net
        self.model = model

    def forward(self, x, E, sigma, layers):
        return self.model.denoise(x, E=E, sigma=sigma, layers=layers)


class TrainDistillation(TrainDiffusion):
    """Distill a trained diffusion teacher into a few-step consistency
    student (see the module docstring)."""

    def __init__(self, flags, config, teacher_params: Optional[dict] = None, **kw):
        config = dict(config)
        if "DISTILL_LR" in config:  # CD usually wants a lower LR than the teacher's
            config["LR"] = config["DISTILL_LR"]
        # the distill val metric plateaus long before the sampled quality
        # stops improving, so the teacher's EARLYSTOP does not apply
        config["EARLYSTOP"] = int(config.get("DISTILL_EARLYSTOP", 10**9))
        super().__init__(flags, config, **kw)
        self._teacher_arg = teacher_params
        self.teacher_params = None
        self._idx_probs = None
        # on a "model" axis: the teacher's and the target's own sharded networks
        self._teacher = self._target = None
        self._target_state = None  # the target's state, which ema_params is while in step

    # -- model and teacher ---------------------------------------------------
    def _load_teacher(self):
        """The teacher's weights (a U-Net state_dict), or None when none is
        configured (loading a distilled checkpoint needs no teacher)."""
        if self._teacher_arg is not None:
            return self._teacher_arg
        loc = self.config.get("TEACHER_LOC") or getattr(self.flags, "teacher_loc", None)
        if not loc:
            return None
        return ckpt_io.load_inference_weights(loc, self.device)  # the teacher's SWA/EMA weights

    def init_model(self):
        super().init_model()
        teacher = self._load_teacher()
        if mesh_lib.axis(self.mesh, "model")[1] > 1:
            return self._init_sharded(teacher)
        if teacher is not None:
            self.teacher_params = {k: v.detach().to(self.device, torch.float32).clone()
                                   for k, v in teacher.items()}
            self.model.load_state_dict(self.teacher_params)  # the student starts as the teacher
        # the EMA state is the consistency target network
        self.ema_decay = float(self.config.get("DISTILL_TARGET_DECAY", 0.95))
        self.ema_params = _copy(self.model.state_dict())
        self._denoiser = _Denoiser(self.model)
        return self.model

    def _init_sharded(self, teacher: Optional[dict]):
        """``init_model`` on a "model" axis: the student (FSDP2, placed by
        ``_place_model``) starts from the teacher's weights through
        ``shard_like``; the teacher and the target are frozen networks of
        their own on the mesh, the target starting as the student."""
        if teacher is not None:
            self._teacher = self._frozen_network(teacher)
            self.teacher_params = self._teacher.state_dict()
            self.model.load_state_dict(mesh_lib.shard_like(
                {k: v.to(self.device, torch.float32) for k, v in teacher.items()},
                self.model.state_dict()))
        self.ema_decay = float(self.config.get("DISTILL_TARGET_DECAY", 0.95))
        self._target = self._frozen_network(self.model.state_dict())
        self._target_state = self.ema_params = self._target.state_dict()
        return self.model

    def _frozen_network(self, weights: dict) -> CaloDiffusion:
        """A ``CaloDiffusion`` of the config holding ``weights`` (whole
        tensors, or DTensors placed as the student's), its network frozen
        and sharded on the mesh as the student's is."""
        model = CaloDiffusion(self.config, n_steps=self.config["NSTEPS"],
                              loss_type=self.config["LOSS_TYPE"], device=self.device,
                              generator=torch.Generator().manual_seed(self.seed))
        model.net.requires_grad_(False)
        mesh_lib.shard_params_tp(self.mesh, model.net)
        model.load_state_dict(mesh_lib.shard_like(weights, model.state_dict()))
        return model

    def _target_network(self) -> CaloDiffusion:
        """The target network, holding ``ema_params``: an EMA that is not
        the target's own state (restored from a checkpoint, or set by a
        caller) is loaded into it first, and ``ema_params`` becomes its
        state again, so the EMA update moves the target's shards."""
        if self.ema_params is not self._target_state:
            self._target.load_state_dict(
                mesh_lib.shard_like(self.ema_params, self._target.state_dict()))
            self._target_state = self.ema_params = self._target.state_dict()
        return self._target

    def _ema_follows_weights(self) -> bool:
        """The consistency target follows the student at any decay (JAX
        train_distill.py:225-227), 0 included."""
        return True

    # -- the distillation loss ------------------------------------------------
    def _sigma_grid(self) -> np.ndarray:
        """Increasing f32 sigma grid: the Consistency sampler's table
        (``discrete_sigmas(CONSIS_NSTEPS)``, decreasing there), reversed."""
        n = int(self.config.get("CONSIS_NSTEPS", 100))
        return np.ascontiguousarray(schedules.discrete_sigmas(n)[::-1]).astype(np.float32)

    def _idx_logits(self, n_grid: int) -> np.ndarray:
        """Log-probabilities over grid indices 0..N-2: the discretized
        lognormal of arXiv:2310.14189 sec. 3.5 (P_mean -1.1, P_std 2.0),
        p(i) ~ erf((ln s_{i+1} - Pm) / (sqrt2 Ps)) - erf((ln s_i - Pm) /
        (sqrt2 Ps)); "uniform" gives flat logits."""
        from scipy.special import erf

        if self.config.get("DISTILL_IDX_DIST", "lognormal") == "uniform":
            return np.zeros(n_grid - 1, np.float32)
        grid = self._sigma_grid()
        pm, ps = -1.1, 2.0
        cdf = erf((np.log(grid) - pm) / (np.sqrt(2.0) * ps))
        p = np.maximum(cdf[1:] - cdf[:-1], 1e-12)
        return np.log(p / p.sum()).astype(np.float32)

    def _denoise_with(self, weights, x, E, sigma, layers):
        """The student's network run on ``weights`` (a ``CaloDiffusion``
        state_dict), or ``weights``'s own network where it is a frozen
        ``CaloDiffusion`` of a "model" axis (resharded after the call)."""
        if isinstance(weights, CaloDiffusion):
            out = weights.denoise(x, E=E, sigma=sigma, layers=layers)
            weights.net.reshard()  # FSDP2 keeps a root's gathered weights after its forward
            return out
        params = {f"net.{net_key(k)}": v for k, v in weights.items()}
        return torch.func.functional_call(self._denoiser, params, (x, E, sigma, layers))

    def distill_loss(self, data, E, layers, idx, noise, target=None, mask=None):
        """The consistency loss at grid indices ``idx`` (B,) and ``noise``
        (data's shape): the student's denoise against ``target``'s (a
        state_dict, or on a "model" axis the target network; None: the
        student itself) at the teacher's Heun step (JAX
        ``_distill_loss_fn``)."""
        teacher = self._teacher if self._teacher is not None else self.teacher_params
        grid = torch.from_numpy(self._sigma_grid()).to(data.device)
        gaps = grid[1:] - grid[:-1]
        idx = torch.as_tensor(idx, device=data.device).long()
        bs = bshape(data)
        sig_next = grid[idx + 1].reshape(bs)  # higher noise
        sig_cur = grid[idx].reshape(bs)
        x_next = data + sig_next * noise
        with torch.no_grad():  # teacher Heun PF-ODE step sigma_{i+1} -> sigma_i
            x0_a = self._denoise_with(teacher, x_next, E, sig_next, layers)
            d_a = (x_next - x0_a) / sig_next
            x_mid = x_next + (sig_cur - sig_next) * d_a
            x0_b = self._denoise_with(teacher, x_mid, E, sig_cur, layers)
            d_b = (x_mid - x0_b) / sig_cur
            x_prev = x_next + (sig_cur - sig_next) * 0.5 * (d_a + d_b)
            tgt = (self.model.denoise(x_prev, E=E, sigma=sig_cur, layers=layers)
                   if target is None
                   else self._denoise_with(target, x_prev, E, sig_cur, layers))
        pred = self.model.denoise(x_next, E=E, sigma=sig_next, layers=layers)

        diff = pred - tgt
        if self.config.get("DISTILL_LOSS", "pseudo_huber") == "l2":
            elem = diff**2
        else:
            d_elems = int(np.prod(self.config["SHAPE_PAD"][1:]))
            c = float(self.config.get("DISTILL_HUBER_C", 0.00054 * np.sqrt(d_elems)))
            elem = torch.sqrt(diff**2 + c**2) - c
        vals = (1.0 / gaps[idx]).reshape(bs) * elem  # iCT weight 1/(sigma_{i+1} - sigma_i)
        group = self.model.loss_function.data_group
        if mask is None and group is None:
            return vals.mean()
        m = torch.ones_like(vals) if mask is None else mask.reshape(bs) * torch.ones_like(vals)
        if group is not None:  # this rank's share of the global batch's mean
            return share_of_mean((vals * m).sum(), m.sum(), group)
        return (vals * m).sum() / m.sum()

    # -- steps -----------------------------------------------------------------
    def training_loop(self, *args, **kw):
        if self.teacher_params is None:
            raise ValueError(
                "TrainDistillation needs a teacher to train: set config TEACHER_LOC (or "
                "--teacher-loc) to a trained diffusion checkpoint, or pass teacher_params="
            )
        return super().training_loop(*args, **kw)

    def train_step(self, data, E, layers, idx=None, noise=None):
        """One distillation step: indices from the index logits, then the
        noise (the JAX order), each drawn from the trainer's generator
        unless given; Adam; the EMA target update.  On a mesh the draws are
        the global batch's, sliced to this rank's rows."""
        with self._rows(data.shape[0]):
            if idx is None:
                if self._idx_probs is None:
                    logits = torch.from_numpy(self._idx_logits(len(self._sigma_grid())))
                    self._idx_probs = torch.softmax(logits, 0).to(self.device)
                idx = multinomial(self._idx_probs, data.shape[0], self.generator)
            if noise is None:
                noise = randn(data.shape, self.generator, self.device)
            for p in self.model.parameters():
                p.grad = None
            target = self.ema_params if self._target is None else self._target_network()
            loss = self.distill_loss(data, E, layers, idx, noise, target=target)
            loss.backward()
        self._apply_update()
        return loss.detach()

    @torch.no_grad()
    def val_step(self, data, E, layers, rnd_normal, mask):
        """The self-consistency gap along teacher trajectories: the index
        from the fixed val normals, clip(int(ndtr(r) (N-1)), 0, N-2), the
        noise redrawn on every call, the student its own target."""
        n = len(self._sigma_grid())
        noise = randn(data.shape, self.generator, self.device)
        u = torch.special.ndtr(torch.as_tensor(rnd_normal, dtype=torch.float32))
        idx = torch.clamp((u * (n - 1)).to(torch.int32), 0, n - 2)
        return self.distill_loss(data, E, layers, idx, noise, mask=mask)
