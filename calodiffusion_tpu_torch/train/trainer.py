"""Training loops, on one CUDA card.

Port of ``calodiffusion_tpu/train/trainer.py``: ``Train`` is the harness
(checkpoint-dir layout, resume, epoch loop scaffolding; reference
calodiffusion/train/train.py) and ``TrainDiffusion`` the concrete diffusion
trainer (reference train/train_diffusion.py).

PyTorch runs eagerly: one train step is the sigma draw, noising, forward,
loss, ``backward`` and the Adam update on the model's own parameters
(``torch.optim.Adam`` with optax's defaults: betas 0.9/0.999, eps 1e-8).
The plateau LR is set on the optimizer's param_groups.  Batches come from
``data/loader.load_data(flags, config)``, or from the ``loader_train`` /
``loader_val`` a caller passes: iterables of numpy ``(E, layers, data)``.
Randomness comes from a ``torch.Generator`` on the card seeded from
``flags.seed``.  With ``COLD_DIFFU`` the train and val noise is the model's
``gen_cold_image`` of the unit noise (JAX trainer.py:342-363, :422-425), the
prior loaded from ``AVG_SHOWER_LOC`` where the model holds none yet.  With
``TRACE_DIR`` (or ``flags.trace_dir``) the second epoch's steps are traced
into it (``utils/profiling.trace``), as the JAX trainer captures them.

Scale-out (JAX trainer.py:53-59, :433-440, :548-560): under a process group
the trainer runs on a ``parallel/mesh.py`` mesh (every rank by default, as
JAX takes every device; ``mesh=`` picks another, e.g. a "model" axis).  The
network a step trains is wrapped once (DDP over "data", FSDP2 with a
"model" axis); each global batch is padded to a multiple of the data ranks
by repeating its last row (the repeats count in the loss, as in JAX) and
each rank uploads only its rows; the noise and sigmas are the global
batch's draws, sliced (``mesh.row_draws``), and the loss each rank's share
of the global batch's, so N ranks take the step one process takes.  The
epoch's train and val losses are all-reduced, so the plateau LR, the early
stop and ``best_val`` agree on every rank; only rank 0 writes files.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from calodiffusion_tpu_torch.data.loader import load_data as load_data_fn
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.parallel import mesh as mesh_lib
from calodiffusion_tpu_torch.samplers.base import randn
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train.schedulers import EarlyStopper, ReduceLROnPlateau
from calodiffusion_tpu_torch.utils.device import resolve_device
from calodiffusion_tpu_torch.utils.profiling import StepTimer, trace


def _norm_cache_cfg(v):
    """Normalize ``CACHE_DATA_ON_DEVICE`` to True / False / "auto" (configs
    are parsed yaml-lax, so the value may arrive as a string)."""
    if isinstance(v, str):
        s = v.strip().lower()
        if s in ("false", "0", "off", "no"):
            return False
        if s in ("true", "1", "on", "yes"):
            return True
        return "auto"
    return v if v in (True, False) else "auto"


def _copy(state: dict) -> dict:
    return {k: v.detach().clone() for k, v in state.items()}


class Train:
    def __init__(self, flags, config, load_data: bool = True, save_model: bool = True,
                 device=None, loader_train=None, loader_val=None, mesh=None):
        """``load_data``: build the loaders with ``load_data(flags, config)``,
        unless ``loader_train`` or ``loader_val`` is given: those win.
        ``mesh``: a ``parallel/mesh.py`` mesh, by default every rank of the
        process group on "data" (None without one)."""
        self.flags = flags
        self.config = config
        self.save_model = save_model
        self.batch_size = config.get("BATCH", 256)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else mesh_lib.make_mesh(device_type=self.device.type)
        self._wrapped = None  # the module a train step calls, once placed on the mesh
        if load_data and loader_train is None and loader_val is None:
            loader_train, loader_val = load_data_fn(flags, config, device=self.device)
        self.loader_train, self.loader_val = loader_train, loader_val

        # checkpoint-dir naming parity (reference train.py:23-41)
        name = f"{config['CHECKPOINT_NAME']}_{self.__class__.__name__.removeprefix('Train')}"
        self.checkpoint_folder = os.path.join(
            getattr(flags, "checkpoint_folder", "./trained_models/"), name
        )
        if getattr(flags, "model_loc", None):
            self.checkpoint_folder = os.path.dirname(flags.model_loc)
        if self.save_model and mesh_lib.is_writer():
            os.makedirs(self.checkpoint_folder, exist_ok=True)
            with open(os.path.join(self.checkpoint_folder, "config.json"), "w") as f:
                json.dump(config if isinstance(config, dict) else {}, f, default=str)

        self.model: Optional[CaloDiffusion] = None
        self._device_cache = None
        self._val_cache = None  # device-resident fixed val working set
        self._cache_epoch = 0
        self.ema_params = None  # name -> tensor, as the model's state_dict
        self.swa_params = None  # SWA tail average (SWA_START_EPOCH >= 0)
        self.swa_n = 0  # epochs folded into swa_params so far
        self.opt = None
        self.seed = getattr(flags, "seed", 1234) or 1234
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)

    # -- abstract ----------------------------------------------------------
    def init_model(self):
        raise NotImplementedError

    def training_loop(self, scheduler, early_stopper, start_epoch, num_epochs,
                      training_losses, val_losses):
        raise NotImplementedError

    # -- the mesh ----------------------------------------------------------
    def _trained_net(self):
        """(module, attribute of the model that calls it) of the network a
        train step differentiates."""
        return self.model.net, "forward_net"

    def _place_model(self):
        """Put the model on the mesh (JAX replicates its params there): the
        trained network wrapped once by ``mesh.wrap`` and called through
        the wrapper, the loss each rank's share of the global batch's."""
        if self.mesh is None or self._wrapped is not None:
            return
        net, attr = self._trained_net()
        self._wrapped = mesh_lib.wrap(self.mesh, net)
        setattr(self.model, attr, self._wrapped)
        self.model.loss_function.data_group = mesh_lib.data_group(self.mesh)

    def _rows(self, local_rows: int, rows=None):
        """Context: the draws of this rank's ``local_rows`` rows are the
        global batch's (of ``rows`` real rows; ``mesh.row_draws``)."""
        return mesh_lib.row_draws(self.mesh, local_rows, rows)

    def _write_arrays(self, name: str, arrays: dict, host: dict) -> None:
        """``<name>.ckpt`` and ``<name>_state.json`` of rank 0 (FSDP2's
        DTensors gathered whole, a collective), then a barrier."""
        arrays = mesh_lib.full_state(arrays)
        if mesh_lib.is_writer():
            ckpt_io.save_arrays(os.path.join(self.checkpoint_folder, f"{name}.ckpt"), arrays)
            with open(os.path.join(self.checkpoint_folder, f"{name}_state.json"), "w") as f:
                json.dump(host, f)
        mesh_lib.barrier()

    # -- checkpointing -----------------------------------------------------
    def _save(self, name, epoch, training_losses, val_losses, scheduler, early_stopper):
        if not self.save_model:
            return
        # FSDP2's DTensors gathered whole on every rank (a collective)
        state = mesh_lib.full_state(dict(params=self.model.state_dict(),
                                         opt_state=self.opt.state_dict(),
                                         ema_params=self.ema_params,
                                         swa_params=self.swa_params))
        if mesh_lib.is_writer():
            ckpt_io.save_checkpoint(
                self.checkpoint_folder, name, **state, swa_n=self.swa_n,
                epoch=epoch, training_losses=training_losses,
                val_losses=val_losses,
                scheduler_state=scheduler.state_dict(),
                early_stop_state=early_stopper.state_dict(),
            )
        mesh_lib.barrier()

    def _checkpoint_location(self):
        model_loc = getattr(self.flags, "model_loc", None)
        if model_loc:
            return ckpt_io.split_location(model_loc)
        return self.checkpoint_folder, "checkpoint"

    def pickup_checkpoint(self, scheduler, early_stopper, restart_training):
        """Resume from checkpoint.pth-equivalent (reference train.py:60-102),
        as the JAX trainer does (trainer.py:128-160): a checkpoint whose key
        set differs from the live state's (params, opt_state, and ema_params
        and swa_params where the live config keeps them) restores no
        optimizer state, and says so; a checkpoint's EMA replaces the live
        one, even with EMA off (it then stays as restored, is saved and is
        served); without one, the live EMA keeps the weights it held before
        the restore."""
        folder, name = self._checkpoint_location()
        arrays, host = ckpt_io.load_checkpoint(folder, name, map_location=self.device)
        expected = {"params", "opt_state"} | {
            k for k, v in (("ema_params", self.ema_params), ("swa_params", self.swa_params))
            if v is not None}
        if set(arrays) != expected:
            print(
                f"WARNING: checkpoint {folder}/{name} has a different key "
                "set than the live training state "
                f"(saved: {sorted(arrays)}, expected: {sorted(expected)}); "
                "optimizer state NOT restored — Adam moments restart fresh",
                flush=True,
            )
            arrays["opt_state"] = None
        live = self.model.state_dict()
        self.model.load_state_dict(mesh_lib.shard_like(arrays["params"], live))
        if arrays.get("opt_state") is not None and not restart_training:
            self.opt.load_state_dict(arrays["opt_state"])
            mesh_lib.shard_optimizer_state(self.opt)
        if arrays.get("ema_params") is not None:
            self.ema_params = _copy(mesh_lib.shard_like(arrays["ema_params"], live))
        if arrays.get("swa_params") is not None and not restart_training:
            self.swa_params = _copy(mesh_lib.shard_like(arrays["swa_params"], live))
            self.swa_n = int(host.get("swa_n", 0))
        if not restart_training:
            if host.get("scheduler_state"):
                scheduler.load_state_dict(host["scheduler_state"])
                self._set_lr(scheduler.lr)
            if host.get("early_stop_dict"):
                early_stopper.load_state_dict(host["early_stop_dict"])
            return (host["train_loss_hist"], host["val_loss_hist"], host["epoch"] + 1)
        return {}, {}, 0

    def load_for_inference(self):
        """Load model weights only (reference run_inference's
        pickup_checkpoint(restart_training=True), inference.py:347-354).
        Prefers SWA weights when a tail average exists (swa_n > 0), then
        EMA, then raw params."""
        if self.model is None:
            self.init_model()
        folder, name = self._checkpoint_location()
        arrays, host = ckpt_io.load_checkpoint(folder, name, map_location=self.device)
        self.model.load_state_dict(mesh_lib.shard_like(ckpt_io.inference_params(arrays, host),
                                                       self.model.state_dict()))
        if self.config.get("COLD_DIFFU", False) and not self.model.has_cold_prior():
            # sampling starts from the average-shower cold prior
            self.model.init_cold_diffu()
        return self.model

    def make_optimizer(self, lr: float) -> torch.optim.Optimizer:
        """Adam over the model's parameters with optax.adam's defaults."""
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)
        return self.opt

    def _set_lr(self, lr: float) -> None:
        for group in self.opt.param_groups:
            group["lr"] = lr

    # -- main entry --------------------------------------------------------
    def train(self):
        if self.model is None:
            self.init_model()

        num_epochs = self.config.get("MAXEPOCH", 30)
        early_stopper = EarlyStopper(
            patience=self.config["EARLYSTOP"], mode="val_loss", min_delta=1e-5
        )
        lr = float(self.config["LR"])
        scheduler = ReduceLROnPlateau(lr, factor=0.1, patience=15)

        if self.opt is None:
            self.make_optimizer(lr)

        start_epoch = 0
        training_losses, val_losses = {}, {}
        if getattr(self.flags, "load", False):
            try:
                training_losses, val_losses, start_epoch = self.pickup_checkpoint(
                    scheduler, early_stopper,
                    restart_training=getattr(self.flags, "reset_training", False),
                )
            except ckpt_io.CheckpointMissingError as e:
                print(f"No checkpoint to resume ({e}); starting fresh")

        epoch, training_losses, val_losses = self.training_loop(
            scheduler, early_stopper, start_epoch, num_epochs,
            training_losses, val_losses,
        )
        if self.swa_params is not None and self.swa_n == 0:
            print(
                "WARNING: SWA was enabled but no epochs were averaged "
                f"(swa_start={getattr(self, 'swa_start', -1)}, training "
                f"ended at epoch {epoch}); inference will use "
                f"{'EMA' if self.ema_params is not None else 'raw'} "
                "weights. Lower SWA_START_EPOCH/SWA_START_FRAC or set "
                "SWA_ARM_ON_PLATEAU.", flush=True,
            )
        self._save("final", epoch, training_losses, val_losses, scheduler, early_stopper)
        return self.model


class TrainDiffusion(Train):
    def init_model(self):
        self.model = CaloDiffusion(
            self.config, n_steps=self.config["NSTEPS"],
            loss_type=self.config["LOSS_TYPE"], device=self.device,
            generator=torch.Generator().manual_seed(self.seed),
        )
        self._place_model()
        self._init_aux_params()
        return self.model

    def _init_aux_params(self):
        """EMA + SWA state, from the live config (the JAX package's
        ``TrainDiffusion._init_aux_params``): ``swa_params`` is allocated
        whenever SWA is enabled so the checkpoint key set is stable; ``swa_n``
        says whether it holds an average yet.  With EMA on, SWA averages the
        EMA trajectory."""
        self.ema_decay = float(self.config.get("EMA_DECAY", 0.0))
        if self.ema_decay > 0:
            self.ema_params = _copy(self.model.state_dict())
        self.swa_start = int(self.config.get("SWA_START_EPOCH", -1))
        frac = self.config.get("SWA_START_FRAC")
        if self.swa_start < 0 and frac is not None:
            self.swa_start = int(float(frac) * int(self.config.get("MAXEPOCH", 30)))
        # arm SWA off the val-loss plateau too: with EARLYSTOP the run often
        # ends before SWA_START_FRAC * MAXEPOCH
        self.swa_arm_on_plateau = bool(self.config.get("SWA_ARM_ON_PLATEAU", False))
        if self.swa_start >= 0 or self.swa_arm_on_plateau:
            self.swa_params = _copy(self.model.state_dict())
            self.swa_n = 0

    def _swa_due(self, epoch, early_stopper):
        """Whether this epoch's weights fold into the SWA average; with
        ``SWA_ARM_ON_PLATEAU`` the start arms once the early stopper is half
        way to firing, if the scheduled ``swa_start`` has not been reached."""
        scheduled = getattr(self, "swa_start", -1) >= 0
        if (getattr(self, "swa_arm_on_plateau", False)
                and self.swa_n == 0
                and not (scheduled and epoch >= self.swa_start)
                and early_stopper.counter * 2 >= early_stopper.patience):
            print(f"SWA: arming at epoch {epoch} (val-loss plateau: "
                  f"early-stop counter {early_stopper.counter}/"
                  f"{early_stopper.patience})", flush=True)
            self.swa_start = epoch
            scheduled = True
        return scheduled and epoch >= self.swa_start

    @torch.no_grad()
    def _swa_update(self):
        """Fold the current inference-preferred weights into the running
        SWA average: swa <- swa + (w - swa) / (n + 1)."""
        src = self.ema_params if self.ema_params is not None else self.model.state_dict()
        n = self.swa_n
        for k, s in self.swa_params.items():
            s.add_((src[k] - s) / (n + 1))
        self.swa_n = n + 1

    def inference_weights(self) -> dict:
        """The weights sampling should use: SWA tail average if accumulated,
        else EMA, else raw params (as ``checkpoint.inference_params``)."""
        if self.swa_params is not None and self.swa_n > 0:
            return self.swa_params
        if self.ema_params is not None:
            return self.ema_params
        return self.model.state_dict()

    # -- one train step ----------------------------------------------------
    def _cold_noise(self, noise, E):
        """With ``COLD_DIFFU``, the cold "noise" of the unit ``noise``: the
        average shower of E's incident-energy bin (its first column) plus
        ``COLD_NOISE`` x noise x the bin's std; else ``noise``.  The prior
        is loaded from ``AVG_SHOWER_LOC`` on first use where the model holds
        none."""
        if not self.config.get("COLD_DIFFU", False):
            return noise
        if not self.model.has_cold_prior():
            self.model.init_cold_diffu()
        return self.model.gen_cold_image(E[:, :1], self.config.get("COLD_NOISE", 1.0), noise)

    def _accumulate_grads(self, data, E, layers, noise=None, rnd_normal=None):
        """Set the parameters' ``.grad`` to the batch's loss gradient and
        return the loss.  With ``TRAIN_MICROBATCH`` and a batch it divides,
        the batch runs as sequential chunks and the gradient is the mean of
        the per-chunk gradients (trainer.py:373-400).  ``noise`` and
        ``rnd_normal`` may be injected (tests); chunks then take slices.
        With ``COLD_DIFFU`` each chunk's unit noise (drawn, or the injected
        slice) goes through ``_cold_noise``, as the JAX step draws it inside
        each chunk's loss; the layer model's loss takes no shower noise (the
        JAX step discards it there).

        On a mesh ``data`` is this rank's rows (``_device_batch``): chunk i
        is its share of the global batch's chunk i, the draws are the global
        chunk's, sliced, and DDP all-reduces the gradients once, in the last
        chunk's backward (the others run under ``no_sync``), as JAX's scan
        reduces them once."""
        cold = self.config.get("COLD_DIFFU", False) and not getattr(self.model, "layer_loss",
                                                                    False)
        n_chunks = self._chunks(data.shape[0] * mesh_lib.node_share(self.mesh)[1])
        size = data.shape[0] // n_chunks
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=data.device)
        for i in range(n_chunks):
            sl = slice(i * size, (i + 1) * size)

            def part(a):
                return None if a is None else a[sl]

            last = i == n_chunks - 1
            with (contextlib.nullcontext() if last else mesh_lib.no_sync(self._wrapped)), \
                    self._rows(size):
                chunk_noise = part(noise)
                if cold:
                    if chunk_noise is None:
                        chunk_noise = randn(data[sl].shape, self.generator, self.device)
                    chunk_noise = self._cold_noise(chunk_noise, E[sl])
                loss = self.model.compute_loss(
                    data[sl], E[sl], self.generator, layers=part(layers),
                    noise=chunk_noise, rnd_normal=part(rnd_normal),
                )
                loss.backward()
            loss_sum += loss.detach()
        if n_chunks > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_chunks)
        return loss_sum / n_chunks

    def _ema_follows_weights(self) -> bool:
        """Whether each step moves the EMA: only with EMA_DECAY > 0
        (trainer.py:407); an EMA restored from a checkpoint with EMA off
        stays as it was."""
        return self.ema_params is not None and self.ema_decay > 0

    @torch.no_grad()
    def _apply_update(self):
        """One Adam step on the accumulated gradients, then the EMA
        (trainer.py:405-411)."""
        self.opt.step()
        if self._ema_follows_weights():
            for k, p in self.model.state_dict().items():
                self.ema_params[k].mul_(self.ema_decay).add_(p, alpha=1 - self.ema_decay)

    def train_step(self, data, E, layers):
        loss = self._accumulate_grads(data, E, layers)
        self._apply_update()
        return loss

    @torch.no_grad()
    def val_step(self, data, E, layers, rnd_normal, mask, noise=None):
        """Val loss with fixed per-batch sigma draws (``rnd_normal``) and
        noise redrawn on every call (reference train_diffusion.py:87); a
        discrete-time sigma is drawn from a fixed seed, as the JAX package
        draws it from PRNGKey(0).  ``noise``: the unit noise, injected
        (tests); with ``COLD_DIFFU`` it goes through ``_cold_noise``."""
        if noise is None:
            noise = randn(data.shape, self.generator, self.device)
        noise = self._cold_noise(noise, E)
        fixed = torch.Generator(device=self.device).manual_seed(0)
        return self.model.loss_function(
            self.model.denoise_fn(), data, E, fixed,
            noise=noise, layers=layers, rnd_normal=rnd_normal, mask=mask,
        )

    def _chunks(self, rows: int) -> int:
        """The microbatches of a batch of ``rows`` rows: ``TRAIN_MICROBATCH``
        where it divides them, else one."""
        micro = int(self.config.get("TRAIN_MICROBATCH", 0) or 0)
        return rows // micro if micro and rows > micro and rows % micro == 0 else 1

    # -- data --------------------------------------------------------------
    def _device_batch(self, E, layers, data, chunks=None):
        """This rank's rows of a loader batch on the device: the batch
        padded to a multiple of the node's data ranks by repeating its last
        row (JAX trainer.py:433-440: the repeats count in the loss), then
        ``mesh.shard_batch`` of it over ``chunks`` microbatches (by default
        the train step's)."""
        n = mesh_lib.node_share(self.mesh)[1]
        (E, layers, data), _ = mesh_lib.pad_batch_to_multiple(
            tuple(np.asarray(a) for a in (E, layers, data)), n)
        if chunks is None:
            chunks = self._chunks(E.shape[0])

        def put(a):
            a = mesh_lib.shard_batch(self.mesh, a, chunks)
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return put(E), put(layers), put(data)

    def _epoch_batches(self, timer):
        """Yield device-resident training batches.  With
        ``CACHE_DATA_ON_DEVICE`` (default "auto": on while the data fits in
        4 GiB) the dataset is uploaded once and its batch order reshuffled
        every later epoch by ``np.random.default_rng(epoch)``."""
        cache_cfg = _norm_cache_cfg(self.config.get("CACHE_DATA_ON_DEVICE", "auto"))
        if self._device_cache is not None:
            self._cache_epoch += 1
            order = np.random.default_rng(self._cache_epoch).permutation(
                len(self._device_cache)
            )
            for j in order:
                yield self._device_cache[j]
            return

        collect = cache_cfg is True or cache_cfg == "auto"
        cached = []
        total_bytes = 0
        for E, layers, data in self.loader_train:
            with timer.phase("h2d"):
                batch = self._device_batch(E, layers, data)
            if collect:
                total_bytes += sum(np.asarray(a).nbytes for a in (E, layers, data))
                if cache_cfg == "auto" and total_bytes > 4 * 2**30:
                    collect = False  # too large: stream every epoch
                    cached = []
                else:
                    cached.append(batch)
            yield batch
        if collect and cached:
            self._device_cache = cached

    def _val_batches(self, val_rnd):
        """The fixed val working set, this rank's rows, built once: (data, E,
        layers, rnd_normal, mask, the batch's real rows) per batch.  ``mask``
        marks the real rows: a batch padded to a multiple of the data ranks
        has zeros in its repeats, and its sigma draws zeros there (JAX
        trainer.py:548-560); on one card no batch is padded."""
        if self._val_cache is None:
            cache = []
            for i, (vE, vlayers, vdata) in enumerate(self.loader_val):
                if i >= val_rnd.shape[0]:
                    break
                n_real = np.asarray(vE).shape[0]
                vE_d, vlay_d, vdata_d = self._device_batch(vE, vlayers, vdata, chunks=1)
                n_pad = vE_d.shape[0] * mesh_lib.node_share(self.mesh)[1] - n_real
                mask = torch.ones(n_real, device=self.device)
                rnd = val_rnd[i][:n_real]
                if self.mesh is not None:
                    mask = mesh_lib.shard_batch(self.mesh, F.pad(mask, (0, n_pad)))
                    rnd = mesh_lib.shard_batch(self.mesh, F.pad(rnd, (0, n_pad)))
                cache.append((vdata_d, vE_d, vlay_d, rnd, mask, n_real))
            self._val_cache = cache
        return self._val_cache

    # -- epochs ------------------------------------------------------------
    def training_loop(self, scheduler, early_stopper, start_epoch, num_epochs,
                      training_losses, val_losses):
        layer_cond = self.model.layer_cond

        # fixed per-batch noise levels for a stable val loss
        # (reference train_diffusion.py:29-31)
        if self.loader_val is not None:
            n_val = len(self.loader_val) + 1
            val_batch = getattr(self.loader_val, "batch_size", self.batch_size)
            val_rnd = randn((n_val, val_batch), self.generator, self.device)

        timer = StepTimer()
        trace_dir = getattr(self.flags, "trace_dir", None) or self.config.get("TRACE_DIR")
        # nodes read their own files: agree each epoch's batch count
        several_nodes = mesh_lib.process_index()[1] > 1
        min_validation_loss = 99999.0
        epoch = start_epoch
        for epoch in range(start_epoch, num_epochs):
            print(f"Beginning epoch {epoch}", flush=True)
            n_batches = (mesh_lib.agree_min(self.mesh, len(self.loader_train))
                         if several_nodes else None)
            # losses stay on the card during the epoch: one sync per epoch
            epoch_losses = []
            with trace(trace_dir if epoch == start_epoch + 1 else None):
                for E_d, lay_d, data_d in self._epoch_batches(timer):
                    if n_batches is not None and len(epoch_losses) == n_batches:
                        break
                    with timer.phase("step"):
                        epoch_losses.append(
                            self.train_step(data_d, E_d, lay_d if layer_cond else None)
                        )
            train_loss = (float(mesh_lib.all_reduce_mean(self.mesh, torch.stack(epoch_losses))
                                .mean()) if epoch_losses else 0.0)
            print(f"epoch phases: {timer.summary()}", flush=True)
            training_losses[epoch] = train_loss
            print(f"loss: {train_loss}")

            val_loss = 0.0
            if self.loader_val is not None:
                vl = []
                for vdata, vE, vlay, rnd, mask, n_real in self._val_batches(val_rnd):
                    with self._rows(vdata.shape[0], n_real):
                        vl.append(self.val_step(vdata, vE, vlay if layer_cond else None, rnd,
                                                mask))
                val_loss = (float(mesh_lib.all_reduce_mean(self.mesh, torch.stack(vl)).mean())
                            if vl else 0.0)
                val_losses[epoch] = val_loss
                print(f"val_loss: {val_loss}", flush=True)

            if self._swa_due(epoch, early_stopper):
                self._swa_update()

            # quirk preserved: the plateau scheduler steps on the TRAIN loss
            # (reference train_diffusion.py:110)
            self._set_lr(scheduler.step(train_loss))

            if val_loss < min_validation_loss and self.save_model:
                # EMA/SWA ride along so best_val loads through inference_params
                arrays = {"params": self.model.state_dict()}
                if self.ema_params is not None:
                    arrays["ema_params"] = self.ema_params
                if self.swa_params is not None and self.swa_n > 0:
                    arrays["swa_params"] = self.swa_params
                self._write_arrays("best_val", arrays,
                                   {"epoch": epoch, "swa_n": int(self.swa_n)})
                min_validation_loss = val_loss

            if early_stopper.early_stop(val_loss):
                print("Early stopping!")
                break

            self._save("checkpoint", epoch, training_losses, val_losses,
                       scheduler, early_stopper)
            # Python's gc triggers on object counts, not bytes: collect the
            # host buffers a streamed epoch leaves in reference cycles
            gc.collect()

        return epoch, training_losses, val_losses
