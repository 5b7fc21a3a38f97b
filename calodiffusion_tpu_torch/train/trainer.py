"""Training loops, on one CUDA card.

Port of ``calodiffusion_tpu/train/trainer.py``: ``Train`` is the harness
(checkpoint-dir layout, resume, epoch loop scaffolding; reference
calodiffusion/train/train.py) and ``TrainDiffusion`` the concrete diffusion
trainer (reference train/train_diffusion.py).

PyTorch runs eagerly: one train step is the sigma draw, noising, forward,
loss, ``backward`` and the Adam update on the model's own parameters
(``torch.optim.Adam`` with optax's defaults: betas 0.9/0.999, eps 1e-8).
The plateau LR is set on the optimizer's param_groups.  Batches come from
``loader_train``/``loader_val``, iterables of numpy ``(E, layers, data)``;
randomness comes from a ``torch.Generator`` on the card seeded from
``flags.seed``.  Not ported yet: the data loader (``load_data``), cold
diffusion and scale-out over several cards.
"""

from __future__ import annotations

import gc
import json
import os
from typing import Optional

import numpy as np
import torch

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.samplers.base import randn
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train.schedulers import EarlyStopper, ReduceLROnPlateau
from calodiffusion_tpu_torch.utils.device import resolve_device
from calodiffusion_tpu_torch.utils.profiling import StepTimer


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
    def __init__(self, flags, config, loader_train=None, loader_val=None,
                 save_model: bool = True, device=None):
        self.flags = flags
        self.config = config
        self.save_model = save_model
        self.batch_size = config.get("BATCH", 256)
        self.device = resolve_device(device)
        self.loader_train, self.loader_val = loader_train, loader_val

        # checkpoint-dir naming parity (reference train.py:23-41)
        name = f"{config['CHECKPOINT_NAME']}_{self.__class__.__name__.removeprefix('Train')}"
        self.checkpoint_folder = os.path.join(
            getattr(flags, "checkpoint_folder", "./trained_models/"), name
        )
        if getattr(flags, "model_loc", None):
            self.checkpoint_folder = os.path.dirname(flags.model_loc)
        if self.save_model:
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

    # -- checkpointing -----------------------------------------------------
    def _save(self, name, epoch, training_losses, val_losses, scheduler, early_stopper):
        if not self.save_model:
            return
        ckpt_io.save_checkpoint(
            self.checkpoint_folder, name,
            params=self.model.state_dict(), opt_state=self.opt.state_dict(),
            ema_params=self.ema_params,
            swa_params=self.swa_params, swa_n=self.swa_n,
            epoch=epoch, training_losses=training_losses,
            val_losses=val_losses,
            scheduler_state=scheduler.state_dict(),
            early_stop_state=early_stopper.state_dict(),
        )

    def _checkpoint_location(self):
        model_loc = getattr(self.flags, "model_loc", None)
        if model_loc:
            name = os.path.basename(model_loc)
            for suffix in (".ckpt", ".pth"):
                name = name.removesuffix(suffix)
            return os.path.dirname(model_loc), name
        return self.checkpoint_folder, "checkpoint"

    def pickup_checkpoint(self, scheduler, early_stopper, restart_training):
        """Resume from checkpoint.pth-equivalent (reference train.py:60-102).
        Restores whatever the checkpoint holds; with EMA on and no EMA in
        the checkpoint, the EMA restarts from the restored params."""
        folder, name = self._checkpoint_location()
        arrays, host = ckpt_io.load_checkpoint(folder, name, map_location=self.device)
        self.model.load_state_dict(arrays["params"])
        if arrays.get("opt_state") is not None and not restart_training:
            self.opt.load_state_dict(arrays["opt_state"])
        if self.ema_params is not None:
            self.ema_params = _copy(arrays.get("ema_params") or self.model.state_dict())
        if arrays.get("swa_params") is not None and not restart_training:
            self.swa_params = _copy(arrays["swa_params"])
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
        self.model.load_state_dict(ckpt_io.inference_params(arrays, host))
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
    def _accumulate_grads(self, data, E, layers, noise=None, rnd_normal=None):
        """Set the parameters' ``.grad`` to the batch's loss gradient and
        return the loss.  With ``TRAIN_MICROBATCH`` and a batch it divides,
        the batch runs as sequential chunks and the gradient is the mean of
        the per-chunk gradients (trainer.py:373-400).  ``noise`` and
        ``rnd_normal`` may be injected (tests); chunks then take slices."""
        micro = int(self.config.get("TRAIN_MICROBATCH", 0) or 0)
        B = data.shape[0]
        n_chunks = B // micro if micro and B > micro and B % micro == 0 else 1
        size = B // n_chunks
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        loss_sum = torch.zeros((), device=data.device)
        for i in range(n_chunks):
            sl = slice(i * size, (i + 1) * size)

            def part(a):
                return None if a is None else a[sl]

            loss = self.model.compute_loss(
                data[sl], E[sl], self.generator, layers=part(layers),
                noise=part(noise), rnd_normal=part(rnd_normal),
            )
            loss.backward()
            loss_sum += loss.detach()
        if n_chunks > 1:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(n_chunks)
        return loss_sum / n_chunks

    @torch.no_grad()
    def _apply_update(self):
        """One Adam step on the accumulated gradients, then the EMA
        (trainer.py:405-411)."""
        self.opt.step()
        if self.ema_decay > 0:
            for k, p in self.model.state_dict().items():
                self.ema_params[k].mul_(self.ema_decay).add_(p, alpha=1 - self.ema_decay)

    def train_step(self, data, E, layers):
        loss = self._accumulate_grads(data, E, layers)
        self._apply_update()
        return loss

    @torch.no_grad()
    def val_step(self, data, E, layers, rnd_normal, mask):
        """Val loss with fixed per-batch sigma draws (``rnd_normal``) and
        noise redrawn on every call (reference train_diffusion.py:87); a
        discrete-time sigma is drawn from a fixed seed, as the JAX package
        draws it from PRNGKey(0)."""
        noise = randn(data.shape, self.generator, self.device)
        fixed = torch.Generator(device=self.device).manual_seed(0)
        return self.model.loss_function(
            self.model.denoise_fn(), data, E, fixed,
            noise=noise, layers=layers, rnd_normal=rnd_normal, mask=mask,
        )

    # -- data --------------------------------------------------------------
    def _device_batch(self, E, layers, data):
        def put(a):
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
        """The fixed val working set: (data, E, layers, rnd_normal, mask)
        per batch, built once.  ``mask`` marks the batch's real rows; on one
        card no batch is padded, so it is all ones."""
        if self._val_cache is None:
            cache = []
            for i, (vE, vlayers, vdata) in enumerate(self.loader_val):
                if i >= val_rnd.shape[0]:
                    break
                n_real = np.asarray(vE).shape[0]
                vE_d, vlay_d, vdata_d = self._device_batch(vE, vlayers, vdata)
                mask = torch.ones(n_real, device=self.device)
                cache.append((vdata_d, vE_d, vlay_d, val_rnd[i][:n_real], mask))
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
        min_validation_loss = 99999.0
        epoch = start_epoch
        for epoch in range(start_epoch, num_epochs):
            print(f"Beginning epoch {epoch}", flush=True)
            # losses stay on the card during the epoch: one sync per epoch
            epoch_losses = []
            for E_d, lay_d, data_d in self._epoch_batches(timer):
                with timer.phase("step"):
                    epoch_losses.append(
                        self.train_step(data_d, E_d, lay_d if layer_cond else None)
                    )
            train_loss = float(torch.stack(epoch_losses).mean()) if epoch_losses else 0.0
            print(f"epoch phases: {timer.summary()}", flush=True)
            training_losses[epoch] = train_loss
            print(f"loss: {train_loss}")

            val_loss = 0.0
            if self.loader_val is not None:
                vl = [self.val_step(vdata, vE, vlay if layer_cond else None, rnd, mask)
                      for vdata, vE, vlay, rnd, mask in self._val_batches(val_rnd)]
                val_loss = float(torch.stack(vl).mean()) if vl else 0.0
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
                ckpt_io.save_arrays(os.path.join(self.checkpoint_folder, "best_val.ckpt"),
                                    arrays)
                with open(os.path.join(self.checkpoint_folder,
                                       "best_val_state.json"), "w") as f:
                    json.dump({"epoch": epoch, "swa_n": int(self.swa_n)}, f)
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
