"""Checkpoint I/O.

Port of ``calodiffusion_tpu/train/checkpoint.py`` with ``torch.save`` in
place of Orbax, under the same artifact contract (reference
train/train.py:104-133): per-name checkpoints ("checkpoint", "best_val",
"final") carrying epoch, model/optimizer state, LR-scheduler and
early-stop state and the full loss histories, plus human-readable
``*_training_losses.txt`` / ``*_validation_losses.txt`` files and a
``config.json`` copy in the checkpoint folder (written by the trainer).

``<name>.ckpt`` is one ``torch.save`` file holding the tensors: params (the
U-Net state_dict), opt_state (the optimizer's state_dict) and, when
present, ema_params and swa_params; small host-side state (epoch, swa_n,
histories, scheduler/early-stop dicts) lives in ``<name>_state.json`` so
checkpoints remain human-inspectable.  Saves are atomic (temporary file,
then rename).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import torch


class CheckpointMissingError(ValueError):
    """No checkpoint exists at the requested location."""


def _abspath(p: str) -> str:
    return os.path.abspath(os.path.expanduser(p))


def save_arrays(path: str, tree: Any) -> None:
    """``torch.save`` to a temporary file beside ``path``, then rename: a
    crash mid-write never leaves a corrupt checkpoint."""
    path = _abspath(path)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_arrays(path: str, map_location=None) -> Any:
    return torch.load(_abspath(path), map_location=map_location, weights_only=True)


def save_checkpoint(
    folder: str,
    name: str,
    *,
    params: Any,
    opt_state: Any = None,
    ema_params: Any = None,
    swa_params: Any = None,
    swa_n: int = 0,
    epoch: int = 0,
    training_losses: dict | None = None,
    val_losses: dict | None = None,
    scheduler_state: dict | None = None,
    early_stop_state: dict | None = None,
) -> None:
    os.makedirs(folder, exist_ok=True)
    arrays = {"params": params}
    if opt_state is not None:
        arrays["opt_state"] = opt_state
    if ema_params is not None:
        arrays["ema_params"] = ema_params
    if swa_params is not None:
        arrays["swa_params"] = swa_params
    save_arrays(os.path.join(folder, name + ".ckpt"), arrays)

    host = {
        "epoch": int(epoch),
        "swa_n": int(swa_n),
        "train_loss_hist": {str(k): float(v) for k, v in (training_losses or {}).items()},
        "val_loss_hist": {str(k): float(v) for k, v in (val_losses or {}).items()},
        "scheduler_state": scheduler_state or {},
        "early_stop_dict": early_stop_state or {},
    }
    with open(os.path.join(folder, name + "_state.json"), "w") as f:
        json.dump(host, f)

    # human-readable loss histories (reference train.py:130-133)
    with open(os.path.join(folder, f"{name}_training_losses.txt"), "w") as f:
        f.write("\n".join(str(v) for v in (training_losses or {}).values()) + "\n")
    with open(os.path.join(folder, f"{name}_validation_losses.txt"), "w") as f:
        f.write("\n".join(str(v) for v in (val_losses or {}).values()) + "\n")


def inference_params(arrays: Any, host: dict) -> Any:
    """The weights inference should use from a loaded checkpoint:
    SWA tail average if one was accumulated (host ``swa_n`` > 0), else
    EMA, else raw params."""
    if host.get("swa_n", 0) and arrays.get("swa_params") is not None:
        return arrays["swa_params"]
    ema = arrays.get("ema_params")
    return ema if ema is not None else arrays["params"]


def load_checkpoint(folder: str, name: str, map_location=None):
    """Returns (arrays, host_state).  ``arrays`` has keys params[/opt_state,
    ema_params, swa_params]; tensors land on ``map_location``."""
    path = os.path.join(folder, name + ".ckpt")
    if not os.path.exists(_abspath(path)):
        raise CheckpointMissingError(f"No checkpoint at {path}")
    arrays = load_arrays(path, map_location)
    host = {}
    host_path = os.path.join(folder, name + "_state.json")
    if os.path.exists(host_path):
        with open(host_path) as f:
            host = json.load(f)
    host.setdefault("epoch", 0)
    host["train_loss_hist"] = {
        int(k): v for k, v in host.get("train_loss_hist", {}).items()
    }
    host["val_loss_hist"] = {
        int(k): v for k, v in host.get("val_loss_hist", {}).items()
    }
    return arrays, host
