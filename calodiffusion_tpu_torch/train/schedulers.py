"""Host-side training control: plateau LR schedule and early stopping.

optax has no ReduceLROnPlateau equivalent with torch's exact semantics, so
the torch logic is ported (factor=0.1, patience=15, rel threshold 1e-4,
reference train/train.py:145-147) together with the reference EarlyStopper
(reference utils/utils.py:787-813).  Both are tiny pure-python state
machines.  A copy of ``calodiffusion_tpu/train/schedulers.py``; in the port
the resulting learning rate is set on the torch optimizer's param_groups.
"""

from __future__ import annotations

import numpy as np


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau parity (mode=min,
    threshold_mode=rel)."""

    def __init__(
        self, lr: float, factor: float = 0.1, patience: int = 15,
        threshold: float = 1e-4, min_lr: float = 0.0,
    ):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = np.inf
        self.num_bad_epochs = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr, "best": float(self.best),
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


class EarlyStopper:
    """Reference EarlyStopper parity (utils/utils.py:787-813)."""

    def __init__(self, patience: int = 1, mode: str = "loss", min_delta: float = 0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = np.inf
        self.mode = mode

    def early_stop(self, var: float) -> bool:
        if self.mode == "val_loss":
            if var < self.min_validation_loss:
                self.min_validation_loss = var
                self.counter = 0
            elif var > self.min_validation_loss + self.min_delta:
                self.counter += 1
                if self.counter >= self.patience:
                    return True
            return False
        elif self.mode == "diff":
            if var < 0:
                self.counter = 0
            else:
                self.counter += 1
                if self.counter >= self.patience:
                    return True
            return False
        return False

    def state_dict(self) -> dict:
        return {
            "patience": self.patience, "min_delta": self.min_delta,
            "counter": self.counter,
            "min_validation_loss": float(self.min_validation_loss),
            "mode": self.mode,
        }

    def load_state_dict(self, d: dict) -> None:
        self.__dict__.update(d)
