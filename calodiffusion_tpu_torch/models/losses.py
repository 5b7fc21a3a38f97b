"""Training-objective registry: the part that ``denoise`` needs.

Port of ``calodiffusion_tpu/models/losses.py:33-61,187-202`` (reference:
calodiffusion/models/loss.py).  A loss fixes ``sigma_data`` (and the
log-normal sigma draw) from ``NOISE_SCHED`` and the EDM in/skip/out
scalings that ``denoise`` applies.  The loss bodies and the other objectives
are not ported yet.
"""

from __future__ import annotations


class Loss:
    def __init__(self, config: dict, n_steps: int, loss_type: str = "l1"):
        self.config = config
        self.n_steps = n_steps
        self.loss_type = loss_type
        self.discrete_time = True
        self.P_mean = -1.0
        self.P_std = 1.0
        self.sigma_data = 0.5
        if "log" in config.get("NOISE_SCHED", "linear"):
            self.discrete_time = False
            self.P_mean = -1.2
            self.P_std = 1.2
            self.sigma_data = 1.0

    def get_scaling(self, sigma):
        sd = self.sigma_data
        return {
            "c_skip": sd**2 / (sigma**2 + sd**2),
            "c_out": sigma * sd / (sigma**2 + sd**2) ** 0.5,
            "c_in": 1 / (sigma**2 + sd**2) ** 0.5,
        }


class hybrid_weight(Loss):
    """EDM-style x0 target with (1 + 1/sigma^2) weighting (reference :163-179)."""


LOSS_REGISTRY = {"hybrid_weight": hybrid_weight}


def get_loss(name: str):
    """Resolve a loss by its config name (``TRAINING_OBJ``)."""
    try:
        return LOSS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"loss '{name}' is not yet ported to calodiffusion_tpu_torch; "
            f"ported: {list(LOSS_REGISTRY)}"
        ) from None
