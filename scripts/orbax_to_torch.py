#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (Orbax) into the port's.

    python scripts/orbax_to_torch.py -c config.json --folder CKPT_DIR \\
        [--name checkpoint] --out OUT_DIR

Reads ``<CKPT_DIR>/<name>.ckpt`` (the Orbax directory that
``calodiffusion_tpu/train/checkpoint.py`` writes) and
``<CKPT_DIR>/<name>_state.json``; writes ``<OUT_DIR>/<name>.ckpt`` (one
``torch.save`` file, as ``calodiffusion_tpu_torch/train/checkpoint.py``
reads it) and a copy of the state file, whose format both packages share.

- ``params``, ``ema_params`` and ``swa_params`` go through the port's
  ``tools/jax_import``: a CondUnet (or dense "FCN") tree through
  ``params_to_state_dict``, the cascade's ``{"base_model", "layer_model"}``
  through ``layer_params_to_state_dict``, a ControlNet tree through
  ``controlled_unet_params_to_state_dict``.
- ``opt_state``, optax's ``inject_hyperparams(adam)`` state (``count``,
  ``hyperparams``, inner ``ScaleByAdamState`` ``mu`` / ``nu``), becomes
  ``torch.optim.Adam``'s state_dict: ``step`` the update count,
  ``exp_avg`` / ``exp_avg_sq`` the moments (mapped as the weights are), in
  the order of the port model's ``parameters()``, and the group's ``lr``,
  betas and eps the hyperparameters.  optax's and torch's Adam take the same
  step from these (eps outside the square root, the same bias
  corrections).  No JAX trainer trains a ControlNet, so its tree converts
  without an optimizer state.

The script needs orbax (and so jax): run it where the JAX package runs.  The
port never imports it.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from calodiffusion_tpu_torch.tools import jax_import  # noqa: E402
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io  # noqa: E402
from calodiffusion_tpu_torch.utils.config import LoadJson  # noqa: E402


def restore(path: str) -> dict:
    """The Orbax tree at ``path`` as nested dicts and lists of numpy arrays."""
    import orbax.checkpoint as ocp

    return _numpy(ocp.StandardCheckpointer().restore(os.path.abspath(path)))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return None if tree is None else np.asarray(tree)


def kind_of(params: dict) -> str:
    """"layer" (the cascade), "controlnet" or "diffusion"."""
    tree = params.get("params", params)
    if "base_model" in params:
        return "layer"
    if "control_model" in tree:
        return "controlnet"
    return "diffusion"


def weights(params: dict, config: dict, kind: str) -> dict:
    """A JAX parameter tree (or a tree of its shape: Adam's moments) as the
    port's state_dict."""
    convert = {"layer": jax_import.layer_params_to_state_dict,
               "controlnet": jax_import.controlled_unet_params_to_state_dict,
               "diffusion": jax_import.params_to_state_dict}[kind]
    return convert(params, config)


def port_parameter_names(config: dict, kind: str) -> list[str]:
    """The port model's parameter names in ``parameters()`` order, the
    order of ``torch.optim.Adam``'s state indices."""
    if kind == "layer":
        from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion as Model
    else:
        from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion as Model
    model = Model(config, n_steps=config.get("NSTEPS", 400), device="cpu")
    return [k for k, _ in model.named_parameters()]


def adam_state(opt_state: dict, config: dict, kind: str) -> dict:
    """optax's ``inject_hyperparams(adam)`` state as ``torch.optim.Adam``'s
    state_dict over the port model's parameters."""
    if kind == "controlnet":
        raise ValueError("a ControlNet checkpoint with an optimizer state: no JAX trainer "
                         "writes one, and the converter maps none")
    adam = opt_state["inner_state"][0]
    hyper = opt_state["hyperparams"]
    mu, nu = weights(adam["mu"], config, kind), weights(adam["nu"], config, kind)
    names = port_parameter_names(config, kind)
    step = torch.tensor(float(adam["count"]), dtype=torch.float32)
    group = dict(lr=float(hyper["learning_rate"]),
                 betas=(float(hyper.get("b1", 0.9)), float(hyper.get("b2", 0.999))),
                 eps=float(hyper.get("eps", 1e-8)))
    template = torch.optim.Adam([torch.nn.Parameter(torch.zeros(1)) for _ in names],
                                **group).state_dict()
    state = {i: {"step": step.clone(), "exp_avg": mu[k], "exp_avg_sq": nu[k]}
             for i, k in enumerate(names)}
    return {"state": state, "param_groups": template["param_groups"]}


def convert(config: dict, folder: str, name: str, out: str) -> str:
    """Convert ``<folder>/<name>.ckpt`` (+ state) into ``<out>/<name>.ckpt``;
    returns the written path."""
    tree = restore(os.path.join(folder, f"{name}.ckpt"))
    kind = kind_of(tree["params"])
    arrays = {k: weights(tree[k], config, kind)
              for k in ("params", "ema_params", "swa_params") if tree.get(k) is not None}
    if tree.get("opt_state") is not None:
        arrays["opt_state"] = adam_state(tree["opt_state"], config, kind)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{name}.ckpt")
    ckpt_io.save_arrays(path, arrays)
    state = os.path.join(folder, f"{name}_state.json")
    if os.path.exists(state):
        shutil.copyfile(state, os.path.join(out, f"{name}_state.json"))
    return path


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True, help="the run's config (json)")
    ap.add_argument("--folder", required=True, help="the JAX checkpoint folder")
    ap.add_argument("--name", default="checkpoint",
                    help="checkpoint, best_val or final (default checkpoint)")
    ap.add_argument("--out", required=True, help="folder for the port's checkpoint")
    args = ap.parse_args(argv)
    path = convert(LoadJson(args.config), args.folder, args.name, args.out)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
