"""Config and flag plumbing.

A copy of ``calodiffusion_tpu/utils/config.py``: the port imports nothing of the
JAX package.

The reference parses "JSON-ish" config files with ``yaml.safe_load`` so that
single-quoted keys and trailing commas are tolerated (reference:
calodiffusion/utils/utils.py:439-443 LoadJson).  Existing reference configs
must run unchanged, so we keep the same laxness.

CLI flags are carried in a ``dotdict`` and also injected into the config under
``config['flags']`` (reference: calodiffusion/inference.py:94-95).
"""

from __future__ import annotations

import json
import os
from typing import Any


class dotdict(dict):
    """dict with attribute access (reference: calodiffusion/training.py:6-10)."""

    __getattr__ = dict.get
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__


def LoadJson(file_name: str) -> dict:
    """Lax JSON loader: accepts single quotes / trailing commas via YAML.

    Strict JSON is tried first: YAML 1.1 parses ``1e-07`` (no dot) as a
    *string*, so numeric fields in well-formed JSON configs would silently
    come back as str through the yaml path."""
    with open(os.path.join(file_name)) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml  # only lax (non-JSON) configs need it

        return yaml.safe_load(text)


def load_config(config: str | dict) -> dict:
    return config if isinstance(config, dict) else LoadJson(config)


def default_flags(**overrides: Any) -> dotdict:
    """Flag set matching the reference CLIs' defaults."""
    flags = dotdict(
        config=None,
        checkpoint_folder="./trained_models/",
        data_folder="./data/",
        load=False,
        reset_training=False,
        reclean=False,
        nevts=-1,
        frac=0.85,
        seed=1234,
        batch_size=-1,
        model_loc=None,
        sample_algo=None,
        job_idx=-1,
        debug=False,
        model="diffusion",
    )
    flags.update(overrides)
    return flags
