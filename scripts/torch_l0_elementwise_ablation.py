#!/usr/bin/env python3
"""How much of the L0 (full-resolution) cost is GroupNorm / elementwise
overhead, on one CUDA card?

    python3 scripts/torch_l0_elementwise_ablation.py [--batch 128] [--iters 60]
        [--out FILE] [--device cpu]

The port's counterpart of ``scripts/l0_elementwise_ablation.py``: it re-times
``torch_level_profile``'s level-0-only U-Net without attention with its
GroupNorms, then its GroupNorms and SiLUs, replaced by identity.  The
deltas bound what a fused conv + GroupNorm + SiLU block could recover at
L0.

The JAX script patches ``M.GroupNorm`` (looked up when flax builds a
module, inside the call) and ``flax.linen.silu``, which reaches two sites:
the SiLU of ``Block`` and the one in front of ``ResnetBlock``'s condition
Dense (not the GELUs of the conditioning MLPs).  The port builds its
modules in ``__init__``, so ``elementwise_identity`` swaps the built
model's instances: each ``Block``'s ``norm`` becomes ``nn.Identity``, and
with ``silu`` each ``ResnetBlock``'s ``mlp[0]`` (``nn.SiLU``) too, while
``F.silu`` in ``Block.forward`` (the one functional SiLU of
``models/nn_modules.py``) is replaced by identity through the module's
``F``.  Everything is restored on exit.

Timing as ``torch_level_profile.time_chain``: ``graph_ms`` (K iterations
captured once in a CUDA graph, best of 3 replays over K) and ``eager_ms``
(the same launched from Python, CUDA events) for each case; the JAX
script's three lines from the graph times, each with its eager
counterpart.  The report ``--out`` (JSON) holds them.  The script runs on
the card unless ``--device cpu`` is given (no graph there: ``graph_ms``
null).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import types
from pathlib import Path

import torch.nn.functional as F
from torch import nn

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_level_profile as lp  # noqa: E402
from calodiffusion_tpu_torch.models import nn_modules as M  # noqa: E402

NO_ATTN = dict(block_attn=False, mid_attn=False)
# each case: (key, the JAX script's label, GroupNorm off, SiLU off)
CASES = (
    ("l0_no_attn", "L0 only, no attn", False, False),
    ("l0_no_gn", "L0 only, no attn, no GN", True, False),
    ("l0_no_gn_no_silu", "L0, no GN, no SiLU", True, True),
)
# the JAX script's lines: (key, label, minuend, subtrahend or None)
DERIVED = (
    ("groupnorm_cost_at_l0", "GroupNorm cost at L0", "l0_no_attn", "l0_no_gn"),
    ("silu_cost_at_l0", "SiLU cost at L0", "l0_no_gn", "l0_no_gn_no_silu"),
    ("convs_only_l0_floor", "convs-only L0 floor", "l0_no_gn_no_silu", None),
)


def _identity(x, *args, **kwargs):
    return x


@contextlib.contextmanager
def elementwise_identity(model: nn.Module, gn: bool = True, silu: bool = False):
    """While entered, ``model``'s Block GroupNorms (``gn``) and the two SiLU
    sites of ``models/nn_modules.py`` (``silu``: ``F.silu`` in
    ``Block.forward``, ``nn.SiLU`` in ``ResnetBlock.mlp``) are identity."""
    swapped = []
    real_f = M.F
    try:
        for m in model.modules():
            if gn and isinstance(m, M.Block):
                swapped.append((m, "norm", m.norm))
                m.norm = nn.Identity()
            if silu and isinstance(m, M.ResnetBlock) and m.mlp is not None:
                swapped.append((m.mlp, "0", m.mlp[0]))
                m.mlp[0] = nn.Identity()
        if silu:
            fn = types.ModuleType("F_without_silu")
            fn.__dict__.update(F.__dict__)
            fn.silu = _identity
            M.F = fn
        yield model
    finally:
        M.F = real_f
        for parent, name, child in reversed(swapped):
            setattr(parent, name, child)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=lp.BATCH)
    ap.add_argument("--iters", type=int, default=lp.ITERS, help="serial denoises a timing (K)")
    ap.add_argument("--out", default=None, help="JSON report")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    lp.check_device(opts.device)
    card = lp.card_line(opts.device)
    print(card, flush=True)
    cases = {}
    for key, label, gn, silu in CASES:
        model = lp.make_model(NO_ATTN, 1, device=opts.device)
        with elementwise_identity(model, gn=gn, silu=silu):
            cases[key] = dict(lp.timed(label, model, opts.iters, opts.batch, device=opts.device),
                              label=label)
        del model
    print()
    out = lp.derived(cases, DERIVED, width=26)
    report = dict(batch=opts.batch, iters=opts.iters, shape=list(lp.SHAPE),
                  layer_sizes=list(lp.LS), dtype="bfloat16", card=card, cases=cases, **out)
    lp.write_report(report, opts.out)
    return report


if __name__ == "__main__":
    main()
