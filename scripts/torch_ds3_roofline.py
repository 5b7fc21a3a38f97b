#!/usr/bin/env python3
"""Per-component roofline of the ds2/ds3 sampling path on one CUDA card:
each conv shape of the U-Net mix against the card's bound, in both
layouts, and whole-model sampling with its attention ablations.

    python3 scripts/torch_ds3_roofline.py [--which ds3|ds2|all] [--iters 30]
        [--steps 400] [--batch 128] [--out FILE] [--device cpu]

The port's counterpart of ``scripts/ds3_roofline.py``.

``conv_case``: one 3x3x3 "same" conv pair cin -> cout -> cin with a tanh
between (zero padding; the cylindrical wrap is left out, as in the JAX
script), bf16, at the ten level geometries of ds2 and ds3, chained
``--iters`` (K) times.  Each case runs in two layouts (``layout``):
``ncdhw``, as the port's U-Net runs its convs, and ``channels_last_3d``
(the JAX script's NDHWC: activations and weights in torch's channels-last
memory format, so cuDNN runs its NDHWC kernels).  The JAX script's TPU
fields (the v5e peak of 197 TFLOP/s and the 128-lane "padded ideal") are
gone; in their place stand the card's ``bound_ms`` a conv, the larger of
the pair's bytes (x read once, the result written once, both weights read
once) over 3.35 TB/s and its FLOPs over 989 TFLOP/s (bf16 tensor cores;
PERF.md §6's definition), halved, ``bound_by`` and ``pct_of_bound`` (bound
over time).  ``useful_mfu_pct`` is taken against 989 TFLOP/s.

``model_measurements``: ``CaloDiffusion`` from ``configs/config_dataset2.json``
or ``config_dataset3.json`` at full width (bf16), seeded random weights,
sampled with ``--steps``-step DDim at batch ``--batch`` for the three
attention settings (``full``, ``no_block_attn``: the middle's attention
alone, ``no_attn``).  The configs' U-Nets are bench.py's ``_dataset_config``
ones (widths, attention, grid), except that ds3's config maps its showers
with "logit-norm", so its energy MLP takes 1 input where bench's takes 47.
The sampling loop that ``CaloDiffusion.sample`` runs (the DDim sampler on a
fixed start) is timed eagerly (CUDA events; one warm-up run and one timed,
as the JAX script's ``runs=1``: ``showers_per_sec`` and ``eager_ms`` a
step) and as one CUDA
graph of all its steps (best of 3 replays: ``graph_showers_per_sec`` and
``graph_ms`` a step; the counterpart of the JAX script's one jitted
``sample``).  The FLOPs of a denoise come from
``torch.utils.flop_counter.FlopCounterMode`` (convolutions and matrix
products) with each fused attention block counted by K1's operation count,
``2 B N (96 C + 2 32 32 + 32 C)`` (``chip_smoke.py``'s ``attention_bound``;
on the card K1 is a launch the counter cannot see, and on the CPU what the
counter sees of the block's plain version is replaced by the same count).
XLA's cost analysis, which gave the JAX script its FLOPs, counted the
elementwise operations too, so these FLOPs and the MFU from them are not
comparable with ``roofline_report.json``'s.  Nothing is swallowed: a
failed measurement stops the script.

The report ``--out`` (JSON) holds ``conv_cases`` and a ``ds2`` / ``ds3``
entry, the JAX script's keys plus the card's.  No ``roofline_report.json``
is written.  The script runs on the card unless ``--device cpu`` is given
(no graph there: the graph fields are null).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_level_profile as lp  # noqa: E402
from calodiffusion_tpu_torch.models import nn_modules as M  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PEAK = 989e12  # H100 SXM bf16 tensor cores, dense
ITERS = 30
STEPS = 400
BATCH = 128
D = 32  # the attention's dim_head
CONFIGS = {"ds2": ROOT / "configs" / "config_dataset2.json",
           "ds3": ROOT / "configs" / "config_dataset3.json"}
LAYOUTS = ("ncdhw", "channels_last_3d")
# the per-conv table: the two families' level mixes, (Z, A, R), cin, cout
CONV_CASES = {
    "ds2": [((45, 16, 9), 32, 32), ((45, 16, 9), 32, 64), ((23, 8, 5), 32, 32),
            ((12, 4, 3), 64, 64), ((6, 2, 2), 64, 64)],
    "ds3": [((45, 50, 18), 32, 32), ((45, 50, 18), 32, 64), ((23, 25, 9), 32, 32),
            ((12, 13, 5), 64, 64), ((6, 7, 3), 64, 64)],
}
ABLATIONS = (("full", {}), ("no_block_attn", {"BLOCK_ATTN": False}),
             ("no_attn", {"BLOCK_ATTN": False, "MID_ATTN": False}))


def log(msg):
    print(f"[roofline] {msg}", flush=True)


def pair_bound_ms(batch, spatial, cin, cout, elt=2) -> tuple[float, str]:
    """The card's least time for one cin -> cout -> cin pair: x read and the
    result written once, both weights read once, over the HBM rate; the two
    convs' FLOPs over the bf16 peak.  (ms, "bytes" or "operations")."""
    vox = spatial[0] * spatial[1] * spatial[2]
    nbytes = (2 * batch * vox * cin + 2 * 27 * cin * cout) * elt
    flops = 2 * batch * vox * 27 * cin * cout * 2
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def conv_case(batch, spatial, cin, cout, dtype_str="bf16", iters=ITERS, layout="ncdhw",
              device="cuda") -> dict:
    """One 3x3x3 conv pair at the given level geometry, K times serially;
    the achieved rate and the card's bound (module docstring)."""
    dtype = torch.bfloat16 if dtype_str == "bf16" else torch.float32
    fmt = torch.channels_last_3d if layout == "channels_last_3d" else torch.contiguous_format
    z, a, r = spatial
    x = torch.randn((batch, cin, z, a, r), generator=torch.Generator().manual_seed(0))
    w1 = torch.randn((cout, cin, 3, 3, 3), generator=torch.Generator().manual_seed(1)) * 0.05
    w2 = torch.randn((cin, cout, 3, 3, 3), generator=torch.Generator().manual_seed(2)) * 0.05
    x, w1, w2 = (t.to(device, dtype).contiguous(memory_format=fmt) for t in (x, w1, w2))

    with torch.inference_mode():
        x = x.clone(memory_format=fmt)

        def body():
            # cin -> cout -> cin so the iterations chain; each = 2 convs
            y = torch.tanh(F.conv3d(x, w1, padding=1))  # tanh defeats algebraic fusion
            x.copy_(F.conv3d(y, w2, padding=1))

        res = lp.time_chain(body, [x], iters, device)
    t_pair = res["graph_ms"] if res["graph_ms"] is not None else res["eager_ms"]
    flops_pair = 2 * batch * z * a * r * 27 * cin * cout * 2
    achieved = flops_pair / (t_pair * 1e-3)
    bound, bound_by = pair_bound_ms(batch, spatial, cin, cout, torch.finfo(dtype).bits // 8)
    return {
        "batch": batch, "spatial": list(spatial), "cin": cin, "cout": cout, "layout": layout,
        "time_per_conv_ms": t_pair / 2,
        "achieved_tflops": achieved / 1e12,
        "useful_mfu_pct": 100 * achieved / PEAK,
        "bound_ms": bound / 2, "bound_by": bound_by, "pct_of_bound": 100 * bound / t_pair,
        "graph_ms": res["graph_ms"], "eager_ms": res["eager_ms"],
        "host_ms": None if res["graph_ms"] is None else res["eager_ms"] - res["graph_ms"],
    }


def levels_for(shape, compress_z, widths):
    """U-Net level geometries (mirrors nn_modules' downsample chain)."""
    z, a, r = shape
    out = []
    for i in range(len(widths)):
        out.append((z, a, r))
        if i < len(widths) - 1:
            if compress_z:
                z = (z + 1) // 2
            a = (a + 1) // 2
            r = (r + 1) // 2
    return out


def k1_flops(B, N, C) -> int:
    """K1's operation count for one fused attention block call (chip_smoke.py
    ``attention_bound``): the qkv and output projections and the two
    32 x 32 context products per position."""
    return 2 * B * N * (96 * C + D * D + D * D + D * C)


def denoise_flops(model, x, E, sigma, layers) -> tuple[float, int]:
    """(FLOPs of one ``model.denoise`` call, fused attention blocks called):
    ``FlopCounterMode``'s count outside the fused attention blocks plus
    K1's count for each block call."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    inside, k1, hooks, marks = [0], [0], [], {}

    def pre(mod, args):
        marks[id(mod)] = counter.get_total_flops()

    def post(mod, args, out):
        inside[0] += counter.get_total_flops() - marks.pop(id(mod))
        b, c, *spatial = args[0].shape
        k1[0] += k1_flops(b, spatial[0] * spatial[1] * spatial[2], c)

    blocks = [m for m in model.net.modules() if isinstance(m, M.PreNormResidual)
              and isinstance(m.fn.fn, M.LinearAttention) and m.fn.fn.heads == 1]
    for m in blocks:
        hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        with torch.inference_mode(), counter:
            model.denoise(x, E=E, sigma=sigma, layers=layers)
    finally:
        for h in hooks:
            h.remove()
    return float(counter.get_total_flops() - inside[0] + k1[0]), len(blocks)


def measure_sampling(cfg, batch, steps, runs=1, device="cuda", seed=0) -> dict:
    """The port's ``bench.measure_sampling`` (bench.py:254-330) for one
    config: FLOPs of a denoise, then the DDim loop of ``CaloDiffusion.sample``
    timed eagerly and as one CUDA graph (module docstring)."""
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    model = CaloDiffusion(cfg, n_steps=steps, loss_type="l2", device=device,
                          generator=torch.Generator().manual_seed(seed))
    sampler = model.make_sampler("DDim")
    g = torch.Generator().manual_seed(seed + 1)
    n_cond = 3 if cfg.get("HGCAL") else 1
    E = torch.rand((batch, n_cond), generator=g).to(device)
    layers = (torch.randn((batch, cfg["SHAPE_FINAL"][2] + 1), generator=g).to(device)
              if model.layer_cond else None)
    shape = (batch, *model._data_shape)
    step_flops, blocks = denoise_flops(
        model, torch.zeros(shape, device=device), E,
        torch.ones((batch,) + (1,) * len(model._data_shape), device=device), layers)
    log(f"denoise step: {step_flops:.3e} FLOPs ({step_flops / batch / 1e9:.2f} "
        f"GFLOP/shower/step), {blocks} fused attention blocks")

    with torch.inference_mode():
        start = torch.randn(shape, generator=g).to(device)
        result = torch.empty_like(start)

        def body():
            result.copy_(sampler(model, start, E, layers, steps, 0, None, False))

        # one call = the whole sample: the "iterations" are the steps inside
        res = lp.time_chain(body, [start, result], 1, device, reps=runs, warmup=1,
                            graph_reps=lp.REPS)
        finite = bool(torch.isfinite(result).all())
    if not finite:
        raise RuntimeError(f"{cfg.get('CHECKPOINT_NAME')}: the sampled showers are not finite")
    eager, graph = res["eager_ms"] / steps, res["graph_ms"]
    graph = None if graph is None else graph / steps
    best = eager * steps * 1e-3
    flops = step_flops * steps
    return dict(showers_per_sec=batch / best, flops_per_run=flops, step_flops=step_flops,
                achieved_tflops=flops / best / 1e12, useful_mfu_pct=100 * flops / best / PEAK,
                k1_blocks=blocks, eager_ms=eager, graph_ms=graph,
                host_ms=None if graph is None else eager - graph,
                graph_showers_per_sec=None if graph is None else batch / (graph * steps * 1e-3),
                graph_useful_mfu_pct=(None if graph is None
                                      else 100 * step_flops / (graph * 1e-3) / PEAK),
                graph_vs_eager_max_abs_err=res["graph_vs_eager_max_abs_err"],
                unet_calls=res["calls"] * steps + 1, steps=steps, batch=batch)


def model_measurements(name, batch, steps=STEPS, device="cuda") -> dict:
    """Whole model: ``steps``-step DDim sampling and the FLOPs of a denoise,
    with the attention ablations."""
    with open(CONFIGS[name]) as f:
        base_cfg = json.load(f)
    results = {}
    for tag, over in ABLATIONS:
        cfg = dict(base_cfg, **over)
        row = measure_sampling(cfg, batch, steps, runs=1, device=device)
        results[tag] = row
        graph = ("n/a" if row["graph_showers_per_sec"] is None
                 else f"{row['graph_showers_per_sec']:.2f}")
        log(f"{name}/{tag}: {row['showers_per_sec']:.2f} showers/s eager, {graph} graphed; "
            f"MFU {row['useful_mfu_pct']:.2f} % eager")
    return results


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", choices=("ds3", "ds2", "all"), default="all")
    ap.add_argument("--iters", type=int, default=ITERS, help="serial conv pairs a timing (K)")
    ap.add_argument("--steps", type=int, default=STEPS, help="DDim steps of the model runs")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--out", default=None, help="JSON report")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    lp.check_device(opts.device)
    card = lp.card_line(opts.device)
    log(card)
    report = {"card": card}
    cases = []
    for family in ("ds2", "ds3"):
        if opts.which not in (family, "all"):
            continue
        for sp, cin, cout in CONV_CASES[family]:
            for layout in LAYOUTS:
                c = conv_case(opts.batch, sp, cin, cout, iters=opts.iters, layout=layout,
                              device=opts.device)
                c["family"] = family
                cases.append(c)
                log(f"{family} conv {sp} {cin}->{cout} {layout}: {c['achieved_tflops']:.1f} "
                    f"TF/s ({c['pct_of_bound']:.1f}% of bound {c['bound_ms']:.4f} ms, "
                    f"{c['bound_by']}); eager {c['eager_ms']:.4f} ms a pair")
    report["conv_cases"] = cases
    for name in ("ds3", "ds2"):
        if opts.which in (name, "all"):
            report[name] = model_measurements(name, opts.batch, opts.steps, device=opts.device)
    lp.write_report(report, opts.out)
    return report


if __name__ == "__main__":
    main()
