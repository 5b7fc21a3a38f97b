#!/usr/bin/env python3
"""Per-resolution-level time attribution for the ds2 denoise step, on one
CUDA card.

    python3 scripts/torch_level_profile.py [--batch 128] [--iters 60]
        [--out FILE] [--device cpu]

The port's counterpart of ``scripts/level_profile.py``: it times structural
ablations of the U-Net at ds2's grid (45, 16, 9), widths [32, 32, 64, 32],
bf16, from seeded random weights:

  full               the real CondUnet (block and middle attention: 7 K1
                     launches a call)
  no_attn            all attention removed (no K1)
  l01_only           two levels (45x16x9 + 23x8x5), the deepest level and
                     the middle replaced by identity (4 K1 launches a call)
  l0_only            level 0 alone, everything below it identity (2)
  l0_only_no_attn    level 0 alone without attention (none)

and derives from them the attention's total, the part below level 0, the
part below level 1 and level 0's attention.

Timing: each case runs ``--iters`` (K) serial denoise iterations, the
1-channel output tiled to 3 channels in f32 and copied into the static
input as the next iteration's (the JAX body's carry).  ``graph_ms``: the K
iterations captured once in a ``torch.cuda.CUDAGraph``, best of 3 replays
over K, the counterpart of the JAX script's one executable (a ``lax.scan``
inside one jit).  ``eager_ms``: the same K iterations launched from
Python, timed with CUDA events, best of 3, over K: what the program pays.
``host_ms`` = eager - graph is the host's share.  Before capture, a
warm-up on a side stream builds every kernel the call launches and makes
K1's plan (``ops/linear_attention.kernel_plan``) and cuDNN's choices; a
capture that fails raises, and nothing is then timed eagerly instead.
Each case also holds the graph's output after K iterations against the
eager run's from the same start (``graph_vs_eager_*``, K1's bf16 tolerance
of ``ops/tolerances.py``) and records its K1 launches and Python calls
(warm-up, eager runs and capture; a replay launches nothing from Python).

The report ``--out`` (JSON) holds each case's times under its key and the
four derived lines of the JAX script (from the graph times, each with its
eager counterpart).  On the CPU (``--device cpu``) there is no graph:
``graph_ms`` is null and ``eager_ms`` a wall-clock time.  The script runs
on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch import nn

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.models import nn_modules as M  # noqa: E402
from calodiffusion_tpu_torch.ops import linear_attention  # noqa: E402
from calodiffusion_tpu_torch.ops.tolerances import K1_TOL  # noqa: E402

BATCH = 128
SHAPE = (45, 16, 9)
LS = [32, 32, 64, 32]
DTYPE = torch.bfloat16
ITERS = 60
WARMUP = 2  # calls on the side stream before the timed runs
REPS = 3  # timed eager runs and graph replays, the best kept

# each case: (key, the JAX script's label, model options, kept levels or None)
CASES = (
    ("full", "full [32,32,64,32]+attn", dict(block_attn=True, mid_attn=True), None),
    ("no_attn", "no attention", dict(block_attn=False, mid_attn=False), None),
    ("l01_only", "levels 0+1 only (+attn)", dict(block_attn=True, mid_attn=False), 2),
    ("l0_only", "level 0 only (+attn)", dict(block_attn=True, mid_attn=False), 1),
    ("l0_only_no_attn", "level 0 only, no attn", dict(block_attn=False, mid_attn=False), 1),
)
# the derived lines: (key, the JAX script's label, minuend, subtrahend)
DERIVED = (
    ("attention_total", "attention total", "full", "no_attn"),
    ("deep_part_below_l0", "deep part (below L0)", "full", "l0_only"),
    ("level2_mid_below_l1", "level2+mid (below L1)", "full", "l01_only"),
    ("l0_attn_cost", "L0-only attn cost", "l0_only", "l0_only_no_attn"),
)


class TruncatedUnet(nn.Module):
    """CondUnet with the part below ``keep_levels`` resolutions replaced by
    identity (timing ablation only, not a real model; JAX
    ``scripts/level_profile.py:41-107``).  The kept down levels are the
    CondUnet's (two ResnetBlocks, attention, a downsampling between kept
    levels); the up path builds its own blocks for the kept levels, as
    flax does: level ``keep - 1 - ind``'s widths, 2 dim_out -> dim_in, and
    an upsampling with ``extras[keep - 2 - ind]`` between them.  Names
    follow CondUnet's (``downs.i.j``, ``downs_attn.i``, ``ups.i.j``,
    ``ups_attn.i``, ``final_conv.0/1``).  ``mid_attn`` is accepted and
    ignored: the middle is gone."""

    def __init__(self, channels=3, out_dim=1, layer_sizes=(32, 32, 64, 32), cond_dim=128,
                 resnet_block_groups=8, mid_attn=False, block_attn=False, compress_Z=False,
                 cylindrical=False, data_shape=(45, 16, 9), time_embed=True, cond_embed=True,
                 cond_size=1, keep_levels=1, dtype=torch.float32, generator=None):
        super().__init__()
        del mid_attn
        ls = list(layer_sizes)
        in_out = list(zip(ls[:-1], ls[1:]))
        n_res = len(in_out)
        if not 1 <= keep_levels <= n_res:
            raise ValueError(f"keep_levels {keep_levels} outside 1..{n_res}")
        self.keep_levels, self.dtype = keep_levels, dtype
        half = cond_dim // 2
        kw = dict(cylindrical=cylindrical, dtype=dtype, generator=generator)

        def block(i, o, cond=cond_dim):
            return M.ResnetBlock(i, o, cond, resnet_block_groups, **kw)

        def attn_block(dim):
            return M.PreNormResidual(dim, M.LinearAttention(dim, **kw))

        self.init_conv = M.Conv3d(channels, ls[0], 3, padding=1, **kw)
        self.time_mlp = M.cond_mlp(1, half // 2, half, half, time_embed, True, dtype, generator)
        # the JAX TruncatedUnet's widths (hidden half // 2 with either embed)
        self.cond_mlp = M.cond_mlp(cond_size, half // 2, half, half, cond_embed, False, dtype,
                                   generator)
        extras = M.CondUnet.compute_extra_upsamples(data_shape, n_res, compress_Z)

        self.downs, self.downs_attn = nn.ModuleList(), nn.ModuleList()
        for ind in range(keep_levels):
            dim_in, dim_out = in_out[ind]
            level = [block(dim_in, dim_out), block(dim_out, dim_out)]
            if ind < n_res - 1 and ind < keep_levels - 1:
                level.append(M.downsample_module(dim_out, cylindrical, compress_Z, dtype,
                                                 generator))
            self.downs.append(nn.ModuleList(level))
            if block_attn:
                self.downs_attn.append(attn_block(dim_out))

        self.ups, self.ups_attn = nn.ModuleList(), nn.ModuleList()
        for ind in range(keep_levels):
            dim_in, dim_out = in_out[keep_levels - 1 - ind]
            level = [block(2 * dim_out, dim_in), block(dim_in, dim_in)]
            if ind < keep_levels - 1:
                level.append(M.upsample_module(dim_in, extras[keep_levels - 2 - ind],
                                               cylindrical, compress_Z, dtype, generator))
            self.ups.append(nn.ModuleList(level))
            if block_attn:
                self.ups_attn.append(attn_block(dim_in))

        self.final_conv = nn.Sequential(block(ls[0], ls[0], cond=None),
                                        M.Conv3d(ls[0], out_dim, 1, **kw))

    def forward(self, x, cond, time=None):
        x = self.init_conv(x.to(self.dtype))
        conditions = torch.cat([self.time_mlp(time), self.cond_mlp(cond)], dim=-1)
        hs = []
        for ind, level in enumerate(self.downs):
            x = level[1](level[0](x, conditions), conditions)
            if len(self.downs_attn):
                x = self.downs_attn[ind](x)
            hs.append(x)
            if len(level) > 2:
                x = level[2](x)
        for ind, level in enumerate(self.ups):
            x = torch.cat([x, hs.pop()], dim=1)
            x = level[1](level[0](x, conditions), conditions)
            if len(self.ups_attn):
                x = self.ups_attn[ind](x)
            if len(level) > 2:
                x = level[2](x)
        x = self.final_conv[0](x)
        return self.final_conv[1](x).float()


def k1_blocks(model: nn.Module) -> int:
    """The fused attention blocks of ``model`` (K1 launches a call on the card)."""
    return sum(isinstance(m, M.PreNormResidual) and isinstance(m.fn.fn, M.LinearAttention)
               and m.fn.fn.heads == 1 for m in model.modules())


def check_device(device) -> None:
    if str(device) != "cpu" and not torch.cuda.is_available():
        sys.exit("no CUDA card here: pass --device cpu to run on the CPU")


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("CPU" off the card)."""
    if str(device) == "cpu":
        return "CPU"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_chain(body, state, iters: int, device, reps: int = REPS, warmup: int = WARMUP,
               graph_reps: int | None = None) -> dict:
    """Time ``iters`` serial calls of ``body`` (one iteration: reads and
    writes the static tensors ``state`` in place) eagerly, the best of
    ``reps`` runs, and, on the card, as one captured CUDA graph, the best of
    ``graph_reps`` (default ``reps``) replays; see the module docstring.
    Returns {"eager_ms", "graph_ms", "graph_vs_eager_max_abs_err",
    "graph_vs_eager_ok", "calls"}, the times per iteration; the last two
    compare the state after the graph's replay with the state after the
    eager run, both from the start."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    start = [t.clone() for t in state]
    calls = 0

    def reset():
        for t, t0 in zip(state, start):
            t.copy_(t0)

    # warm-up: builds, K1's plans, cuDNN's choices; on a side stream, as
    # capture wants
    side = torch.cuda.Stream(device) if cuda else None
    if cuda:
        side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
        for _ in range(warmup):
            body()
            calls += 1
    if cuda:
        torch.cuda.current_stream(device).wait_stream(side)
    _sync(device)

    eager = float("inf")
    for _ in range(reps):
        reset()
        _sync(device)
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            wall = time.perf_counter()
        for _ in range(iters):
            body()
        calls += iters
        if cuda:
            t1.record()
            t1.synchronize()
            eager = min(eager, t0.elapsed_time(t1) / iters)
        else:
            eager = min(eager, 1e3 * (time.perf_counter() - wall) / iters)
    out = [t.clone() for t in state]
    res = dict(eager_ms=eager, graph_ms=None, graph_vs_eager_max_abs_err=None,
               graph_vs_eager_ok=None, calls=calls)
    if not cuda:
        return res

    reset()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # a failed capture raises: no eager stand-in
        for _ in range(iters):
            body()
    res["calls"] += iters
    best = float("inf")
    for _ in range(graph_reps or reps):
        reset()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        best = min(best, t0.elapsed_time(t1) / iters)
    res["graph_ms"] = best
    err, ok = 0.0, True
    atol, rtol = K1_TOL[torch.bfloat16]
    for g, e in zip(state, out):
        diff = (g.float() - e.float()).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= atol + rtol * e.float().abs()).all())
    res.update(graph_vs_eager_max_abs_err=err, graph_vs_eager_ok=ok)
    del graph
    return res


def make_model(model_kwargs: dict, keep_levels=None, *, layer_sizes=None, shape=None,
               cond_dim=128, dtype=DTYPE, device="cuda", seed=0) -> nn.Module:
    """The JAX script's model (``timed``'s ``klass(...)``): 3 input channels,
    out 1, cylindrical, compress Z, sinusoidal time and energy embeds, from
    seeded weights, at ``layer_sizes`` (default ``LS``) on the grid ``shape``
    (default ``SHAPE``); a ``TruncatedUnet`` where ``keep_levels`` is given."""
    kw = dict(channels=3, out_dim=1, layer_sizes=tuple(layer_sizes or LS), cond_dim=cond_dim,
              cylindrical=True, compress_Z=True, data_shape=tuple(shape or SHAPE), cond_size=1,
              dtype=dtype, generator=torch.Generator().manual_seed(seed), **model_kwargs)
    model = (M.CondUnet(**kw) if keep_levels is None
             else TruncatedUnet(keep_levels=keep_levels, **kw))
    return model.to(device).eval()


def timed(name, model, iters=ITERS, batch=BATCH, shape=None, device="cuda", seed=0) -> dict:
    """K serial denoise iterations of ``model`` (the JAX ``timed``'s body:
    x (B, 3, Z, A, R) normal, energy 0.5, time 0.3; the output tiled to 3
    channels in f32 is the next input), timed as ``time_chain`` does."""
    g = torch.Generator().manual_seed(seed)
    before = linear_attention.fused_attention_block.launches
    with torch.inference_mode():
        x = torch.randn((batch, 3, *(shape or SHAPE)), generator=g).to(device)
        cond = torch.full((batch,), 0.5, device=device)
        tvec = torch.full((batch,), 0.3, device=device)

        def body():
            out = model(x, cond, tvec)
            x.copy_(out.expand(-1, 3, -1, -1, -1))

        res = time_chain(body, [x], iters, device)
    res["k1_blocks"] = k1_blocks(model)
    res["k1_launches"] = linear_attention.fused_attention_block.launches - before
    res["host_ms"] = None if res["graph_ms"] is None else res["eager_ms"] - res["graph_ms"]
    graph = "n/a" if res["graph_ms"] is None else f"{res['graph_ms']:7.2f}"
    print(f"{name:28s}: {graph} ms/denoise graphed, {res['eager_ms']:7.2f} eager", flush=True)
    return res


def derived(cases: dict, lines=DERIVED, width: int = 23) -> dict:
    """The JAX script's derived lines (``lines``: key, label, minuend case,
    subtrahend case or None) from the cases' graph times (eager on the
    CPU), each with its eager counterpart (``<key>_eager_ms``)."""
    out = {}
    for key, label, a, b in lines:
        src = "graph_ms" if cases[a]["graph_ms"] is not None else "eager_ms"
        for suffix, field in (("ms", src), ("eager_ms", "eager_ms")):
            out[f"{key}_{suffix}"] = cases[a][field] - (cases[b][field] if b else 0.0)
        print(f"{label:{width}s}: {out[f'{key}_ms']:6.2f} ms ({out[f'{key}_eager_ms']:6.2f} "
              "eager)", flush=True)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS, help="serial denoises a timing (K)")
    ap.add_argument("--out", default=None, help="JSON report")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def write_report(report: dict, out) -> None:
    if out:
        path = Path(out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=1))
        print(f"wrote {path}", flush=True)


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    check_device(opts.device)
    card = card_line(opts.device)
    print(card, flush=True)
    cases = {}
    for key, label, kw, keep in CASES:
        model = make_model(kw, keep, device=opts.device)
        cases[key] = dict(timed(label, model, opts.iters, opts.batch, device=opts.device),
                          label=label)
        del model
    print()
    report = dict(batch=opts.batch, iters=opts.iters, shape=list(SHAPE), layer_sizes=list(LS),
                  dtype="bfloat16", card=card, cases=cases, **derived(cases))
    write_report(report, opts.out)
    return report


if __name__ == "__main__":
    main()
