#!/usr/bin/env python3
"""Where the time of dataset-2 (or dataset-3, dataset-1, HGCal) generation
and training goes, on one CUDA card.

    python3 scripts/torch_profile_ds2.py [--dataset 2] [--particle photon] [--calls 10]
                                         [--generate-reps 3] [--generate-batches 2]
                                         [--train-steps 10] [--int8] [--seed 0] [--out FILE]

Builds calodiffusion_tpu_torch's CaloDiffusion at the full width of
configs/config_dataset2.json (``--dataset 3``: config_dataset3.json;
``--dataset 1``: config_dataset1_{photon,pion}.json on chip_smoke.py's
synthetic binning of ``--particle``; ``--dataset hgcal``:
config_HGCal_{photons,pions}.json on chip_smoke.py's synthetic geometry of
``--particle``, its GLaM decode in ``generate``; bf16, seeded random
weights).  First, while the process is cold, times
``generate`` over ``--generate-batches`` batches of 128 with 400-step DDim
``--generate-reps`` times (host clock, synchronised), as chip_smoke.py
times it once.  Then warms up, times ``--calls`` denoise calls at batch 128
with CUDA events, traces the same calls with torch.profiler and sums device
time by kernel family.  Then does the same for ``--train-steps`` steps of
``TrainDiffusion.train_step`` (forward, backward, Adam) on one batch of the
config's BATCH (128 for ds2, 64 for ds3, 256 and 128 for HGCal's photons
and pions).  ``--int8`` then turns on W8A8 int8 sampling (``QUANT_INT8``,
calibrated on the first generate batch's conditioning) and does the same
for ``generate`` (one rep) and the denoise calls, Q1's two kernels
families of their own (``int8_conv3d_quantize``, the quantize pass;
``int8_conv3d``, the GEMM).  Prints the top kernels and one JSON line;
``--out`` also writes them to a JSON file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion  # noqa: E402
from calodiffusion_tpu_torch.ops import cuda_build, int8_conv, linear_attention  # noqa: E402
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion  # noqa: E402
from calodiffusion_tpu_torch.utils.config import default_flags, load_config  # noqa: E402

FAMILIES = (  # first match wins; matched against lower-case kernel names
    ("fused_attention_block", ("attention_block_kernel",)),
    ("attention_block_backward", ("attention_block_bwd_kernel",)),
    # Q1: its quantize pass, and its GEMM
    ("int8_conv3d_quantize", ("quantize_pad_kernel",)),
    ("int8_conv3d", ("int8_gemm_kernel",)),
    ("optimizer", ("multi_tensor", "foreach", "adam")),
    # cuDNN's transposes of NCDHW activations to NHWC and back
    ("layout_transpose", ("nchwtonhwc", "nhwctonchw")),
    ("convolution", ("conv", "xmma", "implicit", "cudnn", "sm90", "dgrad", "wgrad")),
    ("group_norm", ("group_norm", "groupnorm", "welford", "rowwisemoments")),
    ("copy_cast_pad", ("copy", "cast", "pad", "cat", "fill")),
    ("gemm", ("gemm", "cutlass")),
)


def family(name: str) -> str:
    # PyTorch names most elementwise kernels "gpu_kernel_impl_nocast<...>":
    # that "cast" says nothing of what the kernel does
    low = name.lower().replace("_nocast", "")
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise_other"


def time_and_profile(fn, calls):
    """(CUDA-event ms per call, host-wall ms per call, {kernel: [ms, launches]}
    per call) of ``calls`` calls of ``fn`` after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    event_ms = start.elapsed_time(end) / calls

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        # a user annotation (Optimizer.step#Adam.step) spans kernels that
        # are counted on their own: skip it
        annotation = getattr(ev, "is_user_annotation", False)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            by_kernel[ev.key][0] += dev_us / 1e3 / calls
            by_kernel[ev.key][1] += ev.count // calls
    return event_ms, wall_ms, dict(by_kernel)


def summary(event_ms, wall_ms, by_kernel, unit):
    """The JSON fields of one profiled call: times, idle share, families."""
    device_ms = sum(v[0] for v in by_kernel.values())
    fams = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_kernel.items():
        fams[family(name)][0] += ms
        fams[family(name)][1] += n
    return {
        f"{unit}_ms_events": event_ms, f"{unit}_ms_host_wall": wall_ms,
        f"profiled_device_ms_per_{unit}": device_ms,
        f"{unit}_device_idle_share": (1 - device_ms / event_ms) if device_ms else None,
        f"kernels_per_{unit}": sum(v[1] for v in by_kernel.values()),
        f"families_ms_per_{unit}": {k: {"ms": v[0], "launches": v[1]}
                                    for k, v in sorted(fams.items(), key=lambda kv: -kv[1][0])},
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=("1", "2", "3", "hgcal"), default="2")
    ap.add_argument("--particle", choices=("photon", "pion"), default="photon",
                    help="dataset 1's or HGCal's config")
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--generate-reps", type=int, default=3)
    ap.add_argument("--generate-batches", type=int, default=2)
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--int8", action="store_true",
                    help="also generate and profile the denoise with QUANT_INT8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, help="JSON file for the result and the top kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    # the kernels' build is set-up, not generation
    cuda_build.build_all(linear_attention.BUILDS + int8_conv.KERNEL.builds)
    if args.dataset == "1":  # the binning XML is not in the repository: chip_smoke's synthetic one
        import tempfile

        import chip_smoke

        xml = Path(tempfile.mkdtemp()) / "binning.xml"
        xml.write_text(chip_smoke.ds1_binning_xml(args.particle))
        cfg = load_config(str(ROOT / "configs" / f"config_dataset1_{args.particle}.json"))
        cfg["BIN_FILE"] = str(xml)
    elif args.dataset == "hgcal":  # the geometry pickle is not in the repository either
        import tempfile

        import chip_smoke

        name = f"hgcal_{args.particle}s"
        cfg = load_config(str(ROOT / "configs" / chip_smoke.HGCAL_DATA[name]["config"]))
        cfg["BIN_FILE"] = chip_smoke.hgcal_geom_file(Path(tempfile.mkdtemp()), name, cfg)
    else:
        cfg = load_config(str(ROOT / "configs" / f"config_dataset{args.dataset}.json"))
    model = CaloDiffusion(cfg, generator=torch.Generator().manual_seed(args.seed))
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    B, n_layers = 128, cfg["SHAPE_FINAL"][2] + 1
    shape, nb = model._data_shape, args.generate_batches
    n_cond = 3 if cfg.get("HGCAL") else 1  # HGCal's E: three gen-info columns
    TB = cfg["BATCH"]

    rng = np.random.default_rng(args.seed)
    loader = [(rng.uniform(0.0, 1.0, (B, n_cond)).astype(np.float32),
               rng.standard_normal((B, n_layers)).astype(np.float32), None) for _ in range(nb)]
    generate_s = []
    for rep in range(args.generate_reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(loader, 400, generator=torch.Generator(device="cuda").manual_seed(rep))
        torch.cuda.synchronize()
        generate_s.append(time.perf_counter() - t0)
        print(f"generate {rep}: {nb * B} showers in {generate_s[-1]:.3f} s", flush=True)

    x = torch.randn(B, *shape, generator=g, device="cuda")
    E = torch.rand(max(B, TB), n_cond, generator=g, device="cuda")
    layers = (torch.randn(max(B, TB), n_layers, generator=g, device="cuda")
              if model.layer_cond else None)
    sigma = torch.full((B,) + (1,) * len(shape), 0.7, device="cuda")

    def call():
        with torch.inference_mode():
            return model.denoise(x, E=E[:B], sigma=sigma,
                                 layers=None if layers is None else layers[:B])

    event_ms, wall_ms, by_kernel = time_and_profile(call, args.calls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    denoise = summary(event_ms, wall_ms, by_kernel, "call")

    trainer = TrainDiffusion(default_flags(seed=args.seed), cfg, load_data=False,
                             save_model=False)
    trainer.init_model()
    trainer.make_optimizer(float(cfg["LR"]))
    data = torch.randn(TB, *shape, generator=g, device="cuda")
    t_event, t_wall, t_kernels = time_and_profile(
        lambda: trainer.train_step(data, E[:TB], None if layers is None else layers[:TB]),
        args.train_steps)
    train = summary(t_event, t_wall, t_kernels, "step")
    train["clocks_power_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    train_top = sorted(t_kernels.items(), key=lambda kv: -kv[1][0])[:25]
    int8_top = []
    if args.int8:
        model.config["QUANT_INT8"] = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prepare_int8(E=torch.from_numpy(loader[0][0]).cuda(),
                           layers=torch.from_numpy(loader[0][1]).cuda(), generator=g)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model.generate(loader, 400, generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        int8_generate_s = time.perf_counter() - t0
        print(f"int8 generate: {nb * B} showers in {int8_generate_s:.3f} s", flush=True)
        with model.int8_scope():
            i_event, i_wall, i_kernels = time_and_profile(call, args.calls)
        int8_top = sorted(i_kernels.items(), key=lambda kv: -kv[1][0])[:25]
        int8_denoise = summary(i_event, i_wall, i_kernels, "call")

    result = {
        "card": card, "dataset": args.dataset,
        "particle": args.particle if args.dataset in ("1", "hgcal") else None, "batch": B,
        "train_batch": TB,
        "calls": args.calls,
        "denoise_ms_events": event_ms, "denoise_ms_host_wall": wall_ms,
        "profiled_device_ms_per_call": denoise["profiled_device_ms_per_call"],
        "device_idle_share": denoise["call_device_idle_share"],
        "kernels_per_call": denoise["kernels_per_call"],
        "generate_s": generate_s,
        "generate_showers_per_s": [nb * B / t for t in generate_s],
        # generate's wall time beyond its denoise calls at the steady rate
        "generate_beyond_denoise_s": [t - nb * 400 * event_ms / 1e3 for t in generate_s],
        "families_ms_per_call": denoise["families_ms_per_call"],
        "train_steps": args.train_steps,
        "train_samples_per_s": TB / (t_event / 1e3),
        "train": train,
    }
    if args.int8:
        result["int8"] = dict(
            calibration_s=calib_s, generate_s=int8_generate_s,
            generate_showers_per_s=nb * B / int8_generate_s,
            denoise_ms_events=i_event, denoise_ms_host_wall=i_wall,
            profiled_device_ms_per_call=int8_denoise["profiled_device_ms_per_call"],
            device_idle_share=int8_denoise["call_device_idle_share"],
            kernels_per_call=int8_denoise["kernels_per_call"],
            families_ms_per_call=int8_denoise["families_ms_per_call"])
    if args.out:
        full = dict(result,
                    top_kernels=[{"name": k, "ms": v[0], "launches": v[1]} for k, v in top],
                    train_top_kernels=[{"name": k, "ms": v[0], "launches": v[1]}
                                       for k, v in train_top],
                    int8_top_kernels=[{"name": k, "ms": v[0], "launches": v[1]}
                                      for k, v in int8_top])
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(full, indent=1))
    for title, rows in (("denoise", top), ("train step", train_top), ("int8 denoise", int8_top)):
        print(f"-- {title}: top kernels, ms and launches per call")
        for k, v in rows:
            print(f"{v[0]:9.4f} ms  x{v[1]:4d}  {k[:110]}")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
