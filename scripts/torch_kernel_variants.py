#!/usr/bin/env python3
"""Design variants of the K4 and K1 kernels, timed on one CUDA card.

    python3 scripts/torch_kernel_variants.py [--out FILE]

Each variant is the kernel's source in ``calodiffusion_tpu_torch/csrc/``
with a few text substitutions (a constant changed, two instructions
dropped), built with nvcc beside the port's own libraries (in
``_build/variants/``) and called through the port's launch functions.  For
each variant and bf16 shape: its device time from a torch.profiler trace,
and whether it stays within the kernel's tolerance of its plain version.

- K4 (blockwise softmax attention) at (B, H, N) = (4, 4, 40,500),
  (1, 8, 4096), (2, 4, 736): as built; ``single_p`` (P rounded once to
  bf16 for P V: no lo part); 2 and 8 warps a block; key tiles of 32 and 128.
- K1 (the attention block's forward) at the ds2 shapes, batch 128: as
  built, and with 8 warps a CTA at C = 32; then the as-built kernel with a
  timestamp (%globaltimer) at each phase's end in thread 0 of every CTA:
  the median CTA's phases and how many CTAs ran at once.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.ops import attention as att  # noqa: E402
from calodiffusion_tpu_torch.ops import cuda_build  # noqa: E402
from calodiffusion_tpu_torch.ops import linear_attention as la  # noqa: E402
from calodiffusion_tpu_torch.ops.tolerances import K1_TOL, K4_TOL  # noqa: E402

OUT_DIR = cuda_build.BUILD_DIR / "variants"
K4_SHAPES = [(4, 4, 40500), (1, 8, 4096), (2, 4, 736)]
K1_SHAPES = [(32, 6480), (64, 736), (32, 736), (32, 96), (64, 96)]
BATCH = 128

K4_VARIANTS = {
    "as_built": [],
    "single_p": [("        mma_bf16_16816(o[2 * dp], lo, b[0], b[1]);\n", ""),
                 ("        mma_bf16_16816(o[2 * dp + 1], lo, b[2], b[3]);\n", "")],
    "warps_2": [("constexpr int WARPS = 4;", "constexpr int WARPS = 2;")],
    "warps_8": [("constexpr int WARPS = 4;", "constexpr int WARPS = 8;")],
    "keys_32": [("constexpr int BK = 64; ", "constexpr int BK = 32; ")],
    "keys_128": [("constexpr int BK = 64; ", "constexpr int BK = 128;")],
}

# thread 0 of each CTA stamps the end of each phase
_STAMP = ("#define STAMP(i) if (threadIdx.x == 0) { unsigned long long t_; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          "g_stamps[blockIdx.x * 8 + (i)] = t_; }\n")
TRACE = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n__device__ unsigned long long g_stamps[1 << 16];\n" + _STAMP
     + "extern \"C\" int calo_read_stamps(void* dst) {\n"
       "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n"),
    ("  const float denom = static_cast<float>(C) * static_cast<float>(N);\n",
     "  const float denom = static_cast<float>(C) * static_cast<float>(N);\n  STAMP(0)\n"),
    ("    pre_sh[tid] = gn_pre_bias[tid] - sc * mu;\n  }\n  __syncthreads();\n",
     "    pre_sh[tid] = gn_pre_bias[tid] - sc * mu;\n  }\n  __syncthreads();\n  STAMP(1)\n"),
    ("  // the warps' partials -> the CTA's", "  STAMP(2)\n  // the warps' partials -> the CTA's"),
    ("  cluster.sync();  // every CTA has read the others' partials: y may take their place\n",
     "  cluster.sync();  // every CTA has read the others' partials: y may take their place\n"
     "  STAMP(3)\n"),
    ("  const float mu_y = cluster_sum(", "  STAMP(4)\n  const float mu_y = cluster_sum("),
    ("    post_sh[tid] = gn_post_bias[tid] - sc * mu_y;\n  }\n  __syncthreads();\n",
     "    post_sh[tid] = gn_post_bias[tid] - sc * mu_y;\n  }\n  __syncthreads();\n  STAMP(5)\n"),
    ("  cluster.sync();  // no CTA leaves", "  STAMP(6)\n  cluster.sync();  // no CTA leaves"),
]
PHASES = ["x load + pre-GN statistics", "phase A (k, v, ctx partials)", "ctx merge",
          "phase B (q, ctx^T q, W_o)", "post-GN statistics", "phase C (out)"]
K1_VARIANTS = {
    "as_built": [],
    "warps_8": [("constexpr int THREADS = CALO_BF16 && C == 32 ? 512 : 256;",
                 "constexpr int THREADS = 256;")],
    "stamped": TRACE,
}


def write_variant(kernel: str, name: str, subs) -> Path:
    src = (cuda_build.CSRC_DIR / f"{kernel}.cu").read_text()
    for old, new in subs:
        if old not in src:
            raise SystemExit(f"{kernel}.cu: variant {name} no longer applies ({old.strip()!r})")
        src = src.replace(old, new)
    path = OUT_DIR / f"{kernel}-{name}.cu"
    path.write_text(src)
    return path


def build(job):
    src, defines = job
    so = src.with_name(f"{src.stem}-{'-'.join(d.replace('=', '') for d in defines)}.so")
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{cuda_build.CSRC_DIR}",
           *(f"-D{d}" for d in defines), "-o", str(so), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src.name}:\n{proc.stderr[-4000:]}")
    regs = [ln.strip() for ln in proc.stdout.splitlines() + proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    return job, ctypes.CDLL(str(so)), regs


def device_ms(fn, key: str, reps: int) -> float:
    """Device time of one call: kernels named ``key`` in a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
               if key in ev.key) / 1e3 / reps


def within(got, want, tol) -> bool:
    atol, rtol = tol
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def block_inputs(N, C, seed):
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn(BATCH, N, C, generator=g), 1 + 0.1 * torch.randn(C, generator=g),
            0.1 * torch.randn(C, generator=g), 0.2 * torch.randn(C, 96, generator=g),
            0.2 * torch.randn(32, C, generator=g), 0.1 * torch.randn(C, generator=g),
            1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g)]
    args = [a.cuda() for a in args]
    for i in (0, 3, 4):
        args[i] = args[i].bfloat16().contiguous()
    return args


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="JSON file for the results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = [(write_variant(att.KERNEL.name, n, subs), ("CALO_BF16=1",))
            for n, subs in K4_VARIANTS.items()]
    jobs += [(write_variant(la.FORWARD_KERNEL, n, subs), la.variant(torch.bfloat16, C))
             for n, subs in K1_VARIANTS.items() for C in (32, 64)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = {job: (lib, regs) for job, lib, regs in pool.map(build, jobs)}
    result = {"card": card, "k4": {}, "k1": {}, "k1_phases": {}}
    for (src, defines), (_, regs) in built.items():
        print(f"build {src.stem} {' '.join(defines)}: {'; '.join(regs)}", flush=True)

    def lib_of(kernel, name, defines):
        return built[(OUT_DIR / f"{kernel}-{name}.cu", defines)][0]

    for B, H, N in K4_SHAPES:
        g = torch.Generator().manual_seed(N)
        q, k, v = (torch.randn(B, H, N, 32, generator=g).cuda().bfloat16() for _ in range(3))
        want = att.dense_attention(q, k, v, q_rows=max(1, (1 << 29) // (B * H * N)))
        for name in K4_VARIANTS:
            lib = att.KERNEL.bind(lib_of(att.KERNEL.name, name, ("CALO_BF16=1",)))
            ok = within(att.launch(lib, q, k, v), want, K4_TOL[torch.bfloat16])
            ms = device_ms(lambda: att.launch(lib, q, k, v), "blockwise_attention_kernel",
                           reps=3 if N > 8192 else 20)
            result["k4"][f"{name} {(B, H, N)}"] = dict(ms=ms, within_tol=ok)
            print(f"K4 {name} {(B, H, N)}: {ms:.4f} ms, within K4_TOL {ok}", flush=True)

    for C, N in K1_SHAPES:
        x_args = block_inputs(N, C, seed=C + N)
        want = la.attention_block_reference(*x_args)
        defines = la.variant(torch.bfloat16, C)
        for name in K1_VARIANTS:
            lib = la.bind(lib_of(la.FORWARD_KERNEL, name, defines), la.FORWARD_KERNEL)
            ok = within(la.launch_forward(lib, *x_args, 1e-5), want, K1_TOL[torch.bfloat16])
            ms = device_ms(lambda: la.launch_forward(lib, *x_args, 1e-5),
                           "attention_block_kernel", reps=20)
            plan = la.forward_plan(lib, N, C, torch.bfloat16)
            result["k1"][f"{name} {(BATCH, N, C)}"] = dict(ms=ms, within_tol=ok, plan=plan)
            print(f"K1 {name} {(BATCH, N, C)}: {ms:.4f} ms, within K1_TOL {ok}, plan {plan}",
                  flush=True)
            if name != "stamped":
                continue
            stamps = np.zeros(1 << 16, dtype=np.uint64)
            lib.calo_read_stamps.argtypes = [ctypes.c_void_p]
            if lib.calo_read_stamps(stamps.ctypes.data) != 0:
                raise SystemExit("reading the phase stamps failed")
            n_cta = BATCH * plan["G"]
            t = stamps.reshape(-1, 8)[:n_cta, :7].astype(np.float64) / 1e3  # us
            t -= t[:, 0].min()
            phases = np.median(np.diff(t, axis=1), axis=0)
            running = [int(((t[:, 0] <= s) & (t[:, 6] > s)).sum()) for s in t[:, 0]]
            result["k1_phases"][f"{(BATCH, N, C)}"] = dict(
                launch_us=float(t[:, 6].max()), cta_us=float(np.median(t[:, 6] - t[:, 0])),
                phases_us=dict(zip(PHASES, phases.tolist())),
                ctas_running_median=float(np.median(running)), ctas=n_cta)
            print(f"  phases of the median CTA (us): "
                  + ", ".join(f"{p} {v:.2f}" for p, v in zip(PHASES, phases))
                  + f"; CTA {np.median(t[:, 6] - t[:, 0]):.1f} us, launch {t[:, 6].max():.1f} us, "
                  f"{np.median(running):.0f} of {n_cta} CTAs running at a CTA's start", flush=True)
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
