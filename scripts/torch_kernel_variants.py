#!/usr/bin/env python3
"""Design variants of the K4, K1, K2 kernels and K4's backward, timed on one CUDA card.

    python3 scripts/torch_kernel_variants.py [--out FILE] [--kernels k4b] [--baseline DIR]

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
- K2 (the attention block's backward) at the ds2 shapes, batch 128: as
  built (8 warps a CTA), with 16 warps, and as built at a forced cluster
  size of 4, 8 and 16; then stamped as K1, at (6480, 32).
- K4's backward (dq, dk, dv of softmax attention) at chip_smoke.py's K4
  shapes (B, H, N) = (1, 8, 4096), (2, 4, 736), (1, 4, 40,500), (4, 4,
  40,500): as built (the plan picked by grid size) and, by substitution,
  each plan forced (``Plan<C, BT>``: 2 or 3 consumer warpgroups of 64 rows
  a CTA, streamed tiles of 64 or 128 rows), 3 stages in the TMA ring, and
  FlashAttention-3's ping-pong (two consumer warpgroups taking turns to
  issue a tile's S and dP, on hardware barriers), each checked within
  K4B_TOL of the plain gradient, its device time and CUDA-event time, the
  HGMMA (wgmma) instructions in its library and its register lines; the
  f32 build, in two rounds of opposite order, each pass's time apart; two
  ablations that drop the exponentials (wrong by design, timed only); and
  SDPA's backward (CUDA events around ``torch.autograd.grad``).
- With ``--baseline DIR`` (another checkout of the repository, such as the
  parent commit, whose K2 and K3 take the C signatures they had before
  their cluster designs): that checkout's K2 at the ds2 shapes and K3 at
  the ds2 shapes and dataset 3's (64, 40,500, 32), bf16, and its K4
  backward at the K4 shapes in bf16 and f32 (the same C entry), beside this
  checkout's, each by its device time in one trace.

``--kernels k4b`` (any of k4, k1, k2, k4b, comma-separated; all by
default) runs only those sections, the baseline's too.
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
from calodiffusion_tpu_torch.ops.tolerances import K1_TOL, K2_TOL, K4_TOL, K4B_TOL  # noqa: E402

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

# thread 0 of each CTA stamps the end of each phase (up to 16 stamps a CTA)
STAMPS = 16
_STAMP = ("#define STAMP(i) if (threadIdx.x == 0) { unsigned long long t_; "
          "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
          f"g_stamps[blockIdx.x * {STAMPS} + (i)] = t_; }}\n")
_STAMP_DEFS = [('#include "attention_common.cuh"\n',
                '#include "attention_common.cuh"\n__device__ unsigned long long g_stamps[1 << 16];\n'
                + _STAMP + "extern \"C\" int calo_read_stamps(void* dst) {\n"
                "  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps));\n}\n"),
               ("  const float denom = static_cast<float>(C) * static_cast<float>(N);\n",
                "  const float denom = static_cast<float>(C) * static_cast<float>(N);\n"
                "  STAMP(0)\n")]


def _stamped(anchors):
    """STAMP(i) inserted before the i-th anchor (i = 1, 2, ...)."""
    return _STAMP_DEFS + [(a, f"  STAMP({i})\n{a}") for i, a in enumerate(anchors, 1)]


TRACE = _stamped(["  // the projections' input of a tile's positions",
                  "  // the warps' partials, then the CTAs', merged into s_ctx",
                  "  // ---- phase B: y = W_o",
                  "  const float mu_y = cluster_sum<",
                  "  // ---- phase C: out = x + GN1_post(y)",
                  "  cluster.sync();  // no CTA leaves"])
PHASES = ["x load + pre-GN statistics", "phase A (k, v, ctx partials)", "ctx merge",
          "phase B (q, ctx^T q, W_o)", "post-GN statistics", "phase C (out)"]
K2_TRACE = _stamped(["  auto make_xn = [&](int tile) { stage_input<true>",
                     "  // q of a staged xn tile",
                     "  // ---- phase G: post-GN backward sums",
                     "  const float s1n = s_scal[4]",
                     "  // the k softmax (final max and sum) of a staged xn tile",
                     "  // ---- phase K:",
                     "  // ---- phase F:",
                     "}\n\nint plan_for("])
K2_PHASES = ["x, g load + pre-GN statistics", "phase A (ctx) + merge",
             "phase B (y) + statistics", "phase G (S1, S2)", "phase M (dq, dctx) + merge",
             "phase R (r_d) + merge", "phase K (dk, dv, dxn) + merge", "phase F (dx)"]
# K4's backward: chip_smoke.py's K4 shapes, and the bf16 design's variants
K4B_SHAPES = [(1, 8, 4096), (2, 4, 736), (1, 4, 40500), (4, 4, 40500)]
# and ablations, wrong by design and timed only: the exponentials replaced
# by their FFMA's result (what the special-function units cost)
NO_EXP = [("sc[i] = col < nk ? exp2_approx(fmaf(sc[i], c, -lse2[(i >> 1) & 1])) : 0.f;",
           "sc[i] = col < nk ? fmaf(sc[i], c, -lse2[(i >> 1) & 1]) : 0.f;"),
          ("sc[i] = exp2_approx(fmaf(sc[i], c, -lt[col]));", "sc[i] = fmaf(sc[i], c, -lt[col]);")]


def plan(consumers: int, rows: int):
    """Every shape on Plan<consumers, rows> (the launch's choice by grid size dropped)."""
    return [("using SmallGrid = Plan<2, 128>;", f"using SmallGrid = Plan<{consumers}, {rows}>;"),
            ("if (large_ctas >= 4LL * sms)", "if (false && large_ctas >= 4LL * sms)")]


S3 = [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")]
# FlashAttention-3's ping-pong: two consumer warpgroups take turns to issue
# a tile's S and dP products (hardware barriers 1 and 2), so that one's
# exponentials run beside the other's products
_TURNS = """// two consumer warpgroups take turns to issue a tile's S and dP
template <class P> __device__ __forceinline__ void turn_begin(int wg, int j) {
  if (P::CONSUMERS == 2) {
    if (j == 0 && wg == 1) asm volatile("bar.arrive 1, 256;\\n" ::: "memory");  // warpgroup 0 first
    asm volatile("bar.sync %0, 256;\\n" ::"r"(1 + wg) : "memory");
  }
}
template <class P> __device__ __forceinline__ void turn_end(int wg, int j, int n_tiles) {
  if (P::CONSUMERS == 2 && !(wg == 1 && j == n_tiles - 1))
    asm volatile("bar.arrive %0, 256;\\n" ::"r"(2 - wg) : "memory");
}

"""
PINGPONG = [("// descriptors of a streamed tile", _TURNS + "// descriptors of a streamed tile"),
            ("    float sc[BT / 2], dp[BT / 2];\n    wgmma_fence();\n",
             "    float sc[BT / 2], dp[BT / 2];\n    turn_begin<P>(wg, j);\n    wgmma_fence();\n"),
            ("    wgmma_commit();\n    wgmma_wait<1>();\n    fence_operands(sc);\n",
             "    wgmma_commit();\n    turn_end<P>(wg, j, n_tiles);\n    wgmma_wait<1>();\n"
             "    fence_operands(sc);\n")]
K4B_VARIANTS = {  # name: text substitutions
    "as_built": [],  # the plan by grid size: c2_bt128 or c3_bt64
    "c2_bt64": plan(2, 64),
    "c2_bt128": plan(2, 128),
    "c3_bt64": plan(3, 64),
    "c2_bt128_s3": plan(2, 128) + S3,
    "c3_bt64_s3": plan(3, 64) + S3,
    "c2_bt64_pingpong": plan(2, 64) + PINGPONG,
    "c2_bt128_pingpong": plan(2, 128) + PINGPONG,
    "c2_bt128_no_exp": plan(2, 128) + NO_EXP,
    "c3_bt64_no_exp": plan(3, 64) + NO_EXP,
}
K1_VARIANTS = {
    "as_built": [],
    "warps_8": [("constexpr int THREADS = CALO_BF16 && C == 32 ? 512 : 256;",
                 "constexpr int THREADS = 256;")],
    "stamped": TRACE,
}
K2_VARIANTS = {
    "as_built": [],
    "warps_16": [("constexpr int THREADS = 256;", "constexpr int THREADS = 512;")],
    "stamped": K2_TRACE,
}
K2_STAMPED_SHAPE = (32, 6480)


def write_variant(kernel: str, name: str, subs) -> Path:
    src = (cuda_build.CSRC_DIR / f"{kernel}.cu").read_text()
    for old, new in subs:  # each occurrence
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


def events_ms(fn, reps: int) -> float:
    """Mean time of one call, CUDA events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by(fn, keys, reps: int) -> dict:
    """Device time of one call, by kernel: those whose names hold each of
    ``keys``, in a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {key: sum(getattr(ev, "self_device_time_total", 0.0) for ev in events
                     if key in ev.key) / 1e3 / reps for key in keys}


def device_ms(fn, key: str, reps: int) -> float:
    """Device time of one call: kernels named ``key`` in a profiler trace."""
    return device_ms_by(fn, [key], reps)[key]


def read_phases(lib, n_cta: int, names) -> dict:
    """The stamped kernel's last launch: the median CTA's phase times, the
    launch's span and how many CTAs ran at once."""
    stamps = np.zeros(1 << 16, dtype=np.uint64)
    lib.calo_read_stamps.argtypes = [ctypes.c_void_p]
    if lib.calo_read_stamps(stamps.ctypes.data) != 0:
        raise SystemExit("reading the phase stamps failed")
    k = len(names)
    t = stamps.reshape(-1, STAMPS)[:n_cta, :k + 1].astype(np.float64) / 1e3  # us
    t -= t[:, 0].min()
    phases = np.median(np.diff(t, axis=1), axis=0)
    running = [int(((t[:, 0] <= s) & (t[:, k] > s)).sum()) for s in t[:, 0]]
    out = dict(launch_us=float(t[:, k].max()), cta_us=float(np.median(t[:, k] - t[:, 0])),
               phases_us=dict(zip(names, phases.tolist())),
               ctas_running_median=float(np.median(running)), ctas=n_cta)
    print("  phases of the median CTA (us): "
          + ", ".join(f"{p} {v:.2f}" for p, v in zip(names, phases))
          + f"; CTA {out['cta_us']:.1f} us, launch {out['launch_us']:.1f} us, "
          f"{out['ctas_running_median']:.0f} of {n_cta} CTAs running at a CTA's start", flush=True)
    return out


def rel_err(a, w) -> float:
    """max-norm relative error, in float64."""
    a, w = a.double(), w.double()
    return ((a - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()


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


# the C entries of K2 and K3 before their cluster designs: K2 took five f32
# scratch slabs (y, dxn (B, N, C); k, v, q (B, N, D)), K3 no plan arguments
_PTR, _PTRS, _INT = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_int
BASELINE_ENTRIES = {
    la.BACKWARD_KERNEL: ("calo_attention_block_backward",
                         [_PTR] * 8 + [_PTRS, _PTR, _PTRS] + [_INT] * 4 + [ctypes.c_float, _PTR]),
    la.LINEAR_KERNEL: ("calo_linear_attention_forward", [_PTR] * 5 + [_INT] * 4 + [_PTR]),
}
K3_SHAPES = [(BATCH, N, C) for C, N in K1_SHAPES] + [(64, 40500, 32)]


def baseline_backward(lib, x, gps, gpb, w_qkv, w_out, b_out, gos, g):
    B, N, C = x.shape
    f32, dev = torch.float32, x.device
    scratch = [torch.empty(shape, dtype=f32, device=dev)
               for shape in ((B, N, C), (B, N, C), (B, N, 32), (B, N, 32), (B, N, 32))]
    grads = [torch.empty(shape, dtype=f32, device=dev) for shape in
             [(B, C)] * 2 + [(B, C, 32)] * 3 + [(B, 32, C)] + [(B, C)] * 3]
    dx = torch.empty_like(x)
    rc = lib.calo_attention_block_backward(
        *(t.data_ptr() for t in (x, g, gps, gpb, w_qkv, w_out, b_out, gos)),
        (ctypes.c_void_p * 5)(*(t.data_ptr() for t in scratch)), dx.data_ptr(),
        (ctypes.c_void_p * 9)(*(t.data_ptr() for t in grads)), B, N, C, 1, 1e-5,
        cuda_build.stream_of(dev))
    cuda_build.raise_on(rc, "baseline K2", x)


def baseline_linear(lib, x, w_qkv, w_out, b_out):
    B, N, C = x.shape
    out = torch.empty_like(x)
    rc = lib.calo_linear_attention_forward(x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
                                           b_out.data_ptr(), out.data_ptr(), B, N, C, 1,
                                           cuda_build.stream_of(x.device))
    cuda_build.raise_on(rc, "baseline K3", x)


def k4b_inputs(B, H, N, dtype):
    """q, k, v, dO of K4's backward (chip_smoke.py's seeds) and its forward's out and lse."""
    g = torch.Generator().manual_seed(B + H + N + 1)
    q, k, v, dout = (torch.randn(B, H, N, 32, generator=g).cuda().to(dtype) for _ in range(4))
    out, lse = att.blockwise_attention_forward(q, k, v, with_lse=True)
    return q, k, v, out, lse, dout


def k4b_reps(N) -> int:
    return 5 if N > 8192 else 20


_K4B_CASES = {}  # (dtype, shape) -> (inputs, plain gradient), made once


def k4b_case(dtype, shape):
    if (dtype, shape) not in _K4B_CASES:
        B, H, N = shape
        args = k4b_inputs(B, H, N, dtype)
        want = att.attention_backward_reference(*args[:3], args[5],
                                                max(1, (1 << 29) // (B * H * N)))
        _K4B_CASES[(dtype, shape)] = args, want
    return _K4B_CASES[(dtype, shape)]


def time_k4b(libs: dict, label: str) -> dict:
    """Each library's K4 backward ({(name, dtype): lib}) at K4B_SHAPES:
    within K4B_TOL of the plain gradient, its device time (both passes)
    from a trace, and its time by CUDA events (launch costs included)."""
    out = {}
    for (name, dtype), lib in libs.items():
        for shape in K4B_SHAPES:
            args, want = k4b_case(dtype, shape)
            got = att.launch_backward(lib, *args)
            err = max(rel_err(a, w) for a, w in zip(got, want))
            by = device_ms_by(lambda: att.launch_backward(lib, *args),
                              ["attention_dq_kernel", "attention_dkdv_kernel"],
                              reps=k4b_reps(shape[2]))
            dq_ms, dkdv_ms = by.values()
            ev = events_ms(lambda: att.launch_backward(lib, *args), reps=k4b_reps(shape[2]))
            tag = f"{label}{name} {str(dtype)[6:]} {shape}"
            out[tag] = dict(ms=dq_ms + dkdv_ms, dq_ms=dq_ms, dkdv_ms=dkdv_ms, events_ms=ev,
                            max_norm_rel_err=err, within_tol=err <= K4B_TOL[dtype])
            print(f"K4 backward {tag}: {dq_ms + dkdv_ms:.4f} ms device (dq pass {dq_ms:.4f}, "
                  f"dk/dv pass {dkdv_ms:.4f}), {ev:.4f} ms events, max-norm rel err {err:.3g} "
                  f"(K4B_TOL {K4B_TOL[dtype]})", flush=True)
    return out


def k4b_libs(built, names) -> dict:
    """{(name, dtype): bound library} of this checkout's K4 backward builds."""
    return {(name, torch.float32 if name == "f32" else torch.bfloat16):
            att.BACKWARD_KERNEL.bind(built[(att.BACKWARD_KERNEL.name, name)][0]) for name in names}


def k4b_section(built) -> dict:
    """K4's backward: the design's variants (bf16) and the f32 build, with
    SDPA's backward timed beside them."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    names = [*K4B_VARIANTS, "f32"]
    result = {"variants": {}, "sdpa_backward": {}}
    for rnd, order in enumerate((names, names[::-1])):  # two rounds, in opposite orders
        result["variants"].update(time_k4b(k4b_libs(built, order), f"round {rnd} "))
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, N in K4B_SHAPES:
            (q, k, v, _, _, dout), _ = k4b_case(dtype, (B, H, N))
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = sdpa(ql, kl, vl)
            ms = events_ms(lambda: torch.autograd.grad(o, (ql, kl, vl), dout, retain_graph=True),
                           reps=k4b_reps(N))
            result["sdpa_backward"][f"{str(dtype)[6:]} {(B, H, N)}"] = ms
            print(f"SDPA backward {str(dtype)[6:]} {(B, H, N)}: {ms:.4f} ms (events)", flush=True)
    return result


def compare_baseline(root: Path, sections, built) -> dict:
    """Device ms of the baseline checkout's K2 and K3 (bf16) and K4 backward
    (bf16, f32) beside this one's."""
    csrc = root / "calodiffusion_tpu_torch" / "csrc"
    jobs = {}
    if "k2" in sections:
        jobs.update({(name, C): (csrc / f"{name}.cu", la.variant(torch.bfloat16, C))
                     for name in BASELINE_ENTRIES for C in (32, 64)})
    if "k4b" in sections:
        jobs.update({(att.BACKWARD_KERNEL.name, dt): (csrc / f"{att.BACKWARD_KERNEL.name}.cu",
                                                      cuda_build.dtype_variant(dt))
                     for dt in (torch.bfloat16, torch.float32)})

    def build_baseline(item):
        (name, C), (src, defines) = item
        so = OUT_DIR / f"baseline-{name}-{str(C).replace('torch.', '')}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, f"-I{csrc}",
               *(f"-D{d}" for d in defines), "-o", str(so), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the baseline's {src.name}:\n{proc.stderr[-4000:]}")
        lib = ctypes.CDLL(str(so))
        if name == att.BACKWARD_KERNEL.name:  # the same C entry as this checkout's
            return (name, C), att.BACKWARD_KERNEL.bind(lib)
        entry, argtypes = BASELINE_ENTRIES[name]
        return (name, C), cuda_build.bind(lib, entry, argtypes)

    with ThreadPoolExecutor(len(jobs)) as pool:
        base = dict(pool.map(build_baseline, jobs.items()))
    out = {}
    if "k4b" in sections:
        name = att.BACKWARD_KERNEL.name
        mine = {(f"this {n}", dt): lib for (n, dt), lib in k4b_libs(built, ["as_built", "f32"]).items()}
        theirs = {("baseline", dt): base[(name, dt)] for dt in (torch.bfloat16, torch.float32)}
        # in turns: baseline, this, this, baseline
        for turn, libs in enumerate((theirs, mine, mine, theirs)):
            out.update(time_k4b(libs, f"turn {turn} "))
    if "k2" not in sections:
        return out
    for C, N in K1_SHAPES:
        x_args = block_inputs(N, C, seed=C + N + 1)
        g = torch.randn(BATCH, N, C, generator=torch.Generator().manual_seed(N - C))
        g = g.cuda().bfloat16()
        lib = la._kernel_library(la.BACKWARD_KERNEL, x_args[0])
        new = device_ms(lambda: la.launch_backward(lib, *x_args[:7], g, 1e-5),
                        "attention_block_bwd_kernel", reps=10)
        old = device_ms(lambda: baseline_backward(base[(la.BACKWARD_KERNEL, C)], *x_args[:7], g),
                        "attention_block_bwd_kernel", reps=10)
        out[f"K2 {(BATCH, N, C)}"] = dict(ms=new, baseline_ms=old)
        print(f"K2 {(BATCH, N, C)}: {new:.4f} ms device, baseline {old:.4f} ms", flush=True)
    for B, N, C in K3_SHAPES:
        g = torch.Generator().manual_seed(B + N + C)
        x, w_qkv, w_out = (torch.randn(B, N, C, generator=g), 0.2 * torch.randn(C, 96, generator=g),
                           0.2 * torch.randn(32, C, generator=g))
        x, w_qkv, w_out = (t.cuda().bfloat16().contiguous() for t in (x, w_qkv, w_out))
        b_out = (0.1 * torch.randn(C, generator=g)).cuda()
        lib = la._kernel_library(la.LINEAR_KERNEL, x)
        # this checkout's K3 is K1's kernel built without the GroupNorms
        new = device_ms(lambda: la.launch_linear(lib, x, w_qkv, w_out, b_out),
                        "attention_block_kernel", reps=10)
        old = device_ms(lambda: baseline_linear(base[(la.LINEAR_KERNEL, C)], x, w_qkv, w_out,
                                                b_out), "linear_attention_kernel", reps=10)
        out[f"K3 {(B, N, C)}"] = dict(ms=new, baseline_ms=old)
        print(f"K3 {(B, N, C)}: {new:.4f} ms device, baseline {old:.4f} ms", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, help="JSON file for the results")
    ap.add_argument("--baseline", type=Path,
                    help="another checkout whose K2, K3 and K4 backward to time")
    ap.add_argument("--kernels", default="k4,k1,k2,k4b",
                    help="the sections to run, comma-separated (k4, k1, k2, k4b)")
    args = ap.parse_args()
    sections = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    if "k4" in sections:
        jobs += [(write_variant(att.KERNEL.name, n, subs), ("CALO_BF16=1",))
                 for n, subs in K4_VARIANTS.items()]
    if "k1" in sections:
        jobs += [(write_variant(la.FORWARD_KERNEL, n, subs), la.variant(torch.bfloat16, C))
                 for n, subs in K1_VARIANTS.items() for C in (32, 64)]
    if "k2" in sections:
        jobs += [(write_variant(la.BACKWARD_KERNEL, n, subs), la.variant(torch.bfloat16, C))
                 for n, subs in K2_VARIANTS.items() for C in (32, 64)]
    k4b_jobs = {}
    if "k4b" in sections:
        k4b = att.BACKWARD_KERNEL.name
        k4b_jobs = {(k4b, n): (write_variant(k4b, n, subs), ("CALO_BF16=1",))
                    for n, subs in K4B_VARIANTS.items()}
        k4b_jobs[(k4b, "f32")] = (write_variant(k4b, "f32", []), ("CALO_BF16=0",))
        jobs += list(k4b_jobs.values())
    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        built = {job: (lib, regs) for job, lib, regs in pool.map(build, jobs)}
    built.update({key: built[job] for key, job in k4b_jobs.items()})
    result = {"card": card, "k4": {}, "k1": {}, "k1_phases": {}, "k2": {}, "k2_phases": {}}
    for job in jobs:
        src, defines = job
        print(f"build {src.stem} {' '.join(defines)}: {'; '.join(built[job][1])}", flush=True)
    for key, (src, defines) in k4b_jobs.items():
        so = src.with_name(f"{src.stem}-{'-'.join(d.replace('=', '') for d in defines)}.so")
        hgmma = cuda_build.sass_count(so, "HGMMA")
        result.setdefault("k4b_hgmma", {})[key[1]] = hgmma
        print(f"build {src.stem} {' '.join(defines)}: {hgmma} HGMMA instructions", flush=True)

    def lib_of(kernel, name, defines):
        return built[(OUT_DIR / f"{kernel}-{name}.cu", defines)][0]

    if "k4b" in sections:
        result["k4b"] = k4b_section(built)
    for B, H, N in K4_SHAPES if "k4" in sections else []:
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

    for C, N in K1_SHAPES if "k1" in sections else []:
        x_args = block_inputs(N, C, seed=C + N)
        want = la.attention_block_reference(*x_args)
        defines = la.variant(torch.bfloat16, C)
        for name in K1_VARIANTS:
            lib = la.bind(lib_of(la.FORWARD_KERNEL, name, defines), la.FORWARD_KERNEL)
            ok = within(la.launch_forward(lib, *x_args, 1e-5), want, K1_TOL[torch.bfloat16])
            ms = device_ms(lambda: la.launch_forward(lib, *x_args, 1e-5),
                           "attention_block_kernel", reps=20)
            plan = la.kernel_plan(lib, la.FORWARD_KERNEL, N, C, torch.bfloat16)
            result["k1"][f"{name} {(BATCH, N, C)}"] = dict(ms=ms, within_tol=ok, plan=plan)
            print(f"K1 {name} {(BATCH, N, C)}: {ms:.4f} ms, within K1_TOL {ok}, plan {plan}",
                  flush=True)
            if name == "stamped":
                result["k1_phases"][f"{(BATCH, N, C)}"] = read_phases(lib, BATCH * plan["G"],
                                                                      PHASES)

    for C, N in K1_SHAPES if "k2" in sections else []:
        x_args = block_inputs(N, C, seed=C + N + 1)
        g = torch.randn(BATCH, N, C, generator=torch.Generator().manual_seed(N - C))
        g = g.cuda().bfloat16()
        want = la.attention_block_backward_reference(*x_args, g)
        defines = la.variant(torch.bfloat16, C)
        runs = [(name, 0) for name in K2_VARIANTS] + [("as_built", G) for G in (4, 8, 16)]
        for name, cluster in runs:
            if name == "stamped" and (C, N) != K2_STAMPED_SHAPE:
                continue
            lib = la.bind(lib_of(la.BACKWARD_KERNEL, name, defines), la.BACKWARD_KERNEL)
            got = la.launch_backward(lib, *x_args[:7], g, 1e-5, cluster=cluster)
            ok = all(rel_err(a, w) <= K2_TOL[torch.bfloat16] for a, w in zip(got, want))
            ms = device_ms(lambda: la.launch_backward(lib, *x_args[:7], g, 1e-5, cluster=cluster),
                           "attention_block_bwd_kernel", reps=10)
            plan = la.kernel_plan(lib, la.BACKWARD_KERNEL, N, C, torch.bfloat16, cluster)
            key = f"{name}{f' G={cluster}' if cluster else ''} {(BATCH, N, C)}"
            result["k2"][key] = dict(ms=ms, within_tol=ok, plan=plan)
            print(f"K2 {key}: {ms:.4f} ms, within K2_TOL {ok}, plan {plan}", flush=True)
            if name == "stamped":
                result["k2_phases"][f"{(BATCH, N, C)}"] = read_phases(lib, BATCH * plan["G"],
                                                                      K2_PHASES)
    if args.baseline:
        result["baseline"] = compare_baseline(args.baseline, sections, built)
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
