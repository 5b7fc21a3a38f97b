#!/usr/bin/env python3
"""How well conditioned LinearAttention's gradients are on the ds3 grid, on the CPU.

    python3 scripts/torch_linear_attention_conditioning.py [--batch 2] [--seed 0]
        [--qkv-gain 1 4]

Builds calodiffusion_tpu_torch's ``LinearAttention(32)`` at its default
seeded init, with its ``to_qkv`` weight multiplied by each ``--qkv-gain``
(1: the init as it is), on x of shape (batch, 32, 45, 50, 18), dataset 3's
full grid, and prints, for the loss mean(out^2):

- the spread of the attention's output over positions against its size:
  the post-GroupNorm divides by that spread, so a small one leaves the
  gradients ill-conditioned;
- the plain module's gradients (x, then each parameter) in bf16 and f32
  against the same module in float64 (its GroupNorm statistics stay f32),
  in max-norm relative error;
- where g++ is present: K3's forward in f32 and bf16, compiled with g++
  under the CUDA emulation of ``tests/test_torch_port_cuda_emulation.py``,
  against float64; the module's output with K3 as its forward against the
  plain module's; and its gradients against the plain f32 module's and
  against float64.

These are the numbers behind chip_smoke.py's K3_GRAD_TOL_F32, and behind
its choice to hold LinearAttention's bf16 gradients to no limit.  Run from
the repository root; CPU only.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from calodiffusion_tpu_torch.models import nn_modules  # noqa: E402
from calodiffusion_tpu_torch.ops import linear_attention as la  # noqa: E402

GRID = (45, 50, 18)


def rel(a, b) -> list[float]:
    """Max-norm relative error of each tensor of a against b."""
    return [float(f"{((p.double() - q.double()).abs().max() / q.double().abs().max()).item():.3g}")
            for p, q in zip(a, b)]


def module(dtype, seed, gain):
    m = nn_modules.LinearAttention(32, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        m.to_qkv.weight.mul_(gain)
    return m


def grads(dtype, x, seed, gain, entry=la.linear_attention_reference):
    """x's and the parameters' gradients of mean(out^2), with ``entry`` as
    the heads-1 LinearAttention; the module and its output."""
    orig = nn_modules.fused_linear_attention
    nn_modules.fused_linear_attention = entry
    try:
        m = module(dtype, seed, gain)
        xx = x.to(torch.float64 if dtype == torch.float64 else torch.float32)
        xx = xx.clone().requires_grad_(True)
        out = m(xx)
        (out.double() ** 2).mean().backward()
        return [xx.grad] + [p.grad for p in m.parameters()], m, out.detach()
    finally:
        nn_modules.fused_linear_attention = orig


def emulated_k3() -> dict:
    """K3's f32 and bf16 libraries built with g++ under the tests' CUDA emulation."""
    from tests import test_torch_port_cuda_emulation as emu

    out = Path(tempfile.mkdtemp(prefix="k3_emulation_"))
    for name in ("cuda_emu.h", "cuda_bf16.h", "cuda_runtime.h"):
        (out / name).write_text(emu.EMULATION_HEADER if name == "cuda_emu.h"
                                else '#include "cuda_emu.h"\n')
    return {dt: emu._build(out, la.LINEAR_KERNEL, la.variant(dt, 32))[1]
            for dt in (torch.float32, torch.bfloat16)}


def report(x, seed, gain, libs) -> None:
    g64, m, _ = grads(torch.float64, x, seed, gain)
    g32, _, _ = grads(torch.float32, x, seed, gain)
    g16, _, _ = grads(torch.bfloat16, x, seed, gain)
    xf = nn_modules._to_bnc(x)
    w_qkv, w_out, b_out = (t.double() for t in m._matrices(32))
    y64 = la.linear_attention_reference(xf.double(), w_qkv, w_out, b_out)
    attn = y64 - b_out  # the attention's part of y, before the output bias
    spread = (attn - attn.mean(1, keepdim=True)).abs().max().item()
    sigma = y64.std(dim=(1, 2)).min().item()  # the post-GroupNorm's divisor, least sample
    print(f"qkv gain {gain}: attention output |y - b_out| <= {attn.abs().max().item():.4g}, "
          f"spread over positions {spread:.4g}; |b_out| <= {b_out.abs().max().item():.4g}; "
          f"std of y a sample >= {sigma:.4g}")
    print(f"  plain bf16 vs float64: {rel(g16, g64)}")
    print(f"  plain f32  vs float64: {rel(g32, g64)}")
    if libs is None:
        return
    for dt in (torch.float32, torch.bfloat16):
        w = [t.to(dt) for t in m._matrices(32)[:2]]
        yk = la.launch_linear(libs[dt], xf.to(dt), *w, b_out.float())
        yp = la.linear_attention_reference(xf.to(dt), *w, b_out.float())
        k_err, p_err = ((t.double() - y64).abs().max().item() for t in (yk, yp))
        print(f"  forward {str(dt)[6:]}: K3 vs float64 {k_err:.3g}, plain vs float64 {p_err:.3g}")
    la_kernel = la._kernel_library
    la._kernel_library = lambda name, t: libs[t.dtype]
    try:
        for dt in (torch.float32, torch.bfloat16):
            gk, _, outk = grads(dt, x, seed, gain,
                                entry=lambda *a: la._FusedLinearAttention.apply(*a))
            _, _, outp = grads(dt, x, seed, gain)
            d = (outk.float() - outp.float()).abs()
            near = d.max().item(), outp.float().abs().flatten()[d.argmax()].item()
            print(f"  module output {str(dt)[6:]}, K3 forward vs plain: max |diff| {near[0]:.3g} "
                  f"(where |plain| = {near[1]:.3g}); |plain| <= {outp.abs().max().item():.3g}")
            print(f"  gradients {str(dt)[6:]}, K3 forward: vs plain f32 {rel(gk, g32)}; "
                  f"vs float64 {rel(gk, g64)}")
    finally:
        la._kernel_library = la_kernel


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--qkv-gain", type=float, nargs="+", default=[1.0])
    args = ap.parse_args()

    torch.set_num_threads(2)
    x = torch.randn(args.batch, 32, *GRID, generator=torch.Generator().manual_seed(args.seed))
    print(f"x {tuple(x.shape)}; gradients in order "
          f"{['x'] + [n for n, _ in module(torch.float32, 0, 1.0).named_parameters()]}")
    libs = emulated_k3() if shutil.which("g++") else None
    if libs is None:
        print("no g++: the emulated K3 is skipped")
    for gain in args.qkv_gain:
        report(x, args.seed + 1, gain, libs)


if __name__ == "__main__":
    main()
