#!/usr/bin/env python3
"""Deep-level conv formulation A/B on one CUDA card: cuDNN's convolution
against an explicit im2col product.

    python3 scripts/torch_im2col_microbench.py [--iters 200] [--out FILE]
        [--device cpu]

The port's counterpart of ``scripts/im2col_microbench.py``: at the eight
geometries of the JAX script (ds2 levels 0-2, ds3 levels 1-2, HGCal level
1), a 3x3x3 stride-1 cylindrical convolution as the port runs it
(``ops/conv.cylindrical_conv3d``, cuDNN) against ``im2col_cyl_conv3d``:
the 27 shifted slices of the phi-wrapped (``ops/conv.wrap_pad_phi``),
Z/R-zero-padded input stacked into (B, 27 Cin, Z A R) and one batched
``torch.matmul`` with the (Cout, 27 Cin) weight.  The JAX package computes
that product outside any Pallas kernel, so a plain product it is here too.
Where Cout differs from Cin a 1x1x1 conv projects back, so that the
iterations chain.

``rel_err`` is max|cuDNN - im2col| / max|cuDNN| in f32 with TF32 off for
both cuDNN and the matmul; a case above 1e-5 fails the script.  Timing as
``torch_level_profile.time_chain`` (bf16, ``--iters`` (K) serial
iterations): ``graph_ms`` (captured once in a CUDA graph, best of 3
replays over K) and ``eager_ms`` (launched from Python, CUDA events) for
each formulation; the JAX script's printed fields (``native_ms``,
``im2col_ms``, their TFLOP/s and the speedup) from the graph times.  The
report ``--out`` (JSON) holds every case.  The script runs on the card
unless ``--device cpu`` is given (no graph there: the fields come from the
eager times).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_level_profile as lp  # noqa: E402
from calodiffusion_tpu_torch.ops.conv import cylindrical_conv3d, wrap_pad_phi  # noqa: E402

DTYPE = torch.bfloat16
ITERS = 200
REL_ERR_MAX = 1e-5
B = 128
# (name, batch, (Z, A, R), Cin, Cout): the JAX script's cases
CASES = (
    ("ds2 L1 23x8x5   32->32", B, (23, 8, 5), 32, 32),
    ("ds2 L2 12x4x3   64->64", B, (12, 4, 3), 64, 64),
    ("ds2 L2 12x4x3   64->32", B, (12, 4, 3), 64, 32),
    ("ds2 L0 45x16x9  32->32", B, (45, 16, 9), 32, 32),
    ("ds2 L0 45x16x9  32->64", B, (45, 16, 9), 32, 64),
    ("ds3 L1 23x25x9  32->32", B, (23, 25, 9), 32, 32),
    ("ds3 L2 12x13x5  64->64", B, (12, 13, 5), 64, 64),
    ("hgc L1 14x6x6   32->32", 64, (14, 6, 6), 32, 32),
)


def im2col_cyl_conv3d(x, w, b=None):
    """3x3x3 stride-1 pad-1 cylindrical conv as shifted-slice im2col + one
    matmul.  x: NCDHW (B, Cin, Z, A, R); w: (Cout, Cin, 3, 3, 3)."""
    Bn, C, Z, A, R = x.shape
    cout, cin, kz, ka, kr = w.shape
    assert (kz, ka, kr) == (3, 3, 3) and cin == C
    xp = F.pad(wrap_pad_phi(x, 1), (1, 1, 0, 0, 1, 1))  # R and Z zero-padded by 1
    cols = [xp[:, :, dz:dz + Z, da:da + A, dr:dr + R]
            for dz in range(3) for da in range(3) for dr in range(3)]
    patches = torch.stack(cols, dim=1).reshape(Bn, 27 * C, Z * A * R)  # (B, 27 Cin, ZAR)
    wf = w.permute(0, 2, 3, 4, 1).reshape(cout, 27 * C)  # (Cout, 27 Cin), tap-major
    y = torch.matmul(wf, patches).reshape(Bn, cout, Z, A, R)
    if b is not None:
        y = y + b[:, None, None, None]
    return y


def rel_err(x, w) -> float:
    """max|cuDNN - im2col| / max|cuDNN| in f32, TF32 off for both."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = cylindrical_conv3d(x.float(), w.float(), padding=1)
        got = im2col_cyl_conv3d(x.float(), w.float())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    return float((ref - got).abs().max() / (ref.abs().max() + 1e-9))


def case(name, batch, spatial, cin, cout, iters=ITERS, device="cuda") -> dict:
    g = torch.Generator().manual_seed(0)
    x = torch.randn((batch, cin, *spatial), generator=g).to(device, DTYPE)
    w = (torch.randn((cout, cin, 3, 3, 3), generator=g) * 0.05).to(device, DTYPE)
    # Cout != Cin: project back so the iterations chain
    proj = ((torch.randn((cin, cout, 1, 1, 1), generator=g) * 0.05).to(device, DTYPE)
            if cout != cin else None)
    err = rel_err(x, w)

    def timed(conv):
        """K iterations of conv (+ the projection) from x, fed back."""
        with torch.inference_mode():
            state = x.clone()

            def body():
                y = conv(state, w)
                if proj is not None:
                    y = cylindrical_conv3d(y, proj, padding=0)
                state.copy_(y)

            return lp.time_chain(body, [state], iters, device)

    native = timed(lambda t, k: cylindrical_conv3d(t, k, padding=1))
    col = timed(im2col_cyl_conv3d)
    flops = 2 * batch * spatial[0] * spatial[1] * spatial[2] * 27 * cin * cout
    src = "graph_ms" if native["graph_ms"] is not None else "eager_ms"
    t_nat, t_col = native[src], col[src]
    res = dict(name=name, batch=batch, spatial=list(spatial), cin=cin, cout=cout, rel_err=err,
               native_ms=t_nat, native_tflops=flops / t_nat / 1e9, im2col_ms=t_col,
               im2col_tflops=flops / t_col / 1e9, speedup=t_nat / t_col,
               native=native, im2col=col)
    print(f"{name:26s} rel_err={err:.2e}  native={t_nat:7.3f} ms "
          f"({res['native_tflops']:5.1f} TF)  im2col={t_col:7.3f} ms "
          f"({res['im2col_tflops']:5.1f} TF)  speedup={res['speedup']:5.2f}x  "
          f"(eager {native['eager_ms']:.3f} / {col['eager_ms']:.3f} ms)", flush=True)
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=ITERS, help="serial iterations a timing (K)")
    ap.add_argument("--out", default=None, help="JSON report")
    ap.add_argument("--device", default="cuda", help="torch device (cpu for the CPU)")
    return ap


def main(argv=None) -> dict:
    opts = parser().parse_args(argv)
    lp.check_device(opts.device)
    card = lp.card_line(opts.device)
    print(card, flush=True)
    rows = [case(*c, iters=opts.iters, device=opts.device) for c in CASES]
    report = dict(iters=opts.iters, dtype="bfloat16", card=card, cases=rows)
    lp.write_report(report, opts.out)
    bad = [r["name"] for r in rows if not r["rel_err"] <= REL_ERR_MAX]
    if bad:
        raise SystemExit(f"im2col differs from cuDNN by more than {REL_ERR_MAX}: {bad}")
    return report


if __name__ == "__main__":
    main()
