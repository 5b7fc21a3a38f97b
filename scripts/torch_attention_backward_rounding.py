#!/usr/bin/env python3
"""How far the bf16 roundings of K4's backward move its gradients.

    python3 scripts/torch_attention_backward_rounding.py [--n 512 2048] [--gain 1 8]

Simulates, in float64 on the CPU, the arithmetic of
``calodiffusion_tpu_torch/csrc/blockwise_attention_bwd.cu``'s bf16 variant
with and without each of its choices, and prints the max-norm relative
error of dq, dk and dv against the plain gradient
(``attention_backward_reference``, autograd of ``dense_attention`` on the
bf16 inputs), and the plain gradient's own error against float64:

- split_p / split_ds: P (for dV = P^T dO) and dS (for dK and dQ) rounded to
  bf16 once as the products' operands (0), or split into bf16 hi + lo parts
  (1), as K4's forward splits P;
- exact_D: Drow = rowsum(dO o out) from the forward's bf16 output (0), or
  the exact rowsum(P o dP) (1).

q, k, v and dO are unit normals (q times --gain: 8 makes a peaked softmax),
(B*H, N, 32) with B*H = 2, from --seed.  Products of bf16 inputs are exact
in f32, as on the tensor cores.  A CPU study of accuracy: it times nothing.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from calodiffusion_tpu_torch.ops.attention import attention_backward_reference, dense_attention


def rounded(x):
    return x.to(torch.bfloat16).double()


def split(x):
    hi = rounded(x)
    return hi + rounded(x - hi)


def simulated(q, k, v, dout, out, split_p, split_ds, exact_d):
    """The kernel's bf16 arithmetic with the given choices, in float64."""
    q, k, v, do = (t.double() for t in (q, k, v, dout))
    c = q.shape[-1] ** -0.5
    s = q @ k.transpose(-1, -2)
    p = torch.exp(s * c - torch.logsumexp(s * c, -1, keepdim=True))
    dp = do @ v.transpose(-1, -2)
    drow = (p * dp if exact_d else do * out.double()).sum(-1, keepdim=True)
    ds = p * (dp - drow)
    p_op = split(p) if split_p else rounded(p)
    ds_op = split(ds) if split_ds else rounded(ds)
    grads = (c * ds_op @ k, c * ds_op.transpose(-1, -2) @ q, p_op.transpose(-1, -2) @ do)
    return [g.to(torch.bfloat16) for g in grads]


def max_norm_rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[512, 2048])
    ap.add_argument("--gain", type=float, nargs="+", default=[1.0, 8.0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    worst = {}
    for n, gain in itertools.product(args.n, args.gain):
        g = torch.Generator().manual_seed(args.seed + n)
        q, k, v, dout = (torch.randn(2, 1, n, 32, generator=g) for _ in range(4))
        q, k, v, dout = (t.to(torch.bfloat16) for t in (q * gain, k, v, dout))
        out = dense_attention(q, k, v)
        plain = attention_backward_reference(q, k, v, dout)
        q64, k64, v64 = (t.double().requires_grad_(True) for t in (q, k, v))
        o64 = torch.softmax(q64 @ k64.transpose(-1, -2) * 32 ** -0.5, -1) @ v64
        truth = torch.autograd.grad(o64, (q64, k64, v64), dout.double())
        errs = [max_norm_rel(a, b) for a, b in zip(plain, truth)]
        print(f"N={n} q x {gain:g}: plain vs float64 (dq, dk, dv) "
              f"{[round(e, 5) for e in errs]}")
        for choice in itertools.product((0, 1), repeat=3):
            got = simulated(q, k, v, dout, out, *choice)
            errs = [max_norm_rel(a, b) for a, b in zip(got, plain)]
            worst[choice] = max(worst.get(choice, 0.0), *errs)
            print(f"  split_p {choice[0]} split_ds {choice[1]} exact_D {choice[2]}: "
                  f"{[round(e, 5) for e in errs]}")
    print("largest over the cases:", {f"split_p {a} split_ds {b} exact_D {c}": round(w, 5)
                                      for (a, b, c), w in worst.items()})


if __name__ == "__main__":
    main()
