#!/usr/bin/env python3
"""Where the time of the HGCal GLaM embedding goes, on one CUDA card and its
host.

    python3 scripts/torch_hgcal_glam.py [--names hgcal_photons hgcal_pions]
                                        [--reps 5] [--out FILE]

For each HGCal config of chip_smoke.HGCAL_DATA (configs/config_HGCal_photons.json,
configs/config_HGCal_pions.json), on chip_smoke.py's synthetic geometry of
that config (MAX_CELLS cells a layer, SHAPE_FINAL's layers and bins):

- ``HGCalConverter.init`` on the host (``device="cpu"``: one
  ``np.linalg.pinv`` a layer in float32, as the JAX package takes them),
  its wall and the slowest layer's;
- the same pseudo-inverses on the card (``CARD_PINV``): one batched
  ``torch.linalg.pinv`` of the (L, out, ncell) stack in f32 at three cuts,
  and through the (out, out) Gram matrix (``A^T pinv(A A^T)``, hermitian)
  in f32 and f64 (``gram_f64``, what ``HGCalConverter.init`` takes on the
  card), each against numpy's: max abs difference and that over max
  |numpy|;
- the dense encode and decode of one batch of the config's BATCH showers on
  the card (``HGCalConverter.enc`` / ``dec``, numpy in and out, the
  transfers included: host clock around a synchronised call) and the
  numpy sparse decode of the same batch.

Prints one line each and one JSON line; ``--out`` also writes the JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from calodiffusion_tpu_torch.utils import hgcal_utils  # noqa: E402


def wall(fn, reps):
    """Median host wall of ``fn`` (synchronised), after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def gram_pinv(a):
    """pinv(A) = A^T pinv(A A^T), the pseudo-inverse of the (out, out) Gram
    matrix by its eigendecomposition."""
    return a.transpose(-1, -2) @ torch.linalg.pinv(a @ a.transpose(-1, -2), hermitian=True)


def gram_pinv_f64(a):
    """The same in float64 (the Gram matrix's null eigenvalues then fall
    far below the cut), rounded to f32."""
    a64 = a.double()
    g = torch.linalg.pinv(a64 @ a64.transpose(-1, -2), hermitian=True, rtol=1e-10)
    return (a64.transpose(-1, -2) @ g).float()


# the ways to take the stack's pseudo-inverses on the card: torch's default
# cut (rtol = eps * max(m, n), 2.7e-3 at the pions' 22,268 cells) and
# smaller ones (numpy's rcond is 1e-15), and the Gram matrix's
CARD_PINV = {
    "pinv": torch.linalg.pinv,
    "pinv_rtol1e-5": lambda a: torch.linalg.pinv(a, rtol=1e-5),
    "pinv_rtol1e-6": lambda a: torch.linalg.pinv(a, rtol=1e-6),
    "gram": gram_pinv,
    "gram_f64": gram_pinv_f64,
}


def probe(name, root, reps):
    cfg = json.loads((ROOT / "configs" / chip_smoke.HGCAL_DATA[name]["config"]).read_text())
    geom_file = chip_smoke.hgcal_geom_file(root, name, cfg)
    conv = hgcal_utils.HGCalConverter(bins=cfg["SHAPE_FINAL"], geom_file=geom_file)
    layer_s = []
    pinv = np.linalg.pinv

    def timed_pinv(a):
        t0 = time.perf_counter()
        out = pinv(a)
        layer_s.append(time.perf_counter() - t0)
        return out

    np.linalg.pinv = timed_pinv
    try:
        t0 = time.perf_counter()
        conv.init(norm=True, dataset_num=cfg["DATASET_NUM"], device="cpu")
        init_s = time.perf_counter() - t0
    finally:
        np.linalg.pinv = pinv
    L, out_dim, ncell = conv.enc_mat.shape
    print(f"{name}: geometry ({L}, {out_dim}, {ncell}); HGCalConverter.init {init_s:.2f} s on "
          f"the host ({len(layer_s)} pinv, {sum(layer_s):.2f} s, slowest {max(layer_s):.3f} s)",
          flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    enc = torch.from_numpy(conv.enc_mat).cuda()
    ref = conv.dec_mat
    scale = float(np.abs(ref).max())
    card = {}
    for how, fn in CARD_PINV.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(enc)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        err = float(np.abs(got.cpu().numpy() - ref).max())
        card[how] = dict(s=s, max_abs_err=err, rel_err=err / scale)
        print(f"{name}: card {how} of the stack {s:.3f} s (cold), max |card - numpy| "
              f"{err:.3g} ({err / scale:.3g} of max |numpy| {scale:.3g})", flush=True)
        del got

    B = cfg["BATCH"]
    rng = np.random.default_rng(0)
    x = rng.exponential(1.0, (B, L, ncell)).astype(np.float32)
    y = rng.standard_normal((B, L, cfg["SHAPE_FINAL"][3], cfg["SHAPE_FINAL"][4])).astype(
        np.float32)
    enc_s = wall(lambda: conv.enc(x, device="cuda"), reps)
    dec_s = wall(lambda: conv.dec(y, device="cuda"), reps)
    t0 = time.perf_counter()
    conv.dec(y, sparse_decoding=True, rng=np.random.default_rng(1))
    sparse_s = time.perf_counter() - t0
    gflop = 2 * B * L * out_dim * ncell / 1e9
    print(f"{name}: batch {B}: dense enc {enc_s:.3f} s, dec {dec_s:.3f} s on the card with the "
          f"transfers ({gflop:.1f} GFLOP each); sparse dec {sparse_s:.3f} s on the host; nonzero "
          f"decode weights (> 1e-6) {int((conv.dec_mat > 1e-6).sum())}", flush=True)
    return dict(shape=[L, out_dim, ncell], init_s=init_s, pinv_s=sum(layer_s),
                slowest_pinv_s=max(layer_s), card_pinv=card, batch=B, enc_s=enc_s, dec_s=dec_s,
                sparse_dec_s=sparse_s, gflop_each_way=gflop)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--names", nargs="+", default=list(chip_smoke.HGCAL_DATA))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_hgcal_glam: no CUDA device")
    card = chip_smoke.card_line()
    print(card, flush=True)
    import os

    results = {"card": card, "host_cpus": os.cpu_count()}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.names:
            results[name] = probe(name, Path(tmp), args.reps)
    line = json.dumps(results)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
