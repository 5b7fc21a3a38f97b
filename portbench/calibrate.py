"""Readings that the limits of the check are set from, at a cell's own size.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 3] [--out chiprun_out/calibrate_<name>.json]

For each seed it drives the timed path once as a run does (one generation
call, or the checked train steps), compares it with the reference, and
prints the numbers: the lower readings.  On the first ``--control-seeds``
seeds it also reads the control, the step below the configuration's
precision that would tempt a later change (generation: the program's own
W8A8 int8 path, ``QUANT_INT8``; training, which has no such path: the
reference with every product's operands and every layer's output in
float8 e4m3 and its gradients in e5m2), and for
training the fault of half the batch left out (the reference over the first
half of each batch, the mean taken over it): the upper readings.  The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def generation_readings(config, traffic, seed, device, control: bool) -> dict:
    """One generation call of the program (and, with ``control``, of its
    int8 path from the same start noise), judged as a run judges a call."""
    import torch

    from portbench import harness, judge

    model, conds, loaders, sampler = harness.build_generation(config, traffic, seed, device)
    gen = torch.Generator(device=device)
    plan = judge.capture_plan(seed, len(conds[0][0]), traffic)
    capture = judge.Capture(model.net, *plan)
    t = time.perf_counter()
    capture.begin(0)
    showers = harness.generate_call(model, loaders, sampler, traffic, seed, 0, gen)
    capture.end()
    out = {"call_s": time.perf_counter() - t}
    if control:
        # calibrate the int8 scales apart, so the call draws the same start noise
        model.config["QUANT_INT8"] = True
        E0, L0 = conds[0]
        model.prepare_int8(E=E0, layers=L0 if model.layer_cond else None,
                           generator=torch.Generator(device=device).manual_seed(4321))
        t = time.perf_counter()
        capture.begin(1)
        int8 = harness.generate_call(model, loaders, sampler, traffic, seed, 0, gen)
        capture.end()
        out["control_call_s"] = time.perf_counter() - t
    capture.close()
    del model, sampler
    harness._free()
    t = time.perf_counter()
    gaps = judge.generation_gaps(config, traffic, seed, [(0, showers)], capture, conds, device)[0]
    out["reference_s"] = time.perf_counter() - t
    out["stages"], out["gap"] = gaps, judge.call_gap(gaps)
    if control:
        # the int8 call ran call 0's inputs: judge it as call 0
        capture.store[0] = capture.store[1]
        g = judge.generation_gaps(config, traffic, seed, [(0, int8)], capture, conds, device)[0]
        out["control_stages"], out["control_gap"] = g, judge.call_gap(g)
    return out


def training_readings(config, traffic, seed, device, control: bool) -> dict:
    from portbench import harness, judge

    n = traffic["checked_steps"]
    trainer, data, conds, step = harness.build_training(config, traffic, seed, device)
    losses, program = harness.checked_steps(trainer, step, n, n)
    program["losses"] = [float(v) for v in losses]
    del trainer, step
    harness._free()
    t = time.perf_counter()
    reference = judge.reference_training(config, seed, data, conds, device, n)
    at_state = judge.reference_training(config, seed, data, conds, device, n,
                                        states=program["states"])
    out = {"reference_s": time.perf_counter() - t}
    out.update(judge.compare_training(config, seed, program, at_state, device))
    out.update(trajectory_gaps(config, seed, program, reference, device))
    out["loss_gaps"] = judge.loss_gaps(program, reference)
    out["losses"], out["reference_losses"] = program["losses"], reference["losses"]
    out["step_grad_diffs"] = {
        "own_trajectory": [judge.rel_diff(program["grads"][i], reference["grads"][i])
                           for i in range(n)],
        "at_program_state": [judge.rel_diff(program["grads"][i], at_state["grads"][i])
                             for i in range(n)]}
    out["leaves"] = leaf_table(config, seed, program, reference, device)
    out["sign_flips"] = sign_flips(config, seed, program, reference, device)
    if control:
        for name, kw in (("control", {"fake_quant": judge.fp8}),
                         ("half_batch", {"rows": data.shape[1] // 2})):
            bad = judge.reference_training(config, seed, data, conds, device, n, **kw)
            bad_state = judge.reference_training(config, seed, data, conds, device, n,
                                                 states=bad["states"])
            out[name] = judge.compare_training(config, seed, bad, bad_state, device)
            out[name].update(trajectory_gaps(config, seed, bad, reference, device))
            out[name]["loss_gaps"] = judge.loss_gaps(bad, reference)
    return out


def trajectory_gaps(config, seed, program, reference, device) -> dict:
    """The change after the checked steps against the reference's own
    training, for the median leaf (``change3_median``: each leaf's norm of
    the difference over the reference's norm of that leaf or of the median
    leaf, whichever is larger) and all leaves together (``change3_diff``)."""
    import numpy as np

    from portbench import inputs, judge

    w0 = inputs.make_weights(config, seed, device)
    moved = judge.moved_leaves(reference["grad1"])
    dr = np.array([judge._norm(reference["after"][k] - w0[k]) for k in moved])
    dd = np.array([judge._norm(program["after"][k] - reference["after"][k]) for k in moved])
    return {"change3_median": float(np.median(dd / np.maximum(dr, np.median(dr)))),
            "change3_diff": float((np.sum(dd ** 2) / np.sum(dr ** 2)) ** 0.5)}


def leaf_table(config, seed, program, reference, device, n: int = 6) -> dict:
    """The leaves that read the largest gradient and change gaps, with both
    sides' norms (the look behind a training cell's numbers)."""
    import numpy as np

    from portbench import inputs, judge

    w0 = inputs.make_weights(config, seed, device)
    keys = list(reference["grad1"])
    gr = np.array([judge._norm(reference["grad1"][k]) for k in keys])
    gp = np.array([judge._norm(program["grad1"][k]) for k in keys])
    dr = np.array([judge._norm(reference["after"][k] - w0[k]) for k in keys])
    dp = np.array([judge._norm(program["after"][k] - w0[k]) for k in keys])
    med_g, med_d = float(np.median(gr)), float(np.median(dr))
    g_gap = np.abs(gp - gr) / np.maximum(gr, med_g)
    d_gap = np.abs(dp - dr) / np.maximum(dr, med_d)

    def rows(order):
        return [[keys[i], float(gr[i]), float(gp[i]), float(dr[i]), float(dp[i]),
                 float(g_gap[i]), float(d_gap[i])] for i in order[:n]]

    return {"median_grad": med_g, "median_change": med_d,
            "columns": ["leaf", "grad_ref", "grad_prog", "change_ref", "change_prog",
                        "grad_gap", "change_gap"],
            "by_grad_gap": rows(np.argsort(-g_gap)), "by_change_gap": rows(np.argsort(-d_gap)),
            "median_change_gap": float(np.median(d_gap)),
            "median_grad_gap": float(np.median(g_gap))}


def sign_flips(config, seed, program, reference, device, n: int = 4) -> dict:
    """The look behind the whole change's swing.  Adam's first step moves
    each element by about the learning rate times the sign of its gradient,
    so an element whose first gradient the program's rounding gives the
    other sign moves by twice the step, the wrong way.  Over the leaves the
    check compares: the elements so flipped, the share of the squared
    change gap that they carry, the whole change without them, and how
    small their reference gradients are against their leaf's RMS gradient
    (median over the flipped elements, and over all, for scale)."""
    import numpy as np
    import torch

    from portbench import inputs, judge

    w0 = inputs.make_weights(config, seed, device)
    moved = judge.moved_leaves(reference["grad1"])
    flips = total = 0
    sq = sq_flip = ref_sq = 0.0
    rel_flip, rel_all, leaves = [], [], []
    for k in moved:
        g_r, g_p = reference["grad1"][k].double(), program["grad1"][k].double()
        flip = (g_r * g_p) < 0
        d = (program["after"][k] - reference["after"][k]).double()
        rms = g_r.pow(2).mean().sqrt().clamp(min=1e-300)
        rel = (g_r.abs() / rms).flatten()
        rel_all.append(rel[torch.randperm(rel.numel(), device=rel.device)[:4096]].cpu())
        rel_flip.append(rel[flip.flatten()].cpu())
        leaf_sq, leaf_flip = float(d.pow(2).sum()), float(d[flip].pow(2).sum())
        sq, sq_flip = sq + leaf_sq, sq_flip + leaf_flip
        ref_sq += float((reference["after"][k] - w0[k]).double().pow(2).sum())
        flips, total = flips + int(flip.sum()), total + flip.numel()
        leaves.append([k, int(flip.sum()), flip.numel(), leaf_sq, leaf_flip])
    rel_flip = torch.cat(rel_flip).numpy()
    rel_all = torch.cat(rel_all).numpy()
    leaves.sort(key=lambda r: -r[3])
    return {"flipped": flips, "elements": total,
            "flipped_share_of_gap_sq": sq_flip / sq if sq else 0.0,
            "change3_diff": (sq / ref_sq) ** 0.5,
            "change3_diff_unflipped": ((sq - sq_flip) / ref_sq) ** 0.5,
            "flipped_grad_over_leaf_rms_median": float(np.median(rel_flip)) if rel_flip.size else None,
            "flipped_grad_over_leaf_rms_p90": float(np.quantile(rel_flip, 0.9)) if rel_flip.size else None,
            "all_grad_over_leaf_rms_median": float(np.median(rel_all)),
            "columns": ["leaf", "flipped", "elements", "gap_sq", "gap_sq_flipped"],
            "largest_gap_leaves": leaves[:n]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out")
    args = p.parse_args(argv)

    from portbench import harness

    harness.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    bench = harness.Bench.load(ROOT / "BENCHMARK.json")
    w = bench.workload(args.workload)
    config, traffic = bench.config(w["config"]), bench.traffic(w["traffic"])
    read = generation_readings if traffic["entry"] == "generate" else training_readings
    device = torch.device("cuda")
    report = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
              "power_limit": harness.power_limit(), "seeds": {}}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = read(dict(config), traffic, seed, device, i < args.control_seeds)
        r["seconds"] = time.perf_counter() - t
        report["seeds"][str(seed)] = r
        harness.log(f"{args.workload} seed {seed}: "
                    + json.dumps({k: v for k, v in r.items()
                                  if k not in ("leaves", "sign_flips", "step_grad_diffs")})
                    + " step gradient gaps " + json.dumps(r.get("step_grad_diffs")))
        if "sign_flips" in r:
            harness.log(f"{args.workload} seed {seed} sign flips: "
                        + json.dumps({k: v for k, v in r["sign_flips"].items()
                                      if k not in ("columns", "largest_gap_leaves")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({"workload": args.workload, "total_s": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
