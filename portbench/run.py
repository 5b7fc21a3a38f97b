"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result object; the set-up's parts, the window and each number the check
compared, beside its limit, go to standard error.  Without a CUDA card (or
with fewer than the cell asks for) it exits with code 2 and prints no
result; where the process holds a module of JAX or of the JAX package once
the window has closed, with code 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# one process, few threads on fixed cores (``host.pin_cores``): the host's
# CPU ops here are small, and idle worker threads only add jitter to a
# host-held cell
os.environ.setdefault("OMP_NUM_THREADS", "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench import host

    cores = host.pin_cores()
    from portbench import harness

    harness.log(f"cores: {cores or 'unpinned'}")

    harness.cache_env(ROOT)
    import torch

    bench = harness.Bench.load(ROOT / "BENCHMARK.json")
    chips = int(bench.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t0=T0)
    banned = harness.banned_modules()
    if banned:
        harness.log(f"the process holds modules it must not: {banned}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
