"""Generate (and optionally submit) a training job script for the PyTorch
port, the counterpart of scripts/submit_training.py.

The same arguments and the same files: a job directory ``<name>/`` holding
a frozen copy of the config (``config.json``) and a restart-looped launch
script (``train.sh``).  The script runs the port's training CLI under
torchrun on every card of the node (``--nproc-per-node gpu``, as the JAX
CLI takes every local device); after a failed attempt (a preemption, a
node fault) it runs again with ``--load``, which resumes from the epoch
checkpoint the trainer writes, up to --max-restarts times.

The emitted script is scheduler-agnostic: pass --submit-cmd "sbatch" /
"qsub" / "bash" to launch it at once, or submit the file yourself.  A
requeued job reruns the same script; --resubmit keeps the existing job
directory and script.

    python scripts/torch_submit_training.py -c configs/config_dataset2.json \\
        -n jobs/ds2 -d /data/ --checkpoint-folder /ckpt/ --submit-cmd sbatch
"""

from __future__ import annotations

import argparse
import os
import shutil
import stat
import subprocess

TEMPLATE = """#!/bin/bash
# training job '{name}' (model={model})
set -u
cd {workdir}

max_restarts={max_restarts}
n=0
extra=""
while [ $n -le $max_restarts ]; do
    torchrun --nproc-per-node gpu -m calodiffusion_tpu_torch.training \\
        -c {cfg_loc} -d {data_folder} --checkpoint {ckpt_folder} \\
        $extra {extra_args} {model}
    rc=$?
    if [ $rc -eq 0 ]; then
        echo "training finished cleanly"
        exit 0
    fi
    n=$((n+1))
    extra="--load"
    echo "restart $n/$max_restarts (exit code $rc); resuming from checkpoint"
done
exit 1
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="diffusion",
                    choices=["diffusion", "layer"],
                    help="Trainer subcommand (reference: diffu/layers)")
    ap.add_argument("-c", "--config", default="config_dataset2.json")
    ap.add_argument("-n", "--name", default="test", help="job name")
    ap.add_argument("-d", "--data-folder", default="./data/")
    ap.add_argument("--checkpoint-folder", default="./trained_models/")
    ap.add_argument("--max-restarts", type=int, default=10)
    ap.add_argument("--resubmit", action="store_true",
                    help="reuse the existing job dir/script")
    ap.add_argument("--submit-cmd", default="",
                    help="command to launch the script (e.g. sbatch, bash); "
                         "empty = just generate")
    ap.add_argument("--extra-args", default="")
    args = ap.parse_args(argv)

    name = args.name.rstrip("/")
    os.makedirs(name, exist_ok=True)
    cfg_loc = os.path.join(name, "config.json")
    script_loc = os.path.join(name, "train.sh")

    if not args.resubmit:
        shutil.copy(args.config, cfg_loc)
        with open(script_loc, "w") as f:
            f.write(TEMPLATE.format(
                name=name, model=args.model, workdir=os.getcwd(),
                cfg_loc=os.path.abspath(cfg_loc),
                data_folder=args.data_folder,
                ckpt_folder=args.checkpoint_folder,
                max_restarts=args.max_restarts,
                extra_args=args.extra_args,
            ))
        os.chmod(script_loc, os.stat(script_loc).st_mode | stat.S_IEXEC)
    print(f"job script: {script_loc}")

    if args.submit_cmd:
        subprocess.run([*args.submit_cmd.split(), script_loc], check=True)


if __name__ == "__main__":
    main()
