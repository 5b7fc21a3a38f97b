"""Generate (and optionally submit) sampling + plotting job scripts for the
PyTorch port, the counterpart of scripts/submit_plotting.py.

The same arguments and the same files: under <name>/, plot.sh (or, with
--num-jobs N, plot_j<i>.sh for i < N), each running the port's sampling
CLI (``python -m calodiffusion_tpu_torch.inference``, one process a job,
on the card) and then its plot command on the generated file.  With
--num-jobs N the event budget --nevts is split N ways and job i samples
its disjoint slice (``--job-idx i -n nevts/N``), then plots its own
output.  Scheduler-agnostic: pass --submit-cmd to launch each script, or
submit the emitted scripts yourself.

    python scripts/torch_submit_plotting.py -d ckpt/ds2_Diffusion -n plots_ds2 \\
        --nevts 10000 --num-jobs 4 --submit-cmd sbatch
"""

from __future__ import annotations

import argparse
import os
import stat
import subprocess

TEMPLATE = """#!/bin/bash
# plotting job '{name}'{job_tag}
set -eu
cd {workdir}

python -m calodiffusion_tpu_torch.inference \\
    -c {config} -d {data_folder} -n {nevts}{job_flag} \\
    sample --sample-steps {steps} --sample-algo {algo} \\
    --batch-size {batch_size} --sample-offset {offset} \\
    --model-loc {model_loc} -g {gen_out} {extra_args} {subcommand}

python -m calodiffusion_tpu_torch.inference \\
    -c {config} -d {data_folder} -n {nevts}{job_flag} \\
    plot -g {gen_out} --plot-folder {plot_folder}
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--model-dir", required=True,
                    help="directory containing the trained model")
    ap.add_argument("-n", "--name", default="test", help="job name")
    ap.add_argument("-v", "--model-version", default="checkpoint.ckpt",
                    help="best_val.ckpt / checkpoint.ckpt / final.ckpt")
    ap.add_argument("-c", "--config", default="",
                    help="config (default: <model-dir>/config.json)")
    ap.add_argument("--sample-algo", default="DDim")
    ap.add_argument("--sample-offset", type=int, default=0)
    ap.add_argument("--sample-steps", type=int, default=400)
    ap.add_argument("--nevts", type=int, default=1000)
    ap.add_argument("--num-jobs", type=int, default=1,
                    help="split sampling into this many --job-idx shards")
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--data-folder", default="./data/")
    ap.add_argument("--layer-model", default="",
                    help="path to a layer model -> use the 'layer' "
                         "sampling subcommand")
    ap.add_argument("--submit-cmd", default="",
                    help="command to launch each script (e.g. sbatch, bash)")
    ap.add_argument("--extra-args", default="")
    args = ap.parse_args(argv)

    name = args.name.rstrip("/")
    model_dir = args.model_dir.rstrip("/")
    config = args.config or os.path.join(model_dir, "config.json")
    os.makedirs(name, exist_ok=True)

    if args.num_jobs == 1:
        job_idxs = [-1]
        nevts = args.nevts
    else:
        job_idxs = list(range(args.num_jobs))
        nevts = args.nevts // args.num_jobs

    if args.layer_model:
        subcommand = f"layer --layer-model {args.layer_model}"
    else:
        subcommand = "diffusion"

    scripts = []
    for job_idx in job_idxs:
        tag = "" if job_idx < 0 else f"_j{job_idx}"
        script_loc = os.path.join(name, f"plot{tag}.sh")
        gen_out = os.path.join(name, f"generated{tag}.h5")
        with open(script_loc, "w") as f:
            f.write(TEMPLATE.format(
                name=name, job_tag=tag, workdir=os.getcwd(),
                config=config, data_folder=args.data_folder,
                nevts=nevts,
                job_flag="" if job_idx < 0 else f" --job-idx {job_idx}",
                steps=args.sample_steps, algo=args.sample_algo,
                batch_size=args.batch_size, offset=args.sample_offset,
                model_loc=os.path.join(model_dir, args.model_version),
                gen_out=gen_out,
                plot_folder=os.path.join(name, f"plots{tag}"),
                extra_args=args.extra_args,
                subcommand=subcommand,
            ))
        os.chmod(script_loc, os.stat(script_loc).st_mode | stat.S_IEXEC)
        scripts.append(script_loc)
        print(f"job script: {script_loc}")

    if args.submit_cmd:
        for s in scripts:
            subprocess.run([*args.submit_cmd.split(), s], check=True)


if __name__ == "__main__":
    main()
