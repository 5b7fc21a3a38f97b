"""Shard generation across jobs by file list for the PyTorch port, the
counterpart of scripts/submit_inference.py (the reference's job-array
inference pattern: each job gets files_job<i>.txt and runs the sampling CLI
on its slice).

The same arguments and the same files: under --job-dir, files_job<i>.txt
(--files-per-job lines of --file-list each) and inf_job<i>.sh, which runs
the port's sampling CLI (``python -m calodiffusion_tpu_torch.inference``,
one process a job, on the card) with ``--job-idx <i>`` and its file list,
writing <odir>/generated_job<i>.h5.  Submit the scripts with your scheduler
(sbatch, a job array, nohup).

    python scripts/torch_submit_inference.py --file-list files.txt \\
        --config configs/config_dataset2.json --model-loc ckpt/final.ckpt \\
        --odir gen/ --files-per-job 2
"""

from __future__ import annotations

import argparse
import math
import os
import stat

TEMPLATE = """#!/bin/bash
set -e
python -m calodiffusion_tpu_torch.inference \\
    -c {config} -d {data_folder} --job-idx {idx} \\
    sample --sample-steps {steps} --sample-algo {algo} \\
    --sample-file {file_list} --model-loc {model_loc} \\
    -g {odir}/generated_job{idx}.h5 diffusion
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--file-list", required=True,
                    help="text file with one shower h5 per line")
    ap.add_argument("--config", required=True)
    ap.add_argument("--model-loc", required=True)
    ap.add_argument("--odir", required=True)
    ap.add_argument("--data-folder", default="./data")
    ap.add_argument("--job-dir", default="inference_jobs")
    ap.add_argument("--files-per-job", type=int, default=1)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--algo", default="DDim")
    args = ap.parse_args()

    os.makedirs(args.job_dir, exist_ok=True)
    os.makedirs(args.odir, exist_ok=True)
    with open(args.file_list) as f:
        files = [line.strip() for line in f if line.strip()]

    n_jobs = math.ceil(len(files) / args.files_per_job)
    print(f"{n_jobs} jobs")
    for i in range(n_jobs):
        batch = files[i * args.files_per_job: (i + 1) * args.files_per_job]
        job_files = os.path.abspath(
            os.path.join(args.job_dir, f"files_job{i}.txt")
        )
        with open(job_files, "w") as f:
            f.write("\n".join(batch) + "\n")
        script = os.path.join(args.job_dir, f"inf_job{i}.sh")
        with open(script, "w") as f:
            f.write(TEMPLATE.format(
                config=args.config, data_folder=args.data_folder, idx=i,
                steps=args.steps, algo=args.algo, file_list=job_files,
                model_loc=args.model_loc, odir=args.odir,
            ))
        os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
        print(f"wrote {script}")


if __name__ == "__main__":
    main()
