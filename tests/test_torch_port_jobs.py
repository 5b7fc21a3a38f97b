"""The port's job-launch entry points (scripts/torch_submit_training.py,
scripts/torch_submit_inference.py, scripts/torch_submit_plotting.py,
scripts/torch_train_h100.sh) against the JAX package's (scripts/
submit_training.py, submit_inference.py, submit_plotting.py, train_tpu.sh),
on the CPU.

For the same arguments each writes the JAX script's files: the same file
set, job count, file slices and frozen config, and job scripts whose text
is the JAX script's with the port's module in place of the JAX package's
(``torchrun --nproc-per-node gpu -m calodiffusion_tpu_torch.training`` for
training, ``python -m calodiffusion_tpu_torch.inference`` for sampling and
plotting), so the CLI arguments after the module are the same.  Then they
run for real: the training job's restart loop under a ``torchrun`` shim
first on PATH that reports its first call as a preemption after one epoch
(it trains that epoch, then exits 1) and runs the real torchrun after, on
one CPU process with ``--device cpu``; the second call carries ``--load``,
resumes at the checkpoint's epoch and ends at MAXEPOCH.  torch_train_h100.sh
adds ``--load`` where the port's checkpoint exists.  And an emitted
plotting job's sample and plot commands, and an inference job's command,
go through the port's CLI with only ``--device cpu`` added."""

import json
import os
import re
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch import inference as tinf
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from tests.test_torch_port_data import make_h5
from tests.utils_test import tiny_ds2_config

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
TRAIN_JAX = "python -m calodiffusion_tpu.training"
TRAIN_PORT = "torchrun --nproc-per-node gpu -m calodiffusion_tpu_torch.training"
INFER_JAX = "python -m calodiffusion_tpu.inference"
INFER_PORT = "python -m calodiffusion_tpu_torch.inference"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch and two BLAS threads: the Tier-1 run shares the cores
    between six workers."""
    from threadpoolctl import threadpool_limits

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    with threadpool_limits(limits=2):
        yield
    torch.set_num_threads(prev)


def _cfg(**kw):
    return tiny_ds2_config(**{**dict(
        EVAL=["dataset_2_2.hdf5"], VAL_FILES=["dataset_2_2.hdf5"], BATCH=16, MAXEPOCH=2,
        NSTEPS=4, LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, CHECKPOINT_NAME="job"),
        **kw})


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Two h5 files of 32 ds2 showers and the tiny config."""
    root = tmp_path_factory.mktemp("jobs")
    data = root / "data"
    data.mkdir()
    for i, fname in enumerate(("dataset_2_1.hdf5", "dataset_2_2.hdf5")):
        make_h5(data / fname, 32, 6480, seed=i)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(_cfg()))
    return root, str(data) + "/", str(cfg_path)


def _run(script, args, cwd, env=None):
    proc = subprocess.run([sys.executable, str(SCRIPTS / script), *args], cwd=cwd,
                          capture_output=True, text=True, timeout=60,
                          env=dict(os.environ, **(env or {})))
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _tree(folder: Path) -> dict:
    """{relative path: text} of every file under ``folder``."""
    return {str(p.relative_to(folder)): p.read_text() for p in sorted(folder.rglob("*"))
            if p.is_file()}


def _both(jax_script, port_script, args, cwd: Path, out: str, extra_dirs=()):
    """Run the JAX script, then the port's, with the same arguments in the
    same directory; the files each wrote under ``out`` (and
    ``extra_dirs``), each run's from a clean directory."""
    trees = []
    for script in (jax_script, port_script):
        for d in (out, *extra_dirs):
            shutil.rmtree(cwd / d, ignore_errors=True)
        _run(script, args, cwd)
        trees.append({d: _tree(cwd / d) for d in (out, *extra_dirs)})
    return trees


def _command_args(text: str, module: str) -> list[list[str]]:
    """The arguments after ``module`` of each command of a job script
    (continuation lines joined)."""
    joined = text.replace("\\\n", " ")
    return [shlex.split(line.split(module, 1)[1]) for line in joined.splitlines()
            if module in line]


# ---------------------------------------------------------------------------
# the files each script writes, against the JAX script's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--model", "layer", "--max-restarts", "3",
                                        "--extra-args", "--seed 7 --frac 0.9"]],
                         ids=["diffusion", "layer"])
def test_training_job_matches_jax(workspace, tmp_path, extra):
    _, data, cfg = workspace
    args = ["-c", cfg, "-n", "job_ds2/", "-d", data, "--checkpoint-folder", "ckpt/", *extra]
    jax_tree, port_tree = _both("submit_training.py", "torch_submit_training.py", args,
                                tmp_path, "job_ds2")
    jax_files, port_files = jax_tree["job_ds2"], port_tree["job_ds2"]
    assert set(port_files) == set(jax_files) == {"config.json", "train.sh"}
    assert port_files["config.json"] == jax_files["config.json"] == Path(cfg).read_text()
    assert jax_files["train.sh"].count(TRAIN_JAX) == 1
    assert port_files["train.sh"] == jax_files["train.sh"].replace(TRAIN_JAX, TRAIN_PORT)
    assert _command_args(port_files["train.sh"], "calodiffusion_tpu_torch.training") == \
        _command_args(jax_files["train.sh"], "calodiffusion_tpu.training")
    assert os.access(tmp_path / "job_ds2" / "train.sh", os.X_OK)


def test_training_job_resubmit_keeps_the_script(workspace, tmp_path):
    """--resubmit writes nothing and --submit-cmd launches the existing
    script, as in the JAX script."""
    _, data, cfg = workspace
    _run("torch_submit_training.py", ["-c", cfg, "-n", "job", "-d", data], tmp_path)
    script = tmp_path / "job" / "train.sh"
    script.write_text("#!/bin/bash\necho resubmitted $0\n")
    out = _run("torch_submit_training.py",
               ["-c", cfg, "-n", "job", "--resubmit", "--submit-cmd", "bash"], tmp_path)
    assert "resubmitted job/train.sh" in out


@pytest.mark.parametrize("files_per_job", [1, 2, 5])
def test_inference_jobs_match_jax(tmp_path, files_per_job):
    files = [f"/data/showers_{i}.h5" for i in range(5)]
    (tmp_path / "files.txt").write_text("\n".join(files) + "\n\n")
    args = ["--file-list", "files.txt", "--config", "cfg.json", "--model-loc",
            "ckpt/final.ckpt", "--odir", "gen", "--job-dir", "jobs", "--files-per-job",
            str(files_per_job), "--steps", "20", "--algo", "DPMPP2M"]
    jax_tree, port_tree = _both("submit_inference.py", "torch_submit_inference.py", args,
                                tmp_path, "jobs", extra_dirs=("gen",))
    jax_files, port_files = jax_tree["jobs"], port_tree["jobs"]
    n_jobs = -(-5 // files_per_job)
    assert set(port_files) == set(jax_files) == (
        {f"files_job{i}.txt" for i in range(n_jobs)} | {f"inf_job{i}.sh" for i in range(n_jobs)})
    for i in range(n_jobs):
        want = files[i * files_per_job:(i + 1) * files_per_job]
        assert port_files[f"files_job{i}.txt"] == jax_files[f"files_job{i}.txt"] == \
            "\n".join(want) + "\n"
        jax_sh, port_sh = jax_files[f"inf_job{i}.sh"], port_files[f"inf_job{i}.sh"]
        assert jax_sh.count(INFER_JAX) == 1 and port_sh == jax_sh.replace(INFER_JAX, INFER_PORT)
        assert _command_args(port_sh, "calodiffusion_tpu_torch.inference") == \
            _command_args(jax_sh, "calodiffusion_tpu.inference")
        assert f"--job-idx {i}" in port_sh
    assert port_tree["gen"] == jax_tree["gen"] == {}


@pytest.mark.parametrize("num_jobs,layer", [(1, False), (3, False), (2, True)])
def test_plotting_jobs_match_jax(tmp_path, num_jobs, layer):
    args = ["-d", "ckpt/ds2_Diffusion/", "-n", "plots_ds2", "--nevts", "100", "--num-jobs",
            str(num_jobs), "--sample-steps", "10", "--sample-algo", "Consistency",
            "--sample-offset", "3", "--batch-size", "50", "--data-folder", "/data/",
            "--extra-args", "--seed 4"]
    if layer:
        args += ["--layer-model", "ckpt/ds2_LayerModel/final.ckpt", "-v", "final.ckpt"]
    jax_tree, port_tree = _both("submit_plotting.py", "torch_submit_plotting.py", args,
                                tmp_path, "plots_ds2")
    jax_files, port_files = jax_tree["plots_ds2"], port_tree["plots_ds2"]
    tags = [""] if num_jobs == 1 else [f"_j{i}" for i in range(num_jobs)]
    assert set(port_files) == set(jax_files) == {f"plot{t}.sh" for t in tags}
    for i, tag in enumerate(tags):
        jax_sh, port_sh = jax_files[f"plot{tag}.sh"], port_files[f"plot{tag}.sh"]
        assert jax_sh.count(INFER_JAX) == 2 and port_sh == jax_sh.replace(INFER_JAX, INFER_PORT)
        sample, plot = _command_args(port_sh, "calodiffusion_tpu_torch.inference")
        assert [sample, plot] == _command_args(jax_sh, "calodiffusion_tpu.inference")
        n = sample[sample.index("-n") + 1]
        assert n == str(100 // num_jobs)
        assert ("--job-idx" in sample) == (num_jobs > 1)
        if num_jobs > 1:
            assert sample[sample.index("--job-idx") + 1] == str(i)
        assert sample[-3:] == (["layer", "--layer-model", "ckpt/ds2_LayerModel/final.ckpt"]
                               if layer else ["--seed", "4", "diffusion"])


# ---------------------------------------------------------------------------
# the restart loop, run for real on the CPU
# ---------------------------------------------------------------------------

TORCHRUN_SHIM = r'''#!{python}
"""torchrun, as a job on a host without a card sees it: each call's argv is
logged; the first call trains one epoch (MAXEPOCH 1) and then fails, as a
job preempted after its first epoch's checkpoint; later calls run the real
torchrun on one CPU process, --device cpu before the subcommand."""
import json, os, subprocess, sys

log = os.environ["TORCHRUN_SHIM_LOG"]
args = sys.argv[1:]
calls = len(open(log).read().splitlines()) if os.path.exists(log) else 0
with open(log, "a") as f:
    f.write(json.dumps(args) + "\n")
if os.environ.get("TORCHRUN_SHIM_DRY"):
    sys.exit(1 if calls == 0 else 0)
assert args[:2] == ["--nproc-per-node", "gpu"], args
rest = args[2:]
if calls == 0:
    i = rest.index("-c") + 1
    cfg = json.load(open(rest[i]))
    cfg["MAXEPOCH"] = 1
    rest[i] = rest[i] + ".first_attempt.json"
    json.dump(cfg, open(rest[i], "w"))
cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
       *rest[:-1], "--device", "cpu", rest[-1]]
rc = subprocess.call(cmd)
sys.exit(1 if calls == 0 else rc)
'''


def _shim(folder: Path, log: Path, dry=False) -> dict:
    """A ``torchrun`` shim first on PATH; the environment a job runs in."""
    bin_dir = folder / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "torchrun"
    shim.write_text(TORCHRUN_SHIM.replace("{python}", sys.executable))
    shim.chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}", PYTHONPATH=str(ROOT),
               TORCHRUN_SHIM_LOG=str(log), OMP_NUM_THREADS="2")
    if dry:
        env["TORCHRUN_SHIM_DRY"] = "1"
    return env


def test_training_job_restarts_with_load_and_resumes(workspace, tmp_path):
    """The emitted train.sh, submitted with --submit-cmd bash: the first
    attempt trains epoch 0 and fails; the loop runs torchrun again with
    --load, which resumes at epoch 1 from the checkpoint and ends at
    MAXEPOCH (2 epochs in the final state, the first attempt's loss kept)."""
    _, data, cfg = workspace
    log = tmp_path / "torchrun_calls.jsonl"
    env = _shim(tmp_path, log)
    proc = subprocess.run(
        [sys.executable, str(SCRIPTS / "torch_submit_training.py"), "-c", cfg, "-n", "job",
         "-d", data, "--checkpoint-folder", str(tmp_path / "ckpt"), "--max-restarts", "2",
         "--extra-args", "--seed 3", "--submit-cmd", "bash"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(calls) == 2
    assert "--load" not in calls[0] and "--load" in calls[1]
    for call in calls:
        assert call[:4] == ["--nproc-per-node", "gpu", "-m", "calodiffusion_tpu_torch.training"]
        assert call[-3:] == ["--seed", "3", "diffusion"]
    first, second = proc.stdout.split("restart 1/2 (exit code 1); resuming from checkpoint")
    assert re.findall(r"Beginning epoch (\d+)", first) == ["0"]
    assert re.findall(r"Beginning epoch (\d+)", second) == ["1"]
    assert "training finished cleanly" in second
    folder = tmp_path / "ckpt" / "job_Diffusion"
    state = json.loads((folder / "final_state.json").read_text())
    assert state["epoch"] == 1  # MAXEPOCH 2
    assert sorted(state["train_loss_hist"]) == ["0", "1"]
    first_state = json.loads((folder / "checkpoint_state.json").read_text())
    assert first_state["train_loss_hist"]["0"] == state["train_loss_hist"]["0"]


@pytest.mark.parametrize("checkpoint", [False, True], ids=["fresh", "resume"])
def test_train_h100_sh_adds_load_when_a_checkpoint_exists(workspace, tmp_path, checkpoint):
    """torch_train_h100.sh reads CHECKPOINT_NAME through the port's config
    loader and adds --load where <CKPT>/<name>_Diffusion/checkpoint.ckpt
    exists; after a failed attempt it runs again with --load."""
    _, data, cfg = workspace
    ckpt = tmp_path / "ckpt"
    if checkpoint:
        (ckpt / "job_Diffusion").mkdir(parents=True)
        (ckpt / "job_Diffusion" / "checkpoint.ckpt").write_bytes(b"")
    log = tmp_path / "calls.jsonl"
    env = _shim(tmp_path, log, dry=True)
    env.update(CONFIG=cfg, DATA=data, CKPT=str(ckpt), MAX_RESTARTS="3")
    proc = subprocess.run(["bash", str(SCRIPTS / "torch_train_h100.sh")], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    want = ["--nproc-per-node", "gpu", "-m", "calodiffusion_tpu_torch.training", "-c", cfg,
            "-d", data, "--checkpoint", str(ckpt)]
    assert calls == [want + (["--load"] if checkpoint else []) + ["diffusion"],
                     want + ["--load", "diffusion"]]
    assert "training exited with 1; restart 1/3" in proc.stdout
    assert "training finished" in proc.stdout


# ---------------------------------------------------------------------------
# emitted jobs through the port's CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_dir(workspace):
    """A checkpoint of seeded weights beside its config, as a trainer's
    folder holds them."""
    root, _, cfg = workspace
    folder = root / "ckpt" / "job_Diffusion"
    model = CaloDiffusion(json.loads(Path(cfg).read_text()), n_steps=4, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    ckpt_io.save_checkpoint(str(folder), "checkpoint", params=model.state_dict())
    (folder / "config.json").write_text(Path(cfg).read_text())
    return folder


def _with_device(argv):
    sub = next(i for i, a in enumerate(argv) if a in ("sample", "plot"))
    return argv[:sub] + ["--device", "cpu"] + argv[sub:]


def test_plotting_job_samples_and_plots_its_slice(workspace, model_dir, monkeypatch):
    """Job 1 of 2 (32 events): its sample command generates the second
    half's 16 showers, the data's incident energies of events 16..31, and
    its plot command plots them against the same Geant4 slice."""
    root, data, _ = workspace
    job = root / "plot_job"
    _run("torch_submit_plotting.py", ["-d", str(model_dir), "-n", str(job), "--nevts", "32",
                                      "--num-jobs", "2", "--sample-steps", "2",
                                      "--data-folder", data], root)
    script = (job / "plot_j1.sh").read_text()
    monkeypatch.chdir(re.search(r"^cd (.+)$", script, re.M).group(1))
    sample, plot = (_with_device(a) for a in _command_args(script, "calodiffusion_tpu_torch"
                                                                   ".inference"))
    gen = tinf.main(sample)
    assert gen == str(job / "generated_j1.h5")
    with h5py.File(gen, "r") as f, h5py.File(Path(data) / "dataset_2_2.hdf5", "r") as g:
        assert f["showers"].shape == (16, 6480)
        np.testing.assert_allclose(f["incident_energies"][:], g["incident_energies"][16:32],
                                   rtol=1e-5)
        assert np.isfinite(f["showers"][:]).all() and (f["showers"][:] >= 0).all()
    separations = tinf.main(plot)
    assert separations and (job / "plots_j1").is_dir() and any((job / "plots_j1").iterdir())


def test_inference_job_command_is_refused_as_jax_refuses_it(workspace, model_dir, tmp_path):
    """An emitted inference job carries --job-idx without -n, as the JAX
    script's does (submit_inference.py's template); both CLIs refuse it,
    since --job-idx slices events by -n (ROADMAP Queue 3)."""
    root, data, cfg = workspace
    (tmp_path / "files.txt").write_text("dataset_2_2.hdf5\n")
    args = ["--file-list", "files.txt", "--config", cfg, "--model-loc",
            str(model_dir / "checkpoint.ckpt"), "--odir", "gen", "--job-dir", "jobs",
            "--data-folder", data, "--steps", "2"]
    _run("torch_submit_inference.py", args, tmp_path)
    port = _command_args((tmp_path / "jobs" / "inf_job0.sh").read_text(),
                         "calodiffusion_tpu_torch.inference")[0]
    with pytest.raises(ValueError, match="--job-idx requires a positive --n-events"):
        tinf.main(_with_device(port))
    _run("submit_inference.py", args, tmp_path)
    jax = _command_args((tmp_path / "jobs" / "inf_job0.sh").read_text(),
                        "calodiffusion_tpu.inference")[0]
    assert jax == port
    proc = subprocess.run([sys.executable, "-m", "calodiffusion_tpu.inference", *jax],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0
    assert "--job-idx requires a positive --n-events" in proc.stderr
