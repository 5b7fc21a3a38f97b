"""The port's scale-out (parallel/mesh.py, the trainers and sampling on it)
against the JAX package's mesh and against the port's one process, on the
CPU.  The port's ranks are processes of a gloo group
(tests/torch_parallel_worker.py); the JAX side runs in-process on the 8
virtual CPU devices tests/conftest.py gives it.  Weights, batches, noise
and sigma draws are made with numpy from a seed and fed to both sides.

Bounds: the sharded loss against JAX's mesh step within JAX's own dryrun
bounds (rtol 1e-4, atol 1e-5, __graft_entry__.py:129), gradients as
tests/test_torch_port_train.py holds them (5e-4 of max |jax| + 1e-3 G),
the parameters after Adam within the port's f32 parity bound (2e-4); the
N-rank step against the port's one-process step within 1e-6 relative on
the loss and 1e-5 of each gradient's largest magnitude; the sharded
generation and cascade as tests/test_multiprocess.py holds JAX's (rtol
1e-4, atol 1e-5)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.parallel import mesh as jmesh
from calodiffusion_tpu.train.trainer import TrainDiffusion as JaxTrainer
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.data.loader import NpzDataset, load_data
from calodiffusion_tpu_torch.inference import write_out
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
from calodiffusion_tpu_torch.parallel import mesh as tmesh
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags
from tests import torch_parallel_worker as worker
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
LR = 1e-4


def _cfg(**kw):
    return tiny_ds2_config(**{**dict(LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16,
                                     BLOCK_ATTN=True, MID_ATTN=True, PRECISION="f32",
                                     NSTEPS=10), **kw})


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


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def run_ranks(mode, world, folder, inputs, env=None, timeout=240):
    """Run ``mode`` of the worker on ``world`` ranks; their outputs by rank."""
    torch.save(inputs, os.path.join(folder, "inputs.pt"))
    port = _free_port()
    full_env = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), port,
                               str(folder)], env=full_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    return [torch.load(os.path.join(folder, f"out_{r}.pt"), weights_only=False)
            for r in range(world)]


def _relerr(got, want):
    return abs(got - want) / abs(want)


# ---------------------------------------------------------------------------
# the mesh and its padding, against JAX's
# ---------------------------------------------------------------------------

def _fake_world(size):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


@pytest.mark.parametrize("data,model", [(None, 1), (4, 2)])
def test_make_mesh_matches_jax(data, model):
    """Over 8 ranks (a fake group) the port's mesh has JAX's shape on its 8
    devices (test_parallel.py:24-31) and the axis names; 3 x 2 raises in
    both, and without a group the mesh is None, one rank."""
    want = jmesh.make_mesh(data=data, model=model)
    _fake_world(8)
    try:
        got = tmesh.make_mesh(data=data, model=model, device_type="cpu")
        assert tuple(got.shape) == want.devices.shape
        assert got.mesh_dim_names == want.axis_names == ("data", "model")
        with pytest.raises(ValueError, match="3x2"):
            tmesh.make_mesh(data=3, model=2, device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()
    with pytest.raises(ValueError, match="3x2"):
        jmesh.make_mesh(data=3, model=2)
    assert tmesh.make_mesh(device_type="cpu") is None
    with pytest.raises(ValueError):
        tmesh.make_mesh(data=2, device_type="cpu")


@pytest.mark.parametrize("rows,multiple", [(5, 4), (8, 4), (1, 2), (7, 8)])
def test_pad_batch_to_multiple_matches_jax(rows, multiple):
    rng = np.random.default_rng(rows)
    arrays = (rng.standard_normal((rows, 3)).astype(np.float32),
              rng.standard_normal((rows, 2, 2)), None)
    got, n_got = tmesh.pad_batch_to_multiple(arrays, multiple)
    want, n_want = jmesh.pad_batch_to_multiple(arrays, multiple)
    assert n_got == n_want == rows
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_one_rank_is_the_identity():
    x = torch.arange(12.0).reshape(6, 2)
    assert tmesh.shard_batch(None, x, chunks=3) is x
    assert tmesh.row_range(None, 6) == (0, 6)
    assert tmesh.all_reduce_mean(None, x) is x
    assert tmesh.wrap(None, torch.nn.Linear(2, 2)).__class__ is torch.nn.Linear
    assert tmesh.process_index() == (0, 1) and tmesh.is_writer()


# ---------------------------------------------------------------------------
# one train step: 2 data ranks, and data 2 x model 2, against JAX's mesh
# ---------------------------------------------------------------------------

def _jax_mesh_step(cfg, params, batch, noise, rnd, data, model):
    """JAX's step on a data x model mesh of its virtual devices
    (shard_params_tp for the model axis): loss, gradients, Adam."""
    jm = JaxModel(dict(cfg), n_steps=10, loss_type="l2")
    mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    params = jmesh.shard_params_tp(mesh, jax.tree_util.tree_map(jnp.asarray, params))
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    sh = jmesh.batch_sharding(mesh)
    args = [jax.device_put(jnp.asarray(a), sh) for a in (*batch, noise, rnd)]

    @jax.jit
    def step(p, o, d, E, lay, nz, r):
        loss, g = jax.value_and_grad(lambda p: jm.compute_loss(
            p, jax.random.PRNGKey(0), d, E, noise=nz, layers=lay, rnd_normal=r))(p)
        upd, o = opt.update(g, o, p)
        return optax.apply_updates(p, upd), loss, g

    new, loss, grads = step(params, opt_state, *args)
    to_sd = lambda t: params_to_state_dict(jax.tree_util.tree_map(np.asarray, t), cfg)
    return float(loss), to_sd(grads), to_sd(new)


def _one_process(cfg, weights, batch, tmp_path, noise=None, rnd=None):
    """The port's one-process accumulation (no group): loss and gradients."""
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3), cfg,
                       load_data=False, save_model=False, device="cpu")
    t.init_model()
    t.model.load_state_dict(weights)
    t.make_optimizer(LR)
    E, layers, data = t._device_batch(*batch)
    loss = t._accumulate_grads(data, E, layers,
                               noise=None if noise is None else torch.from_numpy(noise),
                               rnd_normal=None if rnd is None else torch.from_numpy(rnd))
    return float(loss), {k: p.grad.detach().clone() for k, p in t.model.named_parameters()}


def _check_grads(got, want, tol, floor=0.0):
    G = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        err = float((got[k] - w).abs().max()) / (float(w.abs().max()) + floor * G)
        assert err <= tol, f"{k}: {err:.3g}"


@pytest.mark.parametrize("model", [1, 2], ids=["data2", "data2xmodel2"])
def test_mesh_step_matches_jax_and_one_process(model, tmp_path):
    """A step on 2 data ranks (DDP) or data 2 x model 2 (FSDP2) against
    JAX's step on the same mesh shape (make_mesh + shard_params_tp), same
    weights, injected noise and sigmas; then the same ranks' step with the
    trainer's own draws against the port's one process.  A ragged batch of
    5 rows is padded to 6 by repeating its last row, and the repeats count
    in the loss, as in JAX (trainer.py:433-440 discards n_real): the ranks'
    step equals one process's on the padded 6 rows.  A checkpoint of the
    ranks' trainer (rank 0 writes; FSDP2's shards gathered) restores its
    weights and Adam state whole."""
    cfg = _cfg()
    shapes = jax.eval_shape(JaxModel(dict(cfg), n_steps=10).init, jax.random.PRNGKey(0))
    params = random_params(shapes, seed=0)
    weights = params_to_state_dict(params, cfg)
    data, E, layers = fake_batch(cfg, batch=4, seed=1)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(4).astype(np.float32)
    rdata, rE, rlayers = fake_batch(cfg, batch=5, seed=4)
    padded, _ = tmesh.pad_batch_to_multiple((rE, rlayers, rdata), 2)
    rnoise = rng.standard_normal(padded[2].shape).astype(np.float32)
    rrnd = rng.standard_normal(6).astype(np.float32)
    world = 2 * model
    outs = run_ranks("step", world, tmp_path, dict(
        cfg=cfg, weights=weights, lr=LR, model=model, E=E, layers=layers, data=data,
        noise=noise, rnd=rnd,
        ragged=dict(E=rE, layers=rlayers, data=rdata, noise=rnoise, rnd=rrnd)))
    out = outs[0]
    assert out["wrapper"] == ("DistributedDataParallel" if model == 1
                              else "FSDPCaloDiffusionNet")
    assert out["local_rows"] == 2
    assert all(o["resumed_equal"] for o in outs)  # FSDP2's shards saved and restored whole
    for o in outs[1:]:  # every rank holds the same step
        assert o["loss"] == out["loss"]
        for k, v in o["params"].items():
            assert torch.equal(v, out["params"][k]), k

    want_loss, want_grads, want_params = _jax_mesh_step(
        cfg, params, (data, E, layers), noise, rnd, data=2, model=model)
    assert np.isclose(out["loss"], want_loss, rtol=1e-4, atol=1e-5)
    _check_grads(out["grads"], want_grads, 5e-4, floor=1e-3)
    for k, w in want_params.items():
        assert float((out["params"][k] - w).abs().max()) <= 2e-4, k
    # Adam's first step moves an entry by about LR, so the 2e-4 bound alone
    # would pass a wrong update: the update itself must be JAX's, in norm
    # (an entry whose gradient is at roundoff may step the other way)
    update = {k: w - weights[k] for k, w in want_params.items()}
    assert max(float(u.abs().max()) for u in update.values()) >= 0.5 * LR
    diff = sum(float(((out["params"][k] - w) ** 2).sum()) for k, w in want_params.items())
    assert (diff / sum(float((u ** 2).sum()) for u in update.values())) ** 0.5 <= 0.02

    one_loss, one_grads = _one_process(cfg, weights, (E, layers, data), tmp_path)
    assert _relerr(out["drawn_loss"], one_loss) <= 1e-6
    _check_grads(out["drawn_grads"], one_grads, 1e-5, floor=1.0)
    one_loss, one_grads = _one_process(cfg, weights, padded, tmp_path, rnoise, rrnd)
    assert _relerr(out["ragged_loss"], one_loss) <= 1e-6
    _check_grads(out["ragged_grads"], one_grads, 1e-5, floor=1.0)


def test_jax_pads_a_ragged_train_batch_by_repeating_its_last_row(tmp_path):
    """The reference behaviour the port keeps: JAX's trainer pads a ragged
    batch to a multiple of its devices with copies of the last row
    (trainer.py:433-440), the rows the port's ranks take."""
    cfg = _cfg()
    t = JaxTrainer(jax_flags(checkpoint_folder=str(tmp_path)), cfg, load_data=False,
                   save_model=False, mesh=jmesh.make_mesh(data=2, devices=jax.devices()[:2]))
    data, E, layers = fake_batch(cfg, batch=5, seed=4)
    got = [np.asarray(a) for a in t._device_batch(E, layers, data)]
    want, _ = tmesh.pad_batch_to_multiple((E, layers, data), 2)
    for g, w in zip(got, want):
        assert g.shape[0] == 6 and np.array_equal(g, w)


def test_layer_and_distillation_trainers_on_two_ranks_match_one_process(tmp_path):
    """The layer trainer (DDP around the layer net; its loss on the whitened
    layer vectors) and the distillation trainer (DDP around the student;
    the teacher's and the target's calls through it without a gradient;
    its index and noise draws the global batch's) on 2 ranks: one step's
    loss and gradients as one process's, with each trainer's own draws.
    And ``mesh.replicate`` gives every rank rank 0's weights."""
    cfg = _cfg(NSTEPS=8, CONSIS_NSTEPS=8)
    teacher = CaloDiffusion(cfg, n_steps=8, device="cpu",
                            generator=torch.Generator().manual_seed(4)).state_dict()
    data, E, layers = fake_batch(cfg, batch=4, seed=11)
    inputs = dict(cfg=cfg, teacher=teacher, E=E, layers=layers, data=data)
    outs = run_ranks("trainers", 2, tmp_path, inputs)
    want = worker.trainer_steps(inputs, None)
    torch.manual_seed(0)
    rank0 = torch.nn.Linear(3, 2).weight.detach()
    assert all(torch.equal(o["replicated"], rank0) for o in outs)  # mesh.replicate
    for name in ("layer", "distill"):
        got_loss, got = outs[0][name]
        want_loss, grads = want[name]
        assert outs[1][name][0] == got_loss
        assert got.keys() == grads.keys() and grads, name
        assert _relerr(got_loss, want_loss) <= 1e-6, name
        _check_grads(got, grads, 1e-5, floor=1.0)


@pytest.mark.parametrize("loss_type", ["l1", "l2", "mse", "huber"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_parts_give_the_loss(loss_type, masked):
    """Each loss's (numerator, denominator), which the data axis sums over
    its ranks, give the loss one process computes."""
    from calodiffusion_tpu_torch.models.losses import Loss

    rng = np.random.default_rng(12)
    pred, target = (torch.from_numpy(rng.standard_normal((4, 1, 3, 2, 2)).astype(np.float32))
                    for _ in range(2))
    weight = torch.from_numpy(rng.uniform(0.5, 2.0, (4, 1, 1, 1, 1)).astype(np.float32)) \
        * torch.ones_like(pred)
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0]) if masked else None
    num, den = Loss._parts(loss_type)(pred, target, weight, mask=mask)
    want = Loss._loss(loss_type)(pred, target, weight, mask=mask)
    torch.testing.assert_close(num / den, want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# gradient accumulation, save and restore: dryrun_multichip's accum loop
# ---------------------------------------------------------------------------

def test_accumulation_resume_replays_and_all_reduces_once_a_step(tmp_path):
    """2 ranks, TRAIN_MICROBATCH 4 on a global batch of 8 (2 chunks, 2 rows
    a rank each): 3 steps, a checkpoint, 2 steps, the checkpoint restored
    and the 2 steps replayed from the same draws give the same losses
    (rtol 1e-6, as __graft_entry__.py:250 holds JAX) and weights (1e-6);
    the chunks but the last run under no_sync, so DDP's comm hook runs once
    a step (the model fills one bucket)."""
    cfg = _cfg(TRAIN_MICROBATCH=4, CHECKPOINT_NAME="accum")
    weights = params_to_state_dict(random_params(jax.eval_shape(
        JaxModel(dict(cfg), n_steps=10).init, jax.random.PRNGKey(0)), seed=5), cfg)
    data, E, layers = fake_batch(cfg, batch=8, seed=6)
    outs = run_ranks("accum", 2, tmp_path, dict(cfg=cfg, weights=weights, lr=1e-3, E=E,
                                                  layers=layers, data=data))
    for o in outs:
        assert o["local_rows"] == 4 and o["comm_hook_calls"] == 7
        np.testing.assert_allclose(o["replay"], o["tail"], rtol=1e-6, atol=1e-7)
        for k, v in o["tail_params"].items():
            assert float((o["replay_params"][k] - v).abs().max()) <= 1e-6, k
        assert np.isfinite(o["warm"]).all()
    assert outs[0]["tail"] == outs[1]["tail"]


# ---------------------------------------------------------------------------
# the training CLI on two ranks
# ---------------------------------------------------------------------------

def _write_cache(folder, name, rows, cfg, seed):
    data, E, layers = fake_batch(cfg, batch=rows, seed=seed)
    np.savez_compressed(os.path.join(folder, f"{name}.npz"), E=E, layers=layers,
                        showers=data)


def test_two_rank_cli_training_matches_one_process(tmp_path):
    """training.main under torchrun's variables on 2 gloo ranks, from npz
    caches (16 train events, batch 4; 5 val events, so the last val batch
    of 1 is padded to 2 and its repeat masked out, JAX trainer.py:548-560):
    rank 0's loss histories equal the one-process CLI's (f32, 1e-6
    relative), and so do its final weights and EMA, in the norm of the
    whole tree, as tests/test_multiprocess.py holds JAX's updated weights
    (Adam's first steps move an entry by about lr whatever the size of its
    gradient, so an entry whose gradient is near roundoff moves by lr times
    roundoff's sign); rank 1 writes no file.  Widths 16: at 8, each
    GroupNorm group holds one channel and the conv biases ahead of it get a
    gradient that is roundoff alone."""
    data = tmp_path / "data"
    data.mkdir()
    cfg = _cfg(BATCH=4, MAXEPOCH=2, EMA_DECAY=0.9, CHECKPOINT_NAME="cli",
               LAYER_SIZE_UNET=[16, 16, 16, 16], FILES=["train.hdf5"], VAL_FILES=["val.hdf5"])
    _write_cache(data, "train.hdf5", 16, cfg, 7)
    _write_cache(data, "val.hdf5", 5, cfg, 8)
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    inputs = dict(config_path=str(tmp_path / "config.json"), data=str(data) + "/")
    outs = run_ranks("cli", 2, tmp_path, inputs)
    assert not any(o["initialized_after"] for o in outs)
    assert not os.path.exists(tmp_path / "ckpt_1")

    from calodiffusion_tpu_torch import training
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    one = training.main(["-c", inputs["config_path"], "-d", inputs["data"], "--checkpoint",
                         str(tmp_path / "one"), "--seed", "2", "--device", "cpu", "diffusion"])
    got, got_host = ckpt_io.load_checkpoint(outs[0]["checkpoint_folder"], "final")
    want, want_host = ckpt_io.load_checkpoint(one.checkpoint_folder, "final")
    for key in ("params", "ema_params"):
        assert got[key].keys() == want[key].keys()
        diff = sum(float(((got[key][k] - w) ** 2).sum()) for k, w in want[key].items())
        norm = sum(float((w ** 2).sum()) for w in want[key].values())
        assert (diff / norm) ** 0.5 <= 1e-6, key
    for hist in ("train_loss_hist", "val_loss_hist"):
        assert got_host[hist].keys() == want_host[hist].keys() == {0, 1}
        for e, w in want_host[hist].items():
            assert _relerr(got_host[hist][e], w) <= 1e-6, (hist, e)


# ---------------------------------------------------------------------------
# sharded sampling: generation, the sampler's draws and noise table, the cascade
# ---------------------------------------------------------------------------

def test_sharded_generation_and_cascade_match_one_process(tmp_path):
    """Two ranks each sample their contiguous rows of one batch of 4
    (generate with DDim, DDPM with its draws and from a noise table, the
    cascade's two stages), invert them and write gen_<rank>.h5; the files
    concatenated equal the one-process file (test_multiprocess.py:100-190's
    bounds), and the samples' rows equal one process's."""
    import h5py

    cfg = _cfg(NSTEPS=8)
    model = CaloDiffusion(cfg, n_steps=8, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    layer_model = LayerDiffusion(cfg, n_steps=8, device="cpu",
                                 generator=torch.Generator().manual_seed(1))
    _, E, layers = fake_batch(cfg, batch=4, seed=9)
    table = np.random.default_rng(10).standard_normal((3, 4, 1, 45, 16, 9)).astype(np.float32)
    inputs = dict(cfg=cfg, weights=model.state_dict(), layer_weights=layer_model.state_dict(),
                  E=E, layers=layers, noise_table=table)
    outs = run_ranks("generate", 2, tmp_path, inputs)
    torch.set_num_threads(1)  # as the ranks run: the CPU convs' sums split by thread
    want = worker.generate(inputs, str(tmp_path), None, "single", CaloDiffusion,
                           LayerDiffusion, write_out)
    torch.set_num_threads(2)
    for key in ("ddpm_drawn", "ddpm_table"):
        got = torch.cat([o[key] for o in outs])
        torch.testing.assert_close(got, want[key], rtol=1e-4, atol=1e-5)
    assert [o["table_rows_used"] for o in outs] == [want["table_rows_used"]] * 2
    for name in ("gen", "gen_cascade"):
        with h5py.File(tmp_path / f"{name}_single.h5") as f:
            showers, energies = f["showers"][:], f["incident_energies"][:]
        parts = []
        for r in range(2):
            with h5py.File(tmp_path / f"{name}_{r}.h5") as f:
                parts.append((f["showers"][:], f["incident_energies"][:]))
        assert [p[0].shape[0] for p in parts] == [2, 2]
        np.testing.assert_allclose(np.concatenate([p[1] for p in parts]), energies, rtol=1e-6)
        np.testing.assert_allclose(np.concatenate([p[0] for p in parts]), showers, rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the loader's rank: the node, not the rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nodes", [1, 2])
def test_loader_splits_files_by_node(nodes, tmp_path):
    """On one node (2 ranks) both ranks read the one-process batches, which
    the trainer splits; on 2 nodes of one rank each (LOCAL_WORLD_SIZE 1)
    the files split as JAX's NpzDataset(process_index, process_count)
    splits them (data/loader.py:61-62); the trainer then agrees each
    epoch's batch count, the least of every rank's (``mesh.agree_min``)."""
    from calodiffusion_tpu.data.loader import NpzDataset as JaxNpzDataset

    cfg = _cfg(BATCH=4, FILES=["a.hdf5", "b.hdf5"])
    for i, name in enumerate(("a.hdf5", "b.hdf5")):
        _write_cache(tmp_path, name, 8, cfg, 20 + i)
    inputs = dict(cfg=cfg, data=str(tmp_path) + "/")
    env = {"LOCAL_WORLD_SIZE": "1"} if nodes == 2 else {}
    outs = run_ranks("loader", 2, tmp_path, inputs, env=env)
    one, _ = load_data(default_flags(data_folder=inputs["data"]), cfg)
    for r, o in enumerate(outs):
        assert o["process_index"] == ((0, 1) if nodes == 1 else (r, 2))
        assert o["agreed"] == 3  # mesh.agree_min: the least batch count of every rank
        if nodes == 1:
            want = [b[0] for b in one]
        else:
            jax_split = JaxNpzDataset(one.files, 4, process_index=r, process_count=2)
            assert o["files"] == list(jax_split.files)
            want = [b[0] for b in NpzDataset(one.files, 4, process_index=r, process_count=2)]
        assert len(o["train"]) == len(want)
        for g, w in zip(o["train"], want):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# TRACE_DIR: the second epoch's trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traced", [True, False])
def test_trace_dir_traces_the_second_epoch(traced, tmp_path):
    """A 2-epoch tiny run with TRACE_DIR writes one trace (of the second
    epoch, JAX trainer.py:503-516); without it, none."""
    trace_dir = tmp_path / "trace"
    cfg = _cfg(BATCH=2, MAXEPOCH=2, **({"TRACE_DIR": str(trace_dir)} if traced else {}))
    batches = [(E, layers, data) for data, E, layers in [fake_batch(cfg, batch=2, seed=30)]]
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path / "ck"), seed=3), cfg,
                       save_model=False, device="cpu", loader_train=batches)
    t.train()
    found = [str(p) for p in tmp_path.rglob("*.pt.trace.json")]
    if traced:
        assert len(found) == 1 and found[0].startswith(str(trace_dir)), found
        events = json.loads(open(found[0]).read())["traceEvents"]
        assert any("aten::" in str(e.get("name", "")) for e in events)
    else:
        assert found == []
