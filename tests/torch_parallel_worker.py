"""One rank of the port's multi-process tests (tests/test_torch_port_parallel.py).

    python tests/torch_parallel_worker.py <mode> <rank> <world> <port> <folder>

Joins a gloo process group of ``world`` ranks over localhost (the "cli" mode
leaves that to ``training.main``, from torchrun's environment variables),
reads ``<folder>/inputs.pt`` written by the test, runs one mode on the CPU
and writes ``<folder>/out_<rank>.pt``.  It imports torch and the port only.

- step      one train step on a ("data", "model") mesh: with injected noise
            and sigmas (loss, gradients, the parameters after Adam), then
            with the trainer's own draws from the same weights, then on a
            ragged batch
- accum     TRAIN_MICROBATCH steps: 3, a checkpoint, 2, a restore, the 2
            replayed; the DDP comm hook's calls counted
- cli       training.main under torchrun's environment
- generate  sharded generate, DDPM sample (drawn and from a noise table) and
            the cascade's generate; the h5 files gen_<rank>.h5 and
            gen_cascade_<rank>.h5
- loader    the batches data/loader.load_data gives this rank
- trainers  one step of the layer model's and of distillation's trainer,
            with their own draws
- distill   distillation on a ("data", "model") mesh: a step with injected
            indices and noise from a student and a target of their own, a
            step with the trainer's own draws, a checkpoint restored
"""

from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from calodiffusion_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from calodiffusion_tpu_torch.utils.config import default_flags  # noqa: E402


def _trainer(inp, mesh, folder, save_model=False):
    from calodiffusion_tpu_torch.train.trainer import TrainDiffusion

    t = TrainDiffusion(default_flags(checkpoint_folder=folder, seed=3), inp["cfg"],
                       load_data=False, save_model=save_model, device="cpu", mesh=mesh)
    t.init_model()
    t.model.load_state_dict(mesh_lib.shard_like(inp["weights"], t.model.state_dict()))
    t.make_optimizer(inp["lr"])
    return t


def _copy(tree):
    """A copy of a state (FSDP2's DTensors gathered whole): a state_dict's
    tensors are the live parameters, which later steps and loads move."""
    return {k: v.detach().clone() for k, v in mesh_lib.full_state(tree).items()}


def _grads(t):
    return _copy({k: p.grad for k, p in t.model.named_parameters()})


def _step(mesh, t, batch, noise=None, rnd=None):
    """(loss, gradients) of one accumulation on this rank's rows of ``batch``."""
    E, layers, data = t._device_batch(*batch)
    noise, rnd = (None if a is None else mesh_lib.shard_batch(mesh, torch.from_numpy(a))
                  for a in (noise, rnd))
    loss = t._accumulate_grads(data, E, layers, noise=noise, rnd_normal=rnd)
    return float(mesh_lib.all_reduce_mean(mesh, loss)), _grads(t)


def mode_step(rank, world, folder, inp):
    mesh = mesh_lib.make_mesh(data=world // inp["model"], model=inp["model"],
                              device_type="cpu")
    t = _trainer(inp, mesh, folder)
    batch = (inp["E"], inp["layers"], inp["data"])
    out = {}
    out["loss"], out["grads"] = _step(mesh, t, batch, inp["noise"], inp["rnd"])
    t._apply_update()
    out["params"] = _copy(t.model.state_dict())
    live = t.model.state_dict()
    t.model.load_state_dict(mesh_lib.shard_like(inp["weights"], live))
    out["drawn_loss"], out["drawn_grads"] = _step(mesh, t, batch)
    if "ragged" in inp:
        r = inp["ragged"]
        out["ragged_loss"], out["ragged_grads"] = _step(
            mesh, t, (r["E"], r["layers"], r["data"]), r["noise"], r["rnd"])
    out["wrapper"] = type(t._wrapped).__name__
    out["local_rows"] = t._device_batch(*batch)[0].shape[0]
    out["resumed_equal"] = _resumes(inp, mesh, t, folder)
    return out


def _resumes(inp, mesh, t, folder, make=_trainer):
    """Whether a checkpoint of ``t`` (rank 0's file; FSDP2's shards gathered)
    restores its weights, its EMA (distillation's target: in the target
    network, as the next step meets it) and its Adam state whole into a
    fresh trainer from ``make``."""
    from calodiffusion_tpu_torch.train.schedulers import EarlyStopper, ReduceLROnPlateau

    def sched():
        return ReduceLROnPlateau(inp["lr"]), EarlyStopper(patience=3, mode="val_loss")

    def weights(x):
        ema = x.ema_params
        if getattr(x, "_target", None) is not None:
            ema = x._target_network().state_dict()
        return [_copy(x.model.state_dict())] + ([] if ema is None else [_copy(ema)])

    t.save_model = True
    t._save("checkpoint", 0, {0: 1.0}, {0: 1.0}, *sched())
    fresh = make(inp, mesh, folder)
    fresh.pickup_checkpoint(*sched(), restart_training=False)
    want, got = ((weights(x), mesh_lib.full_state(x.opt.state_dict()["state"]))
                 for x in (t, fresh))
    return len(want[0]) == len(got[0]) and all(
        torch.equal(v, b[k]) for a, b in zip(want[0], got[0]) for k, v in a.items()) and all(
        torch.equal(v, got[1][i][k]) for i, st in want[1].items() for k, v in st.items())


def mode_accum(rank, world, folder, inp):
    from torch.distributed.algorithms.ddp_comm_hooks.default_hooks import allreduce_hook

    from calodiffusion_tpu_torch.train.schedulers import EarlyStopper, ReduceLROnPlateau

    mesh = mesh_lib.make_mesh(device_type="cpu")
    t = _trainer(inp, mesh, folder, save_model=True)
    calls = []

    def counted(state, bucket):
        calls.append(1)
        return allreduce_hook(state, bucket)

    t._wrapped.register_comm_hook(mesh_lib.data_group(mesh), counted)
    E, layers, data = t._device_batch(inp["E"], inp["layers"], inp["data"])

    def steps(n):
        return [float(mesh_lib.all_reduce_mean(mesh, t.train_step(data, E, layers)))
                for _ in range(n)]

    sched, stop = ReduceLROnPlateau(inp["lr"]), EarlyStopper(patience=3, mode="val_loss")
    out = {"warm": steps(3)}
    t._save("checkpoint", 0, {0: 1.0}, {0: 1.0}, sched, stop)
    draws = t.generator.get_state()
    out["tail"] = steps(2)
    out["tail_params"] = _copy(t.model.state_dict())
    t.pickup_checkpoint(sched, stop, restart_training=False)
    t.generator.set_state(draws)
    out["replay"] = steps(2)
    out["replay_params"] = _copy(t.model.state_dict())
    out["comm_hook_calls"] = len(calls)
    out["local_rows"] = data.shape[0]
    return out


def mode_cli(rank, world, folder, inp):
    from calodiffusion_tpu_torch import training

    ckpt = os.path.join(folder, f"ckpt_{rank}")
    trainer = training.main(["-c", inp["config_path"], "-d", inp["data"], "--checkpoint", ckpt,
                             "--seed", "2", "--device", "cpu", "diffusion"])
    return {"checkpoint_folder": trainer.checkpoint_folder,
            "initialized_after": dist.is_initialized()}


def mode_generate(rank, world, folder, inp):
    from calodiffusion_tpu_torch.inference import write_out
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
    from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion

    mesh = mesh_lib.make_mesh(device_type="cpu")
    return generate(inp, folder, mesh, f"{rank}", CaloDiffusion, LayerDiffusion, write_out)


def generate(inp, folder, mesh, tag, CaloDiffusion, LayerDiffusion, write_out):
    """Every sharded sampling path on ``mesh`` (None: one process); the h5
    files gen_<tag>.h5 and gen_cascade_<tag>.h5.  The test runs it in one
    process too."""
    cfg = inp["cfg"]
    loader = [(inp["E"], inp["layers"], None)]
    E_t, lay_t = torch.from_numpy(inp["E"]), torch.from_numpy(inp["layers"])
    m = CaloDiffusion(cfg, n_steps=cfg["NSTEPS"], device="cpu")
    m.load_state_dict(inp["weights"])
    out = {}
    showers, energies = m.generate(loader, 3, generator=torch.Generator().manual_seed(11),
                                   mesh=mesh)
    write_out(os.path.join(folder, f"gen_{tag}.h5"), None, cfg, showers, energies)
    ddpm = m.make_sampler("DDPM")
    out["ddpm_drawn"] = m.sample(E_t, lay_t, 3, torch.Generator().manual_seed(12),
                                 sampler=ddpm, mesh=mesh)
    ddpm.set_noise_table(inp["noise_table"])
    out["ddpm_table"] = m.sample(E_t, lay_t, 3, torch.Generator().manual_seed(13),
                                 sampler=ddpm, mesh=mesh)
    out["table_rows_used"] = ddpm.noise_draws
    lm = LayerDiffusion(cfg, n_steps=cfg["NSTEPS"], device="cpu")
    lm.load_state_dict(inp["layer_weights"])
    showers, energies = lm.generate(loader, 3, generator=torch.Generator().manual_seed(14),
                                    mesh=mesh)
    write_out(os.path.join(folder, f"gen_cascade_{tag}.h5"), None, cfg, showers, energies)
    return out


def mode_loader(rank, world, folder, inp):
    from calodiffusion_tpu_torch.data.loader import load_data

    train, val = load_data(default_flags(data_folder=inp["data"]), inp["cfg"])
    return {"train": [b[0] for b in train], "files": list(train.files),
            "process_index": mesh_lib.process_index(),
            "agreed": mesh_lib.agree_min(mesh_lib.make_mesh(device_type="cpu"), 3 + rank)}


def trainer_steps(inp, mesh):
    """(loss, gradients) of one step of the layer trainer (layer net, whitened
    layers) and of the distillation trainer, each from its seeded init, with
    the trainers' own draws, on this rank's rows of the batch (all of them
    without a mesh)."""
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
    from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel

    batch = (inp["E"], inp["layers"], inp["data"])
    out = {}
    for name, make in (
            ("layer", lambda: TrainLayerModel(default_flags(seed=3), inp["cfg"],
                                              load_data=False, save_model=False, device="cpu",
                                              loader_train=[batch], mesh=mesh)),
            ("distill", lambda: TrainDistillation(default_flags(seed=3), inp["cfg"],
                                                  teacher_params=inp["teacher"],
                                                  load_data=False, save_model=False,
                                                  device="cpu", mesh=mesh))):
        t = make()
        t.init_model()
        t.make_optimizer(1e-4)
        E, layers, data = t._device_batch(*batch)
        loss = t.train_step(data, E, layers)
        out[name] = (float(mesh_lib.all_reduce_mean(mesh, loss)),
                     {k: p.grad.detach().clone() for k, p in t.model.named_parameters()
                      if p.grad is not None})
    return out


def mode_trainers(rank, world, folder, inp):
    mesh = mesh_lib.make_mesh(device_type="cpu")
    out = trainer_steps(inp, mesh)
    torch.manual_seed(rank)  # rank 0's weights, broadcast
    out["replicated"] = mesh_lib.replicate(mesh, torch.nn.Linear(3, 2)).weight.detach()
    return out


def _distiller(inp, mesh, folder):
    from calodiffusion_tpu_torch.train.train_distill import TrainDistillation

    t = TrainDistillation(default_flags(checkpoint_folder=folder, seed=3), inp["cfg"],
                          teacher_params=inp["teacher"], load_data=False, save_model=False,
                          device="cpu", mesh=mesh)
    t.init_model()
    t.make_optimizer(inp["lr"])
    return t


def distill_steps(inp, mesh, folder):
    """Distillation on ``mesh`` (None: one process), each trainer from
    ``inp["teacher"]``: whether student and target start as the teacher;
    one step (loss, student gradients, student and target after it) from
    ``inp``'s student and target with its indices and noise; one step of a
    fresh trainer with its own draws; and whether a checkpoint of the
    first trainer (rank 0 writes; the shards gathered) restores student,
    target and Adam state whole, the target network holding the restored
    EMA."""
    t = _distiller(inp, mesh, folder)
    out = {"wrapper": type(t._wrapped).__name__ if t._wrapped is not None else None,
           "sharded_target": t._target is not None}
    start = [_copy(t.model.state_dict()), _copy(t.ema_params)]
    out["started_as_teacher"] = all(torch.equal(s[k], v) for s in start
                                    for k, v in inp["teacher"].items())
    live = t.model.state_dict()
    t.model.load_state_dict(mesh_lib.shard_like(inp["student"], live))
    t.ema_params = {k: v.clone() for k, v in mesh_lib.shard_like(inp["target"], live).items()}
    batch = t._device_batch(inp["E"], inp["layers"], inp["data"])
    idx, noise = (mesh_lib.shard_batch(mesh, torch.from_numpy(inp[k])) for k in ("idx", "noise"))
    loss = t.train_step(batch[2], batch[0], batch[1], idx=idx, noise=noise)
    out["loss"] = float(mesh_lib.all_reduce_mean(mesh, loss))
    out["grads"], out["params"], out["ema"] = (
        _grads(t), _copy(t.model.state_dict()), _copy(t.ema_params))

    fresh = _distiller(inp, mesh, folder)
    loss = fresh.train_step(batch[2], batch[0], batch[1])
    out["drawn_loss"] = float(mesh_lib.all_reduce_mean(mesh, loss))
    out["drawn_grads"] = _grads(fresh)
    out["resumed_equal"] = _resumes(inp, mesh, t, folder, make=_distiller)
    return out


def mode_distill(rank, world, folder, inp):
    mesh = mesh_lib.make_mesh(data=world // inp["model"], model=inp["model"],
                              device_type="cpu")
    return distill_steps(inp, mesh, folder)


MODES = {"step": mode_step, "accum": mode_accum, "cli": mode_cli, "generate": mode_generate,
         "loader": mode_loader, "trainers": mode_trainers, "distill": mode_distill}


def main(argv):
    mode, rank, world, port, folder = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    if mode == "cli":  # training.main joins the group from torchrun's variables
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          MASTER_ADDR="localhost", MASTER_PORT=port)
        out = MODES[mode](rank, world, folder, inp)
    else:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world)
        try:
            out = MODES[mode](rank, world, folder, inp)
        finally:
            dist.destroy_process_group()
    torch.save(out, os.path.join(folder, f"out_{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
