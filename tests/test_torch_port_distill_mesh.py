"""The port's consistency distillation on a mesh with a "model" axis, on the
CPU: two gloo ranks (tests/torch_parallel_worker.py, mode "distill") on
data 1 x model 2, the student sharded by FSDP2 and the teacher and the
target networks of their own sharded on the same mesh, held to JAX's
distillation step on a mesh of the same shape (the JAX trainer replicates
teacher, student and EMA there: trainer.py:156,192, train_distill.py:
109-123) and to the port's one process.

The tiny config of tests/test_torch_port_parallel.py with 4 GroupNorm
groups, as tests/test_torch_port_distill.py takes it: no conv bias sits
alone in its group, where the normalisation would cancel it and leave a
gradient of roundoff that Adam's first step turns into lr.

Bounds, as test_torch_port_parallel.py holds the diffusion step on a mesh:
against JAX the loss within rtol 1e-4, atol 1e-5, the gradients within
5e-4 of max |jax| + 1e-3 G, the student after Adam and the target after
its EMA update within 2e-4, the update within 2 % in norm; against one
process the loss within 1e-6 relative and the gradients within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.parallel import mesh as jmesh
from calodiffusion_tpu.train.train_distill import TrainDistillation as JaxDistill
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from tests import torch_parallel_worker as worker
from tests.test_torch_port_model import random_params
from tests.test_torch_port_parallel import _cfg, _check_grads, _relerr, run_ranks
from tests.utils_test import fake_batch

LR = 1e-4
DATA, MODEL = 1, 2


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


@pytest.fixture(scope="module")
def inputs():
    """Student, target and teacher (three random U-Nets), a batch of 4, its
    grid indices and noise."""
    cfg = _cfg(BLOCK_GROUPS=4, NSTEPS=8, CONSIS_NSTEPS=8)
    shapes = jax.eval_shape(JaxModel(dict(cfg), n_steps=8).init, jax.random.PRNGKey(0))
    params = [random_params(shapes, seed=s) for s in (0, 1, 2)]
    data, E, layers = fake_batch(cfg, batch=4, seed=5)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, cfg["CONSIS_NSTEPS"] - 1, 4)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    student, target, teacher = (params_to_state_dict(p, cfg) for p in params)
    return dict(cfg=cfg, lr=LR, model=MODEL, student=student, target=target, teacher=teacher,
                E=E, layers=layers, data=data, idx=idx, noise=noise, jax_params=params)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    folder = tmp_path_factory.mktemp("distill_mesh")
    inp = {k: v for k, v in inputs.items() if k != "jax_params"}
    return run_ranks("distill", DATA * MODEL, folder, inp)


@pytest.fixture(scope="module")
def one_process(inputs, tmp_path_factory):
    inp = {k: v for k, v in inputs.items() if k != "jax_params"}
    return worker.distill_steps(inp, None, str(tmp_path_factory.mktemp("distill_one")))


def _jax_mesh_step(inputs):
    """JAX's distillation step on a data 1 x model 2 mesh of its virtual
    devices: teacher, student and target replicated as its trainer places
    them, the batch over "data"; value_and_grad of ``_distill_loss_fn`` at
    the injected indices and noise, optax's Adam, the EMA target update."""
    cfg = inputs["cfg"]
    student, target, teacher = inputs["jax_params"]
    mesh = jmesh.make_mesh(data=DATA, model=MODEL, devices=jax.devices()[:DATA * MODEL])
    jt = JaxDistill(jax_flags(seed=3), dict(cfg), load_data=False, save_model=False,
                    teacher_params=teacher, mesh=mesh)
    jt.model = JaxModel(dict(cfg), n_steps=8)
    loss_fn, _ = jt._distill_loss_fn()
    decay = float(cfg.get("DISTILL_TARGET_DECAY", 0.95))
    opt = optax.adam(LR)
    rep = [jmesh.replicate(mesh, jax.tree_util.tree_map(jnp.asarray, p))
           for p in (student, target, teacher)]
    sh = jmesh.batch_sharding(mesh)
    args = [jax.device_put(jnp.asarray(inputs[k]), sh)
            for k in ("data", "E", "layers", "idx", "noise")]

    @jax.jit
    def step(p, ema, te, data, E, layers, idx, noise):
        loss, g = jax.value_and_grad(loss_fn)(p, ema, te, data, E, layers, idx, noise)
        upd, _ = opt.update(g, opt.init(p), p)
        new = optax.apply_updates(p, upd)
        ema = jax.tree_util.tree_map(lambda e, q: decay * e + (1 - decay) * q, ema, new)
        return loss, g, new, ema

    loss, grads, new, ema = step(*rep, *args)
    sd = lambda t: params_to_state_dict(jax.tree_util.tree_map(np.asarray, t), cfg)  # noqa: E731
    return float(loss), sd(grads), sd(new), sd(ema)


def test_model_axis_places_student_teacher_and_target(ranks, one_process):
    """On the model axis the student is FSDP2's and the teacher and target
    are sharded networks of their own; one process keeps its path (the
    student's network, functional_call). Both start student and target as
    the teacher."""
    for o in ranks:
        assert o["wrapper"] == "FSDPCaloDiffusionNet" and o["sharded_target"]
        assert o["started_as_teacher"]
    assert one_process["wrapper"] is None and not one_process["sharded_target"]
    assert one_process["started_as_teacher"]


def test_model_axis_step_matches_jax(inputs, ranks):
    """The ranks' step from the same student, target and teacher, indices
    and noise against JAX's step on the same mesh shape: loss, every
    student gradient, the student after Adam and the target after the EMA
    update, and the update itself in norm."""
    out = ranks[0]
    want_loss, want_grads, want_params, want_ema = _jax_mesh_step(inputs)
    assert np.isclose(out["loss"], want_loss, rtol=1e-4, atol=1e-5)
    assert out["grads"].keys() == want_grads.keys()
    _check_grads(out["grads"], want_grads, 5e-4, floor=1e-3)
    for got, want in ((out["params"], want_params), (out["ema"], want_ema)):
        for k, w in want.items():
            assert float((got[k] - w).abs().max()) <= 2e-4, k
    # Adam's first step moves an entry by about LR, so the 2e-4 bound alone
    # would pass a wrong update: the update must be JAX's, in norm
    update = {k: w - inputs["student"][k] for k, w in want_params.items()}
    assert max(float(u.abs().max()) for u in update.values()) >= 0.5 * LR
    diff = sum(float(((out["params"][k] - w) ** 2).sum()) for k, w in want_params.items())
    assert (diff / sum(float((u ** 2).sum()) for u in update.values())) ** 0.5 <= 0.02


def test_model_axis_step_matches_one_process(ranks, one_process):
    """The same injected step, and a fresh trainer's step with its own
    index and noise draws, on the ranks against the port's one process."""
    out = ranks[0]
    for loss, grads in (("loss", "grads"), ("drawn_loss", "drawn_grads")):
        assert _relerr(out[loss], one_process[loss]) <= 1e-6, loss
        assert out[grads].keys() == one_process[grads].keys()
        _check_grads(out[grads], one_process[grads], 1e-5, floor=1.0)
    for k, w in one_process["ema"].items():
        assert float((out["ema"][k] - w).abs().max()) <= 1e-6, k


def test_model_axis_ranks_agree(ranks):
    """Both ranks of the model axis hold the same losses, student and
    target."""
    first = ranks[0]
    for o in ranks[1:]:
        assert o["loss"] == first["loss"] and o["drawn_loss"] == first["drawn_loss"]
        for key in ("params", "ema"):
            for k, v in o[key].items():
                assert torch.equal(v, first[key][k]), (key, k)


def test_model_axis_checkpoint_restores_whole(ranks, one_process):
    """A checkpoint the ranks write (rank 0; every shard gathered) restores
    the student, the target (into the target network, before the next
    step) and Adam's state whole, as one process's does."""
    assert all(o["resumed_equal"] for o in ranks)
    assert one_process["resumed_equal"]
