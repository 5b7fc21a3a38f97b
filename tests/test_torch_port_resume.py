"""Resuming a checkpoint whose EMA key set differs from the live config, in
both packages at trainer level on the CPU (ROADMAP Queue 3): a widths-8 ds2
config is saved with EMA on or off and resumed with the other setting.  For
each package the test records whether Adam's state came back, whether the
"optimizer state NOT restored" warning was printed, what ``ema_params``
holds after the restore and after one train step, and what
``load_for_inference`` serves from the resumed run's final checkpoint (the
live EMA, the checkpoint's, or another); the
port must give the JAX package's record, and the JAX package's record is
pinned (trainer.py:128-160, :407-411, checkpoint.py:113-120)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.train import schedulers as jsched
from calodiffusion_tpu.train.trainer import TrainDiffusion as JaxTrainer
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.train import schedulers as tsched
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config


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

# (EMA_DECAY of the saved run, of the resumed run) -> the JAX package's record
CASES = {
    "ema_on_checkpoint_without": ((0.0, 0.99), dict(
        adam_restored=False, warned=True, ema="pre-restore", ema_after_step="moved",
        served="ema")),
    "ema_off_checkpoint_with": ((0.99, 0.0), dict(
        adam_restored=False, warned=True, ema="checkpoint", ema_after_step="frozen",
        served="checkpoint")),
}
WARNING = "optimizer state NOT restored"


def _cfg(ema):
    return tiny_ds2_config(BATCH=2, LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16,
                           CHECKPOINT_NAME="resume", EMA_DECAY=ema, PRECISION="f32")


def _classify(tree, candidates):
    """The name of the candidate tree that ``tree`` equals, else "other"."""
    for name, cand in candidates.items():
        if cand is not None and all(np.array_equal(a, b) for a, b in zip(tree, cand)):
            return name
    return "other"


def _jax_record(tmp_path, save_ema, live_ema, capsys):
    def trainer(ema, seed, **flags):
        """``init_model`` with seeded numpy weights in place of flax's eager
        init (tens of seconds on the CPU)."""
        t = JaxTrainer(jax_flags(checkpoint_folder=str(tmp_path), seed=seed, **flags),
                       _cfg(ema), load_data=False)
        t.model = JaxModel(_cfg(ema), n_steps=t.config["NSTEPS"], loss_type="l2")
        t.params = jax.tree_util.tree_map(jnp.asarray, random_params(
            jax.eval_shape(t.model.init, jax.random.PRNGKey(0)), seed=seed))
        t._init_aux_params()
        t.opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
        t.opt_state = jax.jit(t.opt.init)(t.params)
        return t

    def leaves(tree):
        return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]

    def tree_map(fn, *trees):  # one compile, not one a leaf
        return jax.jit(lambda *ts: jax.tree_util.tree_map(fn, *ts))(*trees)

    sched, stop = jsched.ReduceLROnPlateau(1e-3), jsched.EarlyStopper(patience=3, mode="val_loss")
    t = trainer(save_ema, 1)
    _, t.opt_state = jax.jit(t.opt.update)(tree_map(jnp.ones_like, t.params), t.opt_state,
                                           t.params)  # Adam's count 1, moments nonzero
    t.params = tree_map(lambda p: p + 1.0, t.params)
    if t.ema_params is not None:
        t.ema_params = tree_map(lambda p: p * 0.0 + 7.0, t.params)
    saved = {"checkpoint": leaves(t.ema_params) if t.ema_params is not None else None}
    t._save("checkpoint", 0, {0: 1.0}, {0: 1.0}, sched, stop)

    t2 = trainer(live_ema, 2)
    cands = dict(saved, **{"pre-restore": leaves(t2.params)})
    capsys.readouterr()
    t2.pickup_checkpoint(sched, stop, restart_training=False)
    rec = dict(adam_restored=int(t2.opt_state.inner_state[0].count) == 1,
               warned=WARNING in capsys.readouterr().out,
               ema=None if t2.ema_params is None else _classify(leaves(t2.ema_params), cands))
    before = leaves(t2.ema_params)
    data, E, layers = fake_batch(_cfg(0.0), batch=2, seed=3)
    train_step, _ = t2._make_train_step()
    t2.params, t2.opt_state, t2.ema_params, _ = train_step(
        t2.params, t2.opt_state, t2.ema_params, jax.random.PRNGKey(0), data, E, layers)
    rec["ema_after_step"] = ("frozen" if all(np.array_equal(a, b) for a, b in
                                             zip(leaves(t2.ema_params), before)) else "moved")
    t2._save("final", 1, {}, {}, sched, stop)
    t3 = trainer(live_ema, 4, model_loc=f"{t2.checkpoint_folder}/final.ckpt")
    _, served = t3.load_for_inference()
    rec["served"] = _classify(leaves(served), dict(cands, ema=leaves(t2.ema_params),
                                                   trained=leaves(t2.params)))
    return rec


def _port_record(tmp_path, save_ema, live_ema, capsys):
    def trainer(ema, seed, **flags):
        t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=seed, **flags),
                           _cfg(ema), load_data=False, device="cpu")
        t.init_model()
        t.make_optimizer(1e-3)
        return t

    def leaves(sd):
        return [v.detach().numpy().copy() for v in sd.values()]

    sched, stop = tsched.ReduceLROnPlateau(1e-3), tsched.EarlyStopper(patience=3, mode="val_loss")
    t = trainer(save_ema, 1)
    for p in t.model.parameters():
        p.grad = torch.ones_like(p)
    t.opt.step()  # Adam's step 1, moments nonzero
    with torch.no_grad():
        for p in t.model.parameters():
            p.add_(1.0)
    if t.ema_params is not None:
        t.ema_params = {k: torch.full_like(v, 7.0) for k, v in t.ema_params.items()}
    saved = {"checkpoint": leaves(t.ema_params) if t.ema_params is not None else None}
    t._save("checkpoint", 0, {0: 1.0}, {0: 1.0}, sched, stop)

    t2 = trainer(live_ema, 2)
    cands = dict(saved, **{"pre-restore": leaves(t2.model.state_dict())})
    capsys.readouterr()
    t2.pickup_checkpoint(sched, stop, restart_training=False)
    state = t2.opt.state_dict()["state"]
    rec = dict(adam_restored=bool(state) and all(int(s["step"]) == 1 for s in state.values()),
               warned=WARNING in capsys.readouterr().out,
               ema=None if t2.ema_params is None else _classify(leaves(t2.ema_params), cands))
    before = leaves(t2.ema_params)
    data, E, layers = (torch.from_numpy(a) for a in fake_batch(_cfg(0.0), batch=2, seed=3))
    t2.train_step(data, E, layers)
    rec["ema_after_step"] = ("frozen" if all(np.array_equal(a, b) for a, b in
                                             zip(leaves(t2.ema_params), before)) else "moved")
    t2._save("final", 1, {}, {}, sched, stop)
    t3 = trainer(live_ema, 4, model_loc=f"{t2.checkpoint_folder}/final.ckpt")
    served = t3.load_for_inference().state_dict()
    rec["served"] = _classify(leaves(served), dict(cands, ema=leaves(t2.ema_params),
                                                   trained=leaves(t2.model.state_dict())))
    return rec


@pytest.mark.parametrize("case", list(CASES))
def test_resume_with_another_ema_setting_matches_jax(tmp_path, capsys, case):
    (save_ema, live_ema), want = CASES[case]
    jax_rec = _jax_record(tmp_path / "jax", save_ema, live_ema, capsys)
    port_rec = _port_record(tmp_path / "torch", save_ema, live_ema, capsys)
    assert jax_rec == want
    assert port_rec == jax_rec
