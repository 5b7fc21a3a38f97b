"""scripts/orbax_to_torch.py: a checkpoint of the JAX package's trainer
(Orbax), converted, resumes in the port to the JAX trainer's next step, and
serves the weights JAX's inference_params serves.  A widths-8 ds2 config,
f32, with EMA and SWA on; weights, batch, noise and sigma draws made with
numpy from a seed and fed to both sides."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.train import checkpoint as jax_ckpt
from calodiffusion_tpu.train import schedulers as jsched
from calodiffusion_tpu.train.trainer import TrainDiffusion as JaxTrainer
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATEAU_LR = 5e-4  # the LR the plateau scheduler had lowered to at the save


def _script():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(ROOT, "scripts", "orbax_to_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cfg():
    return tiny_ds2_config(BATCH=2, LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16,
                           CHECKPOINT_NAME="orbax", EMA_DECAY=0.9, SWA_START_EPOCH=0,
                           PRECISION="f32", NSTEPS=10)


def _tree_map(fn, *trees):  # one compile, not one a leaf
    return jax.jit(lambda *ts: jax.tree_util.tree_map(fn, *ts))(*trees)


def _jax_trainer(folder, **flags):
    """A JAX trainer with seeded numpy weights (flax's eager init takes tens
    of seconds on the CPU) and the optimizer its train() makes."""
    cfg = _cfg()
    t = JaxTrainer(jax_flags(checkpoint_folder=str(folder), seed=1, **flags), cfg,
                   load_data=False)
    t.model = JaxModel(cfg, n_steps=cfg["NSTEPS"], loss_type="l2")
    t.params = jax.tree_util.tree_map(jnp.asarray, random_params(
        jax.eval_shape(t.model.init, jax.random.PRNGKey(0)), seed=1))
    t._init_aux_params()
    t.opt = optax.inject_hyperparams(optax.adam)(learning_rate=float(cfg["LR"]))
    t.opt_state = jax.jit(t.opt.init)(t.params)
    return t


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The JAX trainer's checkpoint after one Adam step, the plateau LR
    lowered, EMA and SWA (swa_n 1) set apart; the JAX trainer's next step
    with injected noise and sigmas; the converted checkpoint."""
    folder = tmp_path_factory.mktemp("orbax")
    cfg = _cfg()
    t = _jax_trainer(folder)
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(1e-2 * rng.standard_normal(p.shape), jnp.float32), t.params)
    updates, t.opt_state = jax.jit(t.opt.update)(grads, t.opt_state, t.params)
    t.params = optax.apply_updates(t.params, updates)
    t.opt_state.hyperparams["learning_rate"] = jnp.asarray(PLATEAU_LR, jnp.float32)
    t.ema_params = _tree_map(lambda p: 0.9 * p, t.params)
    t.swa_params = _tree_map(lambda p: 1.1 * p, t.params)
    t.swa_n = 1
    sched = jsched.ReduceLROnPlateau(float(cfg["LR"]))
    sched.lr, sched.best, sched.num_bad_epochs = PLATEAU_LR, 0.5, 3
    stop = jsched.EarlyStopper(patience=20, mode="val_loss")
    t._save("checkpoint", 4, {4: 0.6}, {4: 0.5}, sched, stop)

    # the JAX trainer resumes and takes one step
    t2 = _jax_trainer(folder)
    t2.pickup_checkpoint(jsched.ReduceLROnPlateau(float(cfg["LR"])),
                         jsched.EarlyStopper(patience=20, mode="val_loss"), False)
    data, E, layers = fake_batch(cfg, batch=2, seed=3)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)

    @jax.jit
    def step(params, opt_state, ema):
        def loss_fn(p):
            return t2.model.compute_loss(p, jax.random.PRNGKey(0), data, E, noise=noise,
                                         layers=layers, rnd_normal=rnd)

        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = t2.opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: 0.9 * e + 0.1 * p, ema, params)
        return params, opt_state, ema, loss

    params, opt_state, ema, loss = step(t2.params, t2.opt_state, t2.ema_params)
    arrays, host = jax_ckpt.load_checkpoint(str(t.checkpoint_folder), "checkpoint")

    def sd(tree):
        return params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), cfg)

    (folder / "config.json").write_text(json.dumps(cfg))
    out = folder / "port"
    path = _script().main(["-c", str(folder / "config.json"), "--folder",
                           str(t.checkpoint_folder), "--out", str(out)])
    adam = opt_state.inner_state[0]
    return dict(cfg=cfg, out=out, path=path, jax_folder=str(t.checkpoint_folder),
                batch=(data, E, layers, noise, rnd), loss=float(loss), params=sd(params),
                ema=sd(ema), mu=sd(adam.mu), nu=sd(adam.nu), count=int(adam.count),
                served=sd(jax_ckpt.inference_params(arrays, host)), host=host)


def test_converted_checkpoint_resumes_to_the_jax_step(converted, tmp_path):
    c = converted
    assert c["path"] == str(c["out"] / "checkpoint.ckpt")
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=5,
                                     model_loc=c["path"]), c["cfg"], load_data=False,
                       save_model=False, device="cpu")
    t.init_model()
    t.make_optimizer(float(c["cfg"]["LR"]))
    sched = tsched.ReduceLROnPlateau(float(c["cfg"]["LR"]))
    stop = tsched.EarlyStopper(patience=20, mode="val_loss")
    train_hist, val_hist, start = t.pickup_checkpoint(sched, stop, restart_training=False)
    assert (train_hist, val_hist, start) == ({4: 0.6}, {4: 0.5}, 5)
    assert sched.lr == PLATEAU_LR and stop.patience == 20
    assert [g["lr"] for g in t.opt.param_groups] == [PLATEAU_LR]
    assert t.swa_n == 1
    data, E, layers, noise, rnd = (torch.from_numpy(a) for a in c["batch"])
    loss = t._accumulate_grads(data, E, layers, noise=noise, rnd_normal=rnd)
    t._apply_update()
    assert abs(loss.item() - c["loss"]) <= 2e-4 * abs(c["loss"])
    names = [k for k, _ in t.model.named_parameters()]
    state = t.opt.state_dict()["state"]
    assert all(int(state[i]["step"]) == c["count"] == 2 for i in range(len(names)))
    for i, k in enumerate(names):
        got = t.model.state_dict()[k]
        assert float((got - c["params"][k]).abs().max()) <= 2e-4, k
        assert float((t.ema_params[k] - c["ema"][k]).abs().max()) <= 2e-4, k
        for ours, theirs in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            want = c[theirs][k]
            err = float((state[i][ours] - want).abs().max())
            assert err <= 2e-4 * (float(want.abs().max()) + 1e-12), (k, ours, err)


def test_converted_checkpoint_serves_jax_inference_params(converted, tmp_path):
    """SWA over EMA over raw params, as JAX's inference_params picks them."""
    c = converted
    assert c["host"]["swa_n"] == 1
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), model_loc=c["path"]),
                       c["cfg"], load_data=False, save_model=False, device="cpu")
    served = t.load_for_inference().state_dict()
    assert served.keys() == c["served"].keys()
    for k, w in c["served"].items():
        assert torch.equal(served[k], w), k
    arrays, _ = ckpt_io.load_checkpoint(str(c["out"]), "checkpoint")
    assert set(arrays) == {"params", "opt_state", "ema_params", "swa_params"}


def test_the_port_names_the_converter_for_an_orbax_directory(converted):
    with pytest.raises(ckpt_io.ForeignCheckpointError, match="scripts/orbax_to_torch.py"):
        ckpt_io.load_checkpoint(converted["jax_folder"], "checkpoint")
