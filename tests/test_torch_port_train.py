"""calodiffusion_tpu_torch training against the JAX package on the CPU: the
loss registry, the loss and every parameter gradient of a tiny dataset-2
model, the Adam + EMA update, TRAIN_MICROBATCH accumulation, the plateau LR
and early stop, and checkpoints.  Weights, batches, noise and sigma draws
are made with numpy from a seed and fed to both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models import losses as jlosses
from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.train import schedulers as jsched
from calodiffusion_tpu_torch.models import losses as tlosses
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train import schedulers as tsched
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config


def _cfg(**kw):
    return tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 16, 8], COND_SIZE_UNET=16,
                           BLOCK_ATTN=True, MID_ATTN=True, PRECISION="f32", **kw)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _trainer(tmp_path, cfg, **flags):
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3, **flags), cfg,
                       device="cpu")
    t.init_model()
    return t


def _loader(cfg, seeds, batch=2):
    """(E, layers, data) batches as the training loader yields them."""
    out = []
    for s in seeds:
        data, E, layers = fake_batch(cfg, batch=batch, seed=s)
        out.append((E, layers, data))
    return out


# ---------------------------------------------------------------------------
# (b) loss and every parameter gradient of a tiny ds2 model against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_loss_and_grads():
    """One JAX compile: value_and_grad of CaloDiffusion.compute_loss."""
    cfg = _cfg()
    jm = JaxModel(dict(cfg), n_steps=10, loss_type="l2")
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    data, E, layers = fake_batch(cfg, batch=2, seed=1)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(2).astype(np.float32)

    def loss(p):
        return jm.compute_loss(p, jax.random.PRNGKey(0), data, E, noise=noise,
                               layers=layers, rnd_normal=rnd)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    grads = params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads), cfg)
    return cfg, params, (data, E, layers, noise, rnd), float(value), grads


def test_loss_and_every_gradient_match_jax(jax_loss_and_grads):
    """hybrid_weight / l2 with log-normal sigma, block + mid attention, f32.
    The forward agrees within the 2e-4 weight-transfer bound of
    docs/DESIGN.md:32, so the loss agrees to ~5e-5 relative (measured);
    gradients are compared in max-norm relative to max(|jax|) + 1e-3 G (G
    the largest gradient entry), since a conv bias ahead of a one-channel
    GroupNorm group has a gradient that is zero but for roundoff."""
    cfg, params, batch, want_loss, want = jax_loss_and_grads
    data, E, layers, noise, rnd = (torch.from_numpy(a) for a in batch)
    tm = CaloDiffusion(dict(cfg), n_steps=10, loss_type="l2", device="cpu")
    tm.load_state_dict(params_to_state_dict(params, cfg))
    loss = tm.compute_loss(data, E, noise=noise, layers=layers, rnd_normal=rnd)
    loss.backward()
    assert abs(loss.item() - want_loss) <= 2e-4 * abs(want_loss)
    got = {k: p.grad.numpy() for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    G = max(np.abs(w.numpy()).max() for w in want.values())
    for k, w in want.items():
        w = w.numpy()
        err = np.abs(got[k] - w).max() / (np.abs(w).max() + 1e-3 * G)
        assert err <= 5e-4, f"{k}: {err:.3g}"


# ---------------------------------------------------------------------------
# (c) the loss registry: four objectives, four loss forms, with and without mask
# ---------------------------------------------------------------------------

def _denoise_jax(x, E=None, sigma=None, layers=None):
    return 0.5 * x + 0.3 * jnp.tanh(x) * sigma + 0.1 * E.reshape(-1, 1, 1, 1, 1)


def _denoise_torch(x, E=None, sigma=None, layers=None):
    return 0.5 * x + 0.3 * torch.tanh(x) * sigma + 0.1 * E.reshape(-1, 1, 1, 1, 1)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "mse", "huber"])
@pytest.mark.parametrize("objective", ["noise_pred", "mean_pred", "hybrid_weight", "minsnr"])
def test_loss_registry_matches_jax(objective, loss_type, masked):
    cfg = _cfg(TRAINING_OBJ=objective)
    rng = np.random.default_rng(4)
    data = rng.standard_normal((3, 1, 5, 4, 3)).astype(np.float32)
    E = rng.uniform(0.1, 1.0, (3, 1)).astype(np.float32)
    noise = rng.standard_normal(data.shape).astype(np.float32)
    rnd = rng.standard_normal(3).astype(np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if masked else None
    jl = jlosses.get_loss(objective)(cfg, 10, loss_type)
    tl = tlosses.get_loss(objective)(cfg, 10, loss_type)
    want = float(jl(_denoise_jax, jnp.asarray(data), jnp.asarray(E), jax.random.PRNGKey(0),
                    noise=jnp.asarray(noise), rnd_normal=jnp.asarray(rnd),
                    mask=None if mask is None else jnp.asarray(mask)))
    got = tl(_denoise_torch, torch.from_numpy(data), torch.from_numpy(E), None,
             noise=torch.from_numpy(noise), rnd_normal=torch.from_numpy(rnd),
             mask=None if mask is None else torch.from_numpy(mask)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_discrete_time_sigma_matches_jax():
    """Without "log" in NOISE_SCHED, sigma comes from the cosine-schedule
    table at the given time steps."""
    cfg = _cfg(NOISE_SCHED="cosine")
    data = np.zeros((4, 1, 5, 4, 3), np.float32)
    time = np.array([0, 3, 7, 9])
    jl = jlosses.get_loss("noise_pred")(cfg, 10, "l2")
    tl = tlosses.get_loss("noise_pred")(cfg, 10, "l2")
    assert tl.discrete_time and jl.discrete_time and tl.sigma_data == jl.sigma_data == 0.5
    want = np.asarray(jl.draw_sigma(jax.random.PRNGKey(0), jnp.asarray(data), time=time))
    got = tl.draw_sigma(torch.from_numpy(data), time=torch.from_numpy(time)).numpy()
    np.testing.assert_array_equal(got, want)
    drawn = tl.draw_sigma(torch.from_numpy(data), torch.Generator().manual_seed(0))
    assert drawn.shape == (4, 1, 1, 1, 1) and set(drawn.flatten().tolist()) <= set(
        (tl.sqrt_one_minus_alphas_cumprod / tl.sqrt_alphas_cumprod).tolist())


def test_unknown_loss_type_and_objective_raise():
    with pytest.raises(NotImplementedError, match="Loss type"):
        tlosses.get_loss("hybrid_weight")(_cfg(), 10, "l3")
    with pytest.raises(ValueError, match="not supported"):
        tlosses.get_loss("flow")


@pytest.mark.parametrize("objective", ["noise_pred", "mean_pred", "hybrid_weight", "minsnr"])
def test_denoise_objective_branches(objective):
    """denoise turns the network's prediction into an x0 estimate as the
    JAX package does (models/diffusion.py:307-314)."""
    tm = CaloDiffusion(_cfg(TRAINING_OBJ=objective), n_steps=10, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    data, E, layers = (torch.from_numpy(a) for a in fake_batch(tm.config, batch=2, seed=5))
    sigma = torch.tensor([0.3, 2.0]).reshape(2, 1, 1, 1, 1)
    with torch.no_grad():
        got = tm.denoise(data, E=E, sigma=sigma, layers=layers)
        s = tm.loss_function.get_scaling(sigma)
        pred = tm.net(data * s["c_in"], E, tm.do_time_embed(sigma.reshape(-1)), layers)
    want = {"noise_pred": data - sigma * pred, "mean_pred": pred}.get(
        objective, s["c_skip"] * data + s["c_out"] * pred)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_denoise_unknown_objective_raises():
    tm = CaloDiffusion(_cfg(), n_steps=10, device="cpu")
    tm.training_objective = "flow"
    data, E, layers = (torch.from_numpy(a) for a in fake_batch(tm.config, batch=2, seed=5))
    with pytest.raises(ValueError, match="Training obj"), torch.no_grad():
        tm.denoise(data, E=E, sigma=torch.ones(2, 1, 1, 1, 1), layers=layers)


# ---------------------------------------------------------------------------
# (d) Adam + EMA update against optax on the same gradients
# ---------------------------------------------------------------------------

def test_adam_and_ema_update_match_optax(tmp_path):
    """Three updates from identical parameters and gradients, the LR lowered
    before the third as the plateau scheduler does.  Update rules are
    compared on given gradients: Adam's first step is ~sign(g) * lr, which
    would amplify any reassociation noise in gradients computed apart."""
    decay, lr = 0.9, 1e-3
    t = _trainer(tmp_path, _cfg(EMA_DECAY=decay), save_model=False)
    t.make_optimizer(lr)
    params = {k: p.detach().numpy().copy() for k, p in t.model.named_parameters()}
    ema = dict(params)
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    state = opt.init(params)
    rng = np.random.default_rng(6)
    for step in range(3):
        if step == 2:
            t._set_lr(lr / 10)
            state.hyperparams["learning_rate"] = jnp.asarray(lr / 10, jnp.float32)
        grads = {k: (1e-2 * rng.standard_normal(v.shape)).astype(np.float32)
                 for k, v in params.items()}
        for k, p in t.model.named_parameters():
            p.grad = torch.from_numpy(grads[k].copy())
        t._apply_update()
        updates, state = opt.update(grads, state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        ema = {k: decay * ema[k] + (1 - decay) * params[k] for k in params}
    for k, p in t.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)
        np.testing.assert_allclose(t.ema_params[k].numpy(), ema[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (e) TRAIN_MICROBATCH: the mean of per-chunk gradients
# ---------------------------------------------------------------------------

def test_microbatch_step_matches_manual_chunking(tmp_path):
    t = _trainer(tmp_path, _cfg(TRAIN_MICROBATCH=2), save_model=False)
    data, E, layers = (torch.from_numpy(a) for a in fake_batch(t.config, batch=4, seed=7))
    rng = np.random.default_rng(8)
    noise = torch.from_numpy(rng.standard_normal(tuple(data.shape)).astype(np.float32))
    rnd = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    loss = t._accumulate_grads(data, E, layers, noise=noise, rnd_normal=rnd).item()
    got = {k: p.grad.clone() for k, p in t.model.named_parameters()}

    params = [p for _, p in t.model.named_parameters()]
    sums, losses = None, []
    for sl in (slice(0, 2), slice(2, 4)):
        chunk = t.model.compute_loss(data[sl], E[sl], noise=noise[sl], layers=layers[sl],
                                     rnd_normal=rnd[sl])
        grads = torch.autograd.grad(chunk, params)
        sums = grads if sums is None else [a + b for a, b in zip(sums, grads)]
        losses.append(chunk.item())
    whole = t.model.compute_loss(data, E, noise=noise, layers=layers, rnd_normal=rnd).item()
    assert abs(whole - loss) > 1e-6 * abs(loss)  # the batch did run in chunks
    np.testing.assert_allclose(loss, np.mean(losses), rtol=1e-6)
    for (k, _), s in zip(t.model.named_parameters(), sums):
        torch.testing.assert_close(got[k], s / 2, rtol=1e-6, atol=1e-9, msg=k)


# ---------------------------------------------------------------------------
# (f) plateau LR and early stop against the JAX classes
# ---------------------------------------------------------------------------

_METRICS = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.8, 0.80001, 0.81, 0.82, 0.83, 0.84,
            0.85, 0.7, -0.1, 0.2, 0.3, 0.4]


def test_reduce_lr_on_plateau_matches_jax():
    j, t = jsched.ReduceLROnPlateau(1e-3, patience=3), tsched.ReduceLROnPlateau(1e-3, patience=3)
    for m in _METRICS:
        assert t.step(m) == j.step(m)
        assert t.state_dict() == j.state_dict()
    u = tsched.ReduceLROnPlateau(1.0)
    u.load_state_dict(t.state_dict())
    assert u.state_dict() == t.state_dict()


@pytest.mark.parametrize("mode", ["val_loss", "diff", "loss"])
def test_early_stopper_matches_jax(mode):
    j = jsched.EarlyStopper(patience=3, mode=mode, min_delta=1e-5)
    t = tsched.EarlyStopper(patience=3, mode=mode, min_delta=1e-5)
    for m in _METRICS:
        assert t.early_stop(m) == j.early_stop(m)
        assert t.state_dict() == j.state_dict()


# ---------------------------------------------------------------------------
# (g) checkpoints: save -> resume, and the weights inference takes
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """Two epochs with EMA and SWA, then a new trainer resumes from the
    per-epoch checkpoint: params, Adam state, EMA, SWA, scheduler,
    early-stop state and histories come back."""
    cfg = _cfg(EMA_DECAY=0.9, SWA_START_EPOCH=0, MAXEPOCH=2)
    t = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=3), cfg,
                       loader_train=_loader(cfg, (1, 2)), loader_val=_loader(cfg, (3,)),
                       device="cpu")
    t.train()
    folder = tmp_path / "tiny_ds2_Diffusion"
    for name in ("checkpoint", "final"):
        for suffix in (".ckpt", "_state.json", "_training_losses.txt",
                       "_validation_losses.txt"):
            assert (folder / f"{name}{suffix}").exists()
    assert (folder / "config.json").exists() and (folder / "best_val.ckpt").exists()
    assert t.swa_n == 2

    r = TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path), seed=9, load=True), cfg,
                       device="cpu")
    r.init_model()
    r.make_optimizer(1.0)
    scheduler = tsched.ReduceLROnPlateau(1.0)
    stopper = tsched.EarlyStopper(patience=99, mode="val_loss")
    train_hist, val_hist, start = r.pickup_checkpoint(scheduler, stopper, False)

    arrays, host = ckpt_io.load_checkpoint(str(folder), "checkpoint")
    assert start == 2 and host["epoch"] == 1 and host["swa_n"] == 2
    assert list(train_hist) == [0, 1] and list(val_hist) == [0, 1]
    for k, v in t.model.state_dict().items():
        torch.testing.assert_close(r.model.state_dict()[k], v, rtol=0, atol=0)
        torch.testing.assert_close(r.ema_params[k], t.ema_params[k], rtol=0, atol=0)
        torch.testing.assert_close(r.swa_params[k], t.swa_params[k], rtol=0, atol=0)
    assert r.swa_n == 2
    so, ro = t.opt.state_dict(), r.opt.state_dict()
    assert so["param_groups"] == ro["param_groups"]
    for i, st in so["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(ro["state"][i][key], st[key], rtol=0, atol=0)
    assert scheduler.state_dict() == host["scheduler_state"]
    assert stopper.state_dict() == host["early_stop_dict"]
    assert [g["lr"] for g in r.opt.param_groups] == [scheduler.lr]


@pytest.mark.parametrize("swa_n,keys,want", [
    (1, ("params", "ema_params", "swa_params"), "swa_params"),
    (0, ("params", "ema_params", "swa_params"), "ema_params"),
    (0, ("params",), "params"),
])
def test_load_for_inference_prefers_swa_then_ema(tmp_path, swa_n, keys, want):
    cfg = _cfg()
    t = _trainer(tmp_path, cfg, save_model=False)
    base = t.model.state_dict()
    scale = {"params": 1.0, "ema_params": 2.0, "swa_params": 3.0}
    trees = {k: {n: v * scale[k] for n, v in base.items()} for k in keys}
    ckpt_io.save_checkpoint(str(tmp_path), "run", params=trees["params"],
                            ema_params=trees.get("ema_params"),
                            swa_params=trees.get("swa_params"), swa_n=swa_n)
    r = TrainDiffusion(default_flags(model_loc=str(tmp_path / "run.ckpt")), cfg,
                       save_model=False, device="cpu")
    model = r.load_for_inference()
    for n, v in model.state_dict().items():
        torch.testing.assert_close(v, trees[want][n], rtol=0, atol=0)


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(ckpt_io.CheckpointMissingError):
        ckpt_io.load_checkpoint(str(tmp_path), "checkpoint")


# ---------------------------------------------------------------------------
# (h) the trainer runs on the card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_trainer_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainDiffusion(default_flags(checkpoint_folder=str(tmp_path)), _cfg())
