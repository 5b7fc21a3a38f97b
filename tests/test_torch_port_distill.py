"""calodiffusion_tpu_torch's consistency distillation against the JAX
package on the CPU, at a tiny dataset-2 configuration: the sigma grid and
the index logits, the distillation loss and one train step (student and EMA
target) from the same weights, indices and noise, the val step at fixed
normals, the config overrides, the no-teacher error and the distilled
checkpoint sampled with ``Consistency``.  Three sets of random weights
(student, target, teacher) are made with numpy from a seed; the indices
and noise are those JAX draws from its key.

Widths [8, 8, 8, 8] with 4 GroupNorm groups, so that no conv bias sits
alone in its group: a bias the normalisation cancels has a gradient of
roundoff, and Adam's first step (about lr * sign(g)) would turn that
roundoff into a difference of lr.

Tolerances (f32): the sigma grid and the index logits 1e-6 relative; the
loss 1e-4 relative; the parameters after one Adam step and the EMA target
1e-4 relative (max-norm over each tensor).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.diffusion import CaloDiffusion as JaxModel
from calodiffusion_tpu.train.train_distill import TrainDistillation as JaxDistill
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.samplers import get_sampler
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from calodiffusion_tpu_torch.train import train_distill as tdistill
from calodiffusion_tpu_torch.train.train_distill import TrainDistillation
from calodiffusion_tpu_torch.train.trainer import TrainDiffusion
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config

GRID_RTOL = 1e-6
STEP_RTOL = 1e-4


def _cfg(**kw):
    return tiny_ds2_config(**{**dict(LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16,
                                     BLOCK_GROUPS=4, NSTEPS=8, CONSIS_NSTEPS=8), **kw})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


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


def _port(cfg, teacher=None):
    t = TrainDistillation(default_flags(seed=3), dict(cfg), teacher_params=teacher,
                          load_data=False, save_model=False, device="cpu")
    t.init_model()
    return t


def _jax(cfg, teacher=None):
    return JaxDistill(jax_flags(seed=3), dict(cfg), load_data=False, save_model=False,
                      teacher_params=teacher)


@pytest.mark.parametrize("dist", ["lognormal", "uniform"])
def test_sigma_grid_and_index_logits_match_jax(dist):
    cfg = _cfg(CONSIS_NSTEPS=100, DISTILL_IDX_DIST=dist)
    jt, tt = _jax(cfg), TrainDistillation(default_flags(), dict(cfg), load_data=False,
                                          save_model=False, device="cpu")
    grid = tt._sigma_grid()
    np.testing.assert_allclose(grid, jt._sigma_grid(), rtol=GRID_RTOL, atol=0)
    assert grid.dtype == np.float32 and np.all(np.diff(grid) > 0)
    np.testing.assert_allclose(tt._idx_logits(len(grid)), jt._idx_logits(len(grid)),
                               rtol=GRID_RTOL, atol=0)


def test_overrides_and_no_teacher():
    """DISTILL_LR replaces LR; EARLYSTOP becomes DISTILL_EARLYSTOP or 10**9,
    as in the JAX trainer; training without a teacher raises its error."""
    for extra in ({}, {"DISTILL_LR": 1e-5, "DISTILL_EARLYSTOP": 7}):
        cfg = _cfg(EARLYSTOP=5, **extra)
        jt = _jax(cfg)
        tt = TrainDistillation(default_flags(), dict(cfg), load_data=False, save_model=False,
                               device="cpu")
        assert tt.config["LR"] == jt.config["LR"]
        assert tt.config["EARLYSTOP"] == jt.config["EARLYSTOP"]
    assert tt.config["LR"] == 1e-5 and tt.config["EARLYSTOP"] == 7
    tt = TrainDistillation(default_flags(seed=3), _cfg(MAXEPOCH=1), load_data=False,
                           save_model=False, device="cpu", loader_train=[], loader_val=None)
    with pytest.raises(ValueError, match="needs a teacher"):
        tt.train()


@pytest.fixture(scope="module")
def weights():
    """Student, target and teacher: three random U-Nets."""
    cfg = _cfg()
    jm = JaxModel(dict(cfg), n_steps=8)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return cfg, jm, [random_params(shapes, seed=s) for s in (0, 1, 2)]


@pytest.fixture(scope="module")
def jax_step(weights):
    """One JAX distillation step from the three weights, as
    TrainDistillation's _train_step takes it: its draws (the index from
    the logits, then the noise), value_and_grad of its _distill_loss_fn,
    optax's Adam and the EMA target update; and its jitted val step."""
    cfg, jm, (student, target, teacher) = weights
    jt = _jax(cfg, teacher)
    # init_model's state, with the random weights in place of flax's init
    jt.model, jt.params, jt.teacher_params = jm, student, teacher
    jt.ema_decay = decay = float(cfg.get("DISTILL_TARGET_DECAY", 0.95))
    jt.opt = optax.inject_hyperparams(optax.adam)(learning_rate=float(cfg["LR"]))
    _, val_step = jt._make_train_step()
    loss_fn, n_grid = jt._distill_loss_fn()
    data, E, layers = fake_batch(cfg, batch=3, seed=4)
    key = jax.random.PRNGKey(6)
    k_i, k_n = jax.random.split(key)
    idx = jax.random.categorical(k_i, jnp.asarray(jt._idx_logits(n_grid)), shape=(3,))
    noise = jax.random.normal(k_n, data.shape, jnp.float32)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        student, target, teacher, data, E, layers, idx, noise)
    updates, _ = jt.opt.update(grads, jt.opt.init(student), student)
    new = optax.apply_updates(student, updates)
    ema = jax.tree_util.tree_map(lambda e, p: decay * e + (1 - decay) * p, target, new)
    sd = lambda t: params_to_state_dict(jax.tree_util.tree_map(np.asarray, t), cfg)  # noqa: E731
    return dict(batch=(data, E, layers), idx=np.asarray(idx), noise=np.asarray(noise),
                loss=float(loss), grads=sd(grads), new=sd(new), ema=sd(ema),
                sds=[sd(w) for w in (student, target, teacher)], val_step=val_step, jt=jt)


def test_train_step_matches_jax(weights, jax_step):
    """The loss at JAX's indices and noise (teacher Heun step, EMA target,
    pseudo-Huber, 1/(sigma_{i+1} - sigma_i)), every student gradient, then
    the student after Adam and the EMA target after its update; teacher and
    target run without gradients.

    Gradients: max |port - jax| / (max |jax| + 1e-3 G), G the largest
    gradient entry, within 5e-4 (tests/test_torch_port_train.py's bound
    for the U-Net's gradients).  Adam's first step moves an entry by
    lr * g / (|g| + eps), about lr * sign(g): an entry whose gradient is
    below 1e-4 of its tensor's largest, where the two packages' sums in
    other orders can differ in sign (5 of 75,873 entries here, each under
    3e-5 of its tensor's largest), must move by at most lr; every other
    entry, and the EMA, within 1e-4 of the tensor's largest."""
    cfg = weights[0]
    s = jax_step
    student, target, teacher = s["sds"]
    lr = float(cfg["LR"])
    tt = _port(cfg, teacher)
    assert all(torch.equal(v, teacher[k]) for k, v in tt.model.state_dict().items())
    tt.model.load_state_dict(student)
    tt.ema_params = {k: v.clone() for k, v in target.items()}
    tt.make_optimizer(lr)
    data, E, layers = (torch.from_numpy(a) for a in s["batch"])
    loss = tt.train_step(data, E, layers, idx=torch.from_numpy(s["idx"]),
                         noise=torch.from_numpy(s["noise"]))
    assert abs(loss.item() - s["loss"]) <= STEP_RTOL * abs(s["loss"])
    grads = {k: p.grad.numpy() for k, p in tt.model.named_parameters()}
    assert set(grads) == set(s["grads"])
    G = max(np.abs(w.numpy()).max() for w in s["grads"].values())
    small = 0
    for k, v in tt.model.state_dict().items():
        w = s["grads"][k].numpy()
        assert np.abs(grads[k] - w).max() / (np.abs(w).max() + 1e-3 * G) <= 5e-4, k
        robust = np.abs(w) >= STEP_RTOL * np.abs(w).max()
        small += int((~robust).sum())
        for got, want in ((v.numpy(), s["new"][k].numpy()),
                          (tt.ema_params[k].numpy(), s["ema"][k].numpy())):
            err = np.abs(got - want)
            assert err[robust].max(initial=0) <= STEP_RTOL * np.abs(want).max(), k
        assert np.abs(v.numpy() - student[k].numpy())[~robust].max(initial=0) <= lr * (1 + STEP_RTOL)
        assert not torch.equal(v, student[k]), k
    assert small <= 0.01 * sum(g.size for g in grads.values())
    # the teacher's weights are untouched
    assert all(torch.equal(v, teacher[k]) for k, v in tt.teacher_params.items())


def test_val_step_matches_jax(weights, jax_step, monkeypatch):
    """The val index clip(int(ndtr(r) (N-1)), 0, N-2) from fixed normals,
    the student its own target, the noise redrawn on every call (here
    JAX's draw from the val key), the JAX argument order (rnd, mask, key).
    Over 20,000 normals the f32 index agrees with JAX's norm.cdf index on
    every one; where u (N-1) lies within an ulp of an integer the two may
    take neighbouring grid points."""
    cfg = weights[0]
    s = jax_step
    student, _, teacher = s["sds"]
    data, E, layers = s["batch"]
    rnd = np.array([-1.3, 0.2, 1.7], np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    key = jax.random.PRNGKey(9)
    want = float(s["val_step"](s["jt"].params, jnp.asarray(data), jnp.asarray(E),
                               jnp.asarray(layers), jnp.asarray(rnd), jnp.asarray(mask), key))
    noise = np.asarray(jax.random.normal(key, data.shape, jnp.float32))
    monkeypatch.setattr(tdistill, "randn", lambda *a, **k: torch.from_numpy(noise))
    tt = _port(cfg, teacher)
    tt.model.load_state_dict(student)
    got = tt.val_step(*(torch.from_numpy(a) for a in (data, E, layers, rnd, mask))).item()
    assert abs(got - want) <= STEP_RTOL * abs(want)

    r = np.random.default_rng(10).standard_normal(20000).astype(np.float32)
    n = 8
    j_idx = np.asarray(jnp.clip((jax.scipy.stats.norm.cdf(jnp.asarray(r)) * (n - 1))
                                .astype(jnp.int32), 0, n - 2))
    t_idx = torch.clamp((torch.special.ndtr(torch.from_numpy(r)) * (n - 1)).to(torch.int32),
                        0, n - 2).numpy()
    assert np.mean(j_idx == t_idx) == 1.0


def test_distilled_checkpoint_samples_with_consistency(weights, tmp_path):
    """Distill for one epoch from a teacher checkpoint, then load final.ckpt
    as a plain diffusion checkpoint (EMA, the target, preferred) and sample
    it with Consistency."""
    cfg, _, (_, _, teacher) = weights
    cfg = dict(cfg, MAXEPOCH=1, BATCH=2)
    from calodiffusion_tpu_torch.train import checkpoint as ckpt_io

    ckpt_io.save_checkpoint(str(tmp_path / "teacher"), "final",
                            params=params_to_state_dict(teacher, cfg))
    batches = [(E, lay, d) for d, E, lay in (fake_batch(cfg, batch=2, seed=s) for s in (11, 12))]
    tt = TrainDistillation(default_flags(seed=3, checkpoint_folder=str(tmp_path)),
                           dict(cfg, TEACHER_LOC=str(tmp_path / "teacher" / "final.ckpt")),
                           device="cpu", loader_train=batches, loader_val=batches[:1])
    tt.train()
    folder = tmp_path / "tiny_ds2_Distillation"
    assert tt.checkpoint_folder == str(folder) and (folder / "final.ckpt").exists()
    inf = TrainDiffusion(default_flags(model_loc=str(folder / "final.ckpt")),
                         dict(cfg, SAMPLER="Consistency"), load_data=False, save_model=False,
                         device="cpu")
    model = inf.load_for_inference()
    assert all(torch.equal(v, tt.ema_params[k]) for k, v in model.state_dict().items())
    assert any(not torch.equal(v, tt.model.state_dict()[k]) for k, v in tt.ema_params.items())
    loader = [(E, lay, None) for E, lay, _ in batches]
    showers, energies = model.generate(loader, 2, generator=torch.Generator().manual_seed(0),
                                       sampler=get_sampler("Consistency")(model.config))
    assert showers.shape == (4, 6480) and energies.shape == (4, 1)
    assert np.isfinite(showers).all() and (showers >= 0).all()
