"""calodiffusion_tpu_torch's layer-energy cascade against the JAX package on
the CPU, at a tiny dataset-2 configuration: ``ResNetDense``, the per-dim
whitening, ``denoise_layer``, the layer-mode loss, one ``TrainLayerModel``
step with its whitening statistics, the two-stage ``sample`` and
``generate`` from the starts JAX draws, the oracle-layers path, the
checkpoint loads and the layer trainer's val loss.  Weights, batches and
noise are made with numpy from a seed (or drawn from JAX's keys as the JAX
package draws them) and fed to both sides.

Tolerances (f32 throughout): forward passes 1e-5 relative to the output's
largest entry; the loss and one Adam step 1e-4 relative (max-norm over each
tensor); sampler trajectories evaluations x 2e-4 absolute (the
weight-transfer bound of docs/DESIGN.md:32 per network evaluation);
whitening statistics 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from calodiffusion_tpu.models.layerdiffusion import LayerDiffusion as JaxLayer
from calodiffusion_tpu.models.nn_modules import ResNetDense as JaxResNetDense
from calodiffusion_tpu.tools.torch_import import import_resnet_dense
from calodiffusion_tpu.train.train_layer_model import TrainLayerModel as JaxTrainLayer
from calodiffusion_tpu.utils.config import default_flags as jax_flags
from calodiffusion_tpu_torch.models import layerdiffusion as tlayer
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.models.layerdiffusion import LayerDiffusion
from calodiffusion_tpu_torch.models.nn_modules import ResNetDense
from calodiffusion_tpu_torch.tools.jax_import import (
    layer_params_to_state_dict,
    module_params_to_state_dict,
    params_to_state_dict,
)
from calodiffusion_tpu_torch.train import checkpoint as ckpt_io
from calodiffusion_tpu_torch.train import trainer as ttrainer
from calodiffusion_tpu_torch.train.train_layer_model import TrainLayerModel
from calodiffusion_tpu_torch.train.trainer import _copy
from calodiffusion_tpu_torch.utils.config import default_flags
from tests.test_torch_port_model import random_params
from tests.utils_test import fake_batch, tiny_ds2_config

FWD_RTOL = 1e-5
STEP_RTOL = 1e-4
PER_EVAL_ATOL = 2e-4
STATS_RTOL = 1e-6
N_LAY = 46


def _cfg(**kw):
    return tiny_ds2_config(LAYER_SIZE_UNET=[8, 8, 8, 8], COND_SIZE_UNET=16, LAYER_STEPS=4,
                           NSTEPS=4, **kw)


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


def _stats(seed=9):
    rng = np.random.default_rng(seed)
    return (rng.normal(0.0, 0.5, N_LAY).astype(np.float32),
            rng.uniform(0.05, 1.0, N_LAY).astype(np.float32))


@pytest.fixture(scope="module")
def pair():
    """The JAX cascade and the port's from the same random weights, with
    whitening statistics."""
    cfg = _cfg()
    jm = JaxLayer(dict(cfg), n_steps=4, loss_type="l2")
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0)), seed=0)
    mean, std = _stats()
    params["layer_model"] = dict(params["layer_model"],
                                 whiten={"mean": jnp.asarray(mean), "std": jnp.asarray(std)})
    tm = LayerDiffusion(dict(cfg), n_steps=4, loss_type="l2", device="cpu")
    tm.load_state_dict(layer_params_to_state_dict(params, cfg))
    return cfg, jm, params, tm


# ---------------------------------------------------------------------------
# the layer net and its whitening
# ---------------------------------------------------------------------------

def test_resnet_dense_matches_jax_and_reads_back_through_torch_import():
    """ResNetDense(dim_in=46, num_layers=5) from carried weights; its
    state_dict names are the reference's, which the JAX package's own .pth
    importer reads back into the same params."""
    jnet = JaxResNetDense(dim_in=N_LAY, num_layers=5)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, N_LAY)).astype(np.float32)
    cond = rng.uniform(0, 1, (3, 1)).astype(np.float32)
    time = rng.standard_normal(3).astype(np.float32)
    params = random_params(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, cond, time), 2)
    want = np.asarray(jnet.apply(params, x, cond=cond, time=time))
    net = ResNetDense(dim_in=N_LAY, num_layers=5)
    sd = module_params_to_state_dict(params, "ResNetDense")
    net.load_state_dict(sd)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (x, cond, time))).numpy()
    assert _rel(got, want) <= FWD_RTOL

    template = jax.tree_util.tree_map(np.zeros_like, params)
    back = {"params": dict(template["params"])}
    import_resnet_dense(back, {k: v.numpy() for k, v in sd.items()}, ["params"])
    for path, a in jax.tree_util.tree_leaves_with_path(params):
        b = back
        for k in path:
            b = b[k.key]
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


def test_whitening_with_and_without_stats_matches_jax(pair):
    cfg, jm, params, tm = pair
    u = np.random.default_rng(3).standard_normal((3, N_LAY)).astype(np.float32)
    for fn in ("whiten_layers", "unwhiten_layers"):
        want = np.asarray(getattr(jm, fn)(params, jnp.asarray(u)))
        got = getattr(tm, fn)(torch.from_numpy(u)).numpy()
        np.testing.assert_allclose(got, want, rtol=STATS_RTOL, atol=0)
    bare = LayerDiffusion(dict(cfg), n_steps=4, device="cpu")
    assert bare.whiten is None and "layer_model.whiten.mean" not in bare.state_dict()
    for fn in ("whiten_layers", "unwhiten_layers"):
        assert torch.equal(getattr(bare, fn)(torch.from_numpy(u)), torch.from_numpy(u))
    # the statistics are buffers: in the state_dict, never in parameters()
    names = {n for n, _ in tm.named_parameters()}
    assert "layer_model.whiten.mean" in tm.state_dict()
    assert not any("whiten" in n for n in names)
    assert {k for k in tm.state_dict() if "whiten" not in k} == names


@pytest.mark.parametrize("objective", ["hybrid_weight", "noise_pred", "mean_pred"])
def test_denoise_layer_matches_jax(pair, objective):
    cfg, jm, params, tm = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, N_LAY)).astype(np.float32)
    E = rng.uniform(0, 1, (3, 1)).astype(np.float32)
    sigma = np.array([[0.05], [0.8], [6.0]], np.float32)
    jm.training_objective = tm.training_objective = objective
    try:
        want = np.asarray(jm.denoise_layer(params, jnp.asarray(x), E=jnp.asarray(E),
                                           sigma=jnp.asarray(sigma)))
        with torch.no_grad():
            got = tm.denoise_layer(torch.from_numpy(x), E=torch.from_numpy(E),
                                   sigma=torch.from_numpy(sigma)).numpy()
    finally:
        jm.training_objective = tm.training_objective = "hybrid_weight"
    assert _rel(got, want) <= FWD_RTOL


def test_layer_net_computes_in_f32_under_bf16(pair):
    """The JAX package builds the layer net without a dtype: under
    PRECISION bf16 only the base U-Net computes in bf16."""
    cfg, _, params, tm = pair
    bf = LayerDiffusion(dict(cfg, PRECISION="bf16"), n_steps=4, device="cpu")
    bf.load_state_dict(tm.state_dict())
    assert bf.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf.layer_net.parameters())
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, N_LAY)).astype(np.float32))
    E = torch.from_numpy(rng.uniform(0, 1, (2, 1)).astype(np.float32))
    sigma = torch.tensor([[0.3], [2.0]])
    with torch.no_grad():
        assert torch.equal(bf.denoise_layer(x, E=E, sigma=sigma),
                           tm.denoise_layer(x, E=E, sigma=sigma))


# ---------------------------------------------------------------------------
# training: the loss, one step, the statistics, the val loss
# ---------------------------------------------------------------------------

def _jax_draws(key, batch):
    """The noise and log-normal draw JAX's layer-mode loss takes from its
    key (losses.py:121-124: split, noise from the second half)."""
    k_sigma, k_noise = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, (batch, N_LAY), jnp.float32)),
            np.asarray(jax.random.normal(k_sigma, (batch,))))


def test_layer_mode_loss_matches_jax(pair):
    """The layer net's loss on the whitened layers, with injected noise and
    log-normal draws; the base U-Net gets no gradient."""
    cfg, jm, params, tm = pair
    data, E, layers = fake_batch(cfg, batch=3, seed=6)
    noise, rnd = _jax_draws(jax.random.PRNGKey(7), 3)
    jm.set_layer_state(True)
    tm.set_layer_state(True)
    try:
        want = float(jm.compute_loss(params, jax.random.PRNGKey(7), jnp.asarray(data),
                                     jnp.asarray(E), layers=jnp.asarray(layers)))
        loss = tm.compute_loss(torch.from_numpy(data), torch.from_numpy(E),
                               noise=torch.from_numpy(noise), layers=torch.from_numpy(layers),
                               rnd_normal=torch.from_numpy(rnd))
        loss.backward()
    finally:
        jm.set_layer_state(False)
        tm.set_layer_state(False)
    assert abs(loss.item() - want) <= STEP_RTOL * abs(want)
    assert all(p.grad is None for p in tm.net.unet.parameters())
    assert all(p.grad is not None for p in tm.layer_net.parameters())
    for p in tm.layer_net.parameters():
        p.grad = None


def _loader(cfg, seeds, batch=3):
    out = []
    for s in seeds:
        data, E, layers = fake_batch(cfg, batch=batch, seed=s)
        out.append((E, 0.5 * layers + 0.1 * s, data))  # per-dim means and spreads apart
    return out


@pytest.fixture(scope="module")
def jax_step():
    """One JAX TrainLayerModel step (EMA on) from random weights and the
    statistics its init_model computes from the loader."""
    cfg = _cfg(EMA_DECAY=0.9)
    loader = _loader(cfg, (10, 11, 12))
    jt = JaxTrainLayer(jax_flags(seed=3), dict(cfg), load_data=False, save_model=False)
    jt.loader_train = loader
    # init_model's steps, with random weights in place of flax's init
    jt.model = JaxLayer(dict(cfg), n_steps=4, loss_type="l2")
    jt.model.set_layer_state(True)
    stats = jax.tree_util.tree_map(np.asarray, jt._layer_whiten_stats())
    params = random_params(jax.eval_shape(jt.model.init, jax.random.PRNGKey(0)), seed=8)
    params["layer_model"] = dict(params["layer_model"], whiten=stats)
    jt.params = params
    jt._init_aux_params()
    sd = layer_params_to_state_dict(params, cfg)
    lr = float(cfg["LR"])
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=lr)
    jt.opt = opt
    train_step, val_step = jt._make_train_step()
    E, layers, data = loader[0]
    key = jax.random.PRNGKey(5)
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)  # noqa: E731 (train_step donates)
    new, _, ema, loss = train_step(copy(params), opt.init(params), copy(params), key,
                                   jnp.asarray(data), jnp.asarray(E), jnp.asarray(layers))
    return dict(cfg=cfg, loader=loader, stats=stats, sd=sd, key=key, loss=float(loss),
                new=layer_params_to_state_dict(jax.tree_util.tree_map(np.asarray, new), cfg),
                ema=layer_params_to_state_dict(jax.tree_util.tree_map(np.asarray, ema), cfg),
                params=params, val_step=val_step, lr=lr)


def test_train_layer_model_step_matches_jax(jax_step):
    """The port's step from the same weights, statistics and draws: the
    layer net and the EMA as JAX's; the base U-Net and the live whitening
    statistics unchanged bit for bit; the statistics as JAX's."""
    s = jax_step
    cfg = s["cfg"]
    tt = TrainLayerModel(default_flags(seed=3), dict(cfg), load_data=False, save_model=False,
                         device="cpu", loader_train=s["loader"])
    tt.init_model()
    for k in ("mean", "std"):
        np.testing.assert_allclose(tt.model.whiten[k].numpy(), s["stats"][k], rtol=STATS_RTOL,
                                   atol=0)
    tt.model.load_state_dict(s["sd"])
    tt.ema_params = _copy(tt.model.state_dict())
    tt.make_optimizer(s["lr"])
    before = _copy(tt.model.state_dict())
    E, layers, data = (torch.from_numpy(a) for a in s["loader"][0])
    noise, rnd = _jax_draws(s["key"], data.shape[0])
    loss = tt._accumulate_grads(data, E, layers, noise=torch.from_numpy(noise),
                                rnd_normal=torch.from_numpy(rnd))
    tt._apply_update()
    assert abs(loss.item() - s["loss"]) <= STEP_RTOL * abs(s["loss"])
    after = tt.model.state_dict()
    moved = 0
    for k, v in after.items():
        if k.startswith("base_model.") or ".whiten." in k:
            assert torch.equal(v, before[k]), k  # left as it is
            np.testing.assert_array_equal(s["new"][k].numpy(), before[k].numpy(), err_msg=k)
        else:
            assert _rel(v.numpy(), s["new"][k].numpy()) <= STEP_RTOL, k
            moved += not torch.equal(v, before[k])
        assert _rel(tt.ema_params[k].numpy(), s["ema"][k].numpy()) <= STEP_RTOL, k
    assert moved == len(list(tt.model.layer_net.parameters()))


def test_layer_trainer_val_loss_is_the_base_unets(jax_step, monkeypatch):
    """Reference behaviour both packages keep: the layer trainer's val loss
    is the frozen base U-Net's diffusion loss on the showers (JAX
    trainer.py:415-429 through LayerDiffusion.denoise), so the layer net's
    weights do not move it."""
    s = jax_step
    cfg = s["cfg"]
    E, layers, data = s["loader"][1]
    # sigmas around the log-normal's median e^-1.2: an l2 mean that a
    # tiny-sigma sample carries holds only the U-Net's absolute forward
    # error (2e-4, docs/DESIGN.md:32), not 1e-4 of itself
    rnd = np.random.default_rng(13).uniform(-0.5, 0.5, 3).astype(np.float32)
    mask = np.ones(3, np.float32)
    key = jax.random.PRNGKey(17)
    noise = np.asarray(jax.random.normal(key, data.shape, jnp.float32))

    def jax_val(params):
        return float(s["val_step"](params, jnp.asarray(data), jnp.asarray(E),
                                   jnp.asarray(layers), jnp.asarray(rnd), jnp.asarray(mask),
                                   key))

    moved = dict(s["params"])
    moved["layer_model"] = jax.tree_util.tree_map(lambda a: a * 1.5 + 0.1,
                                                  s["params"]["layer_model"])
    want = jax_val(s["params"])
    assert jax_val(moved) == want

    monkeypatch.setattr(ttrainer, "randn", lambda *a, **k: torch.from_numpy(noise))
    tt = TrainLayerModel(default_flags(seed=3), dict(cfg), load_data=False, save_model=False,
                         device="cpu")
    tt.init_model()
    args = [torch.from_numpy(a) for a in (data, E, layers, rnd, mask)]
    tt.model.load_state_dict(s["sd"])
    got = tt.val_step(*args).item()
    tt.model.load_state_dict(layer_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, moved), cfg))
    assert tt.val_step(*args).item() == got
    assert abs(got - want) <= STEP_RTOL * abs(want)
    # and it is the plain diffusion model's loss on the base weights
    base = CaloDiffusion(dict(cfg), n_steps=4, device="cpu")
    base.load_state_dict(params_to_state_dict(s["params"]["base_model"], cfg))
    with torch.no_grad():
        plain = base.loss_function(base.denoise_fn(), args[0], args[1],
                                   torch.Generator().manual_seed(0),
                                   noise=torch.from_numpy(noise), layers=args[2],
                                   rnd_normal=args[3], mask=args[4]).item()
    assert plain == got


# ---------------------------------------------------------------------------
# sampling: both stages, generate, the oracle layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_generate(pair):
    """One JAX generate of one batch (DDim, 4 steps in both stages), with
    the dict its sample returns and the starts its keys give."""
    cfg, jm, params, _ = pair
    _, E, layers = fake_batch(cfg, batch=2, seed=20)
    loader = [(E, layers, None)]
    key = jax.random.PRNGKey(21)
    _, sub = jax.random.split(key)  # generate's per-batch key
    k_lay, k_start, _ = jax.random.split(sub, 3)  # sample's split
    k_start1, _ = jax.random.split(k_lay)  # sample_layers' split
    starts = [np.asarray(jax.random.normal(k_start1, (2, N_LAY), jnp.float32)),
              np.asarray(jm.noise_generation(k_start, (2, *jm._data_shape)))]
    sampled = []
    sample = jm.sample

    def record(*a, **kw):
        out = sample(*a, **kw)
        sampled.append(out)
        return out

    jm.sample = record
    try:
        showers, energies = jm.generate(params, key, loader, 4)
    finally:
        del jm.sample
    return loader, starts, sampled[0], showers, energies


def test_sample_and_generate_match_jax(pair, jax_generate, monkeypatch):
    """Stage 1 (sample_layers, unwhitened), stage 2 and reverse_norm with
    the stage-1 layers as layerE, from the starts JAX draws."""
    cfg, _, _, tm = pair
    loader, starts, want, showers, energies = jax_generate
    queue = [torch.from_numpy(s) for s in starts]
    monkeypatch.setattr(tlayer, "randn", lambda *a, **k: queue.pop(0))
    got = []
    sample = tm.sample

    def record(*a, **kw):
        out = sample(*a, **kw)
        got.append(out)
        return out

    monkeypatch.setattr(tm, "sample", record)
    t_showers, t_energies = tm.generate(loader, 4)
    assert not queue
    np.testing.assert_allclose(got[0]["layers"].numpy(), np.asarray(want["layers"]), rtol=0,
                               atol=4 * PER_EVAL_ATOL)
    np.testing.assert_allclose(got[0]["x"].numpy(), np.asarray(want["x"]), rtol=0,
                               atol=8 * PER_EVAL_ATOL)
    assert t_showers.shape == showers.shape == (2, 6480)
    np.testing.assert_array_equal(t_energies, energies)
    # reverse_norm (held bit for bit to JAX's elsewhere) of JAX's own
    # samples equals the port's showers within what their inputs differ by
    from calodiffusion_tpu_torch.utils import preprocessing

    c = cfg
    ref, _ = preprocessing.reverse_norm(
        np.asarray(want["x"]), np.asarray(loader[0][0], np.float32), shape=c["SHAPE_FINAL"],
        config=c, emax=c["EMAX"], emin=c["EMIN"], layerE=np.asarray(want["layers"]),
        logE=c["logE"], binning_file=c["BIN_FILE"], max_deposit=c["MAXDEP"],
        showerMap=c["SHOWERMAP"], dataset_num=2, orig_shape=False, ecut=float(c["ECUT"]))
    np.testing.assert_array_equal(ref.reshape(showers.shape), showers)
    scale = np.abs(showers).max()
    assert np.abs(t_showers - showers).max() <= 1e-2 * scale


def test_oracle_layers_skip_stage_one(pair, monkeypatch):
    """``layers=`` and ``generate(oracle_layers=True)`` condition stage 2 on
    the given vector and never run stage 1; reverse_norm then takes the
    loader's layers."""
    cfg, _, _, tm = pair
    _, E, layers = fake_batch(cfg, batch=2, seed=22)

    def boom(*a, **k):
        raise AssertionError("stage 1 must not run")

    monkeypatch.setattr(tm, "sample_layers", boom)
    start = torch.from_numpy(np.random.default_rng(23).standard_normal(
        (2, *tm._data_shape)).astype(np.float32))
    E_t, lay_t = torch.from_numpy(E), torch.from_numpy(layers)
    out = tm.sample(E_t, layers=lay_t, num_steps=4, start=start, return_layers=True)
    assert out["layers"] is lay_t
    with torch.no_grad():
        direct = tm.make_sampler()(tm, start, E_t, lay_t, 4, 0, None)
    assert torch.equal(out["x"], direct)
    showers, energies = tm.generate([(E, layers, None)], 4, oracle_layers=True,
                                    generator=torch.Generator().manual_seed(0))
    assert showers.shape == (2, 6480) and np.isfinite(showers).all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_composite_and_split_checkpoints_load(pair, tmp_path):
    """load_for_inference: a composite --model-loc alone; a plain diffusion
    --model-loc with config["layer_model"]; neither -> ValueError.  The
    whitening statistics round-trip, and a layer checkpoint without them
    loads as identity whitening."""
    cfg, _, _, tm = pair
    sd = tm.state_dict()
    base = {k.removeprefix("base_model."): v for k, v in sd.items()
            if k.startswith("base_model.")}
    bare = {k: v for k, v in sd.items() if ".whiten." not in k}
    ckpt_io.save_checkpoint(str(tmp_path / "cascade"), "final", params=sd)
    ckpt_io.save_checkpoint(str(tmp_path / "plain"), "final", params=base)
    ckpt_io.save_checkpoint(str(tmp_path / "bare"), "final", params=bare)

    def load(model_loc, **extra):
        t = TrainLayerModel(default_flags(model_loc=str(model_loc)), dict(cfg, **extra),
                            load_data=False, save_model=False, inference=True, device="cpu")
        return t.load_for_inference()

    for m in (load(tmp_path / "cascade" / "final.ckpt"),
              load(tmp_path / "plain" / "final.ckpt",
                   layer_model=str(tmp_path / "cascade" / "final.ckpt"))):
        assert not m.layer_loss
        got = m.state_dict()
        assert set(got) == set(sd)
        assert all(torch.equal(got[k], v) for k, v in sd.items())
    m = load(tmp_path / "plain" / "final.ckpt", layer_model=str(tmp_path / "bare" / "final.ckpt"))
    assert m.whiten is None and set(m.state_dict()) == set(bare)
    with pytest.raises(ValueError, match="No layer model"):
        load(tmp_path / "plain" / "final.ckpt")
