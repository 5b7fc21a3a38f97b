"""The port's four probe scripts on the CPU: scripts/torch_level_profile.py,
torch_l0_elementwise_ablation.py, torch_im2col_microbench.py and
torch_ds3_roofline.py against scripts/level_profile.py,
l0_elementwise_ablation.py, im2col_microbench.py and ds3_roofline.py.

At a tiny size (batch 2, widths [8, 8, 16, 8], cond 16, f32, the ds2 grid,
``--device cpu``, the attention blocks' plain version): the port's
``TruncatedUnet`` against the JAX one at keep_levels 1 and 2 from the same
weights, and with the GroupNorm/SiLU ablation applied in both packages,
within 2e-4 (the weight-transfer bound of docs/DESIGN.md:32);
``im2col_cyl_conv3d`` against the JAX one and against the port's
``cylindrical_conv3d`` within 1e-5 relative (the scripts' own gate);
``levels_for`` against JAX's and the port's U-Net; ``conv_case`` and
``model_measurements`` with every key the JAX functions return (the TPU's
padded-ideal fields aside) plus the card's, finite; the FLOPs of a denoise
against a count by hand from the layers' shapes and K1's formula (1 %);
each script end to end, and each refusing without a card.
"""

import contextlib
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from calodiffusion_tpu.models import nn_modules as jM
from calodiffusion_tpu_torch.models import nn_modules as M
from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.ops.conv import cylindrical_conv3d
from calodiffusion_tpu_torch.tools.jax_import import _subtree, _Writer
from tests.utils_test import tiny_ds2_config

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import torch_ds3_roofline as trl  # noqa: E402
import torch_im2col_microbench as tim  # noqa: E402
import torch_l0_elementwise_ablation as tl0  # noqa: E402
import torch_level_profile as tlp  # noqa: E402

UNET_ATOL = 2e-4  # docs/DESIGN.md:32
IM2COL_RTOL = 1e-5  # the scripts' own gate (REL_ERR_MAX)
FLOP_RTOL = 0.01
LS = [8, 8, 16, 8]
COND = 16
SHAPE = (45, 16, 9)
CPU = ["--device", "cpu"]
# the TPU-only fields of ds3_roofline.conv_case that the port drops
TPU_ONLY = {"padded_ideal_frac_pct", "pct_of_padded_ideal"}


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


def _load_jax(name):
    """A JAX script as a module, its ``sys.argv[1]`` default in force."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [f"{name}.py"])
        spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jlp():
    return _load_jax("level_profile")


@pytest.fixture(scope="module")
def jl0():
    """The JAX ablation; it imports ``scripts.level_profile`` itself."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT))
        mp.setattr(sys, "argv", ["l0_elementwise_ablation.py"])
        return _load_jax("l0_elementwise_ablation")


def random_params(shapes, seed):
    """numpy params for a flax tree of ShapeDtypeStructs: kernels at torch's
    default bound, GroupNorm scales near 1, biases small."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def truncated_state_dict(params, keep, block_attn) -> dict:
    """Flax ``TruncatedUnet`` params -> the port's, by flax's call order:
    ResnetBlock_k down then up then the final block, PreNormResidual_a /
    LinearAttention_a, the downsampling Conv3d_i and Conv3dTranspose_i,
    each submodule through ``tools/jax_import``'s writer.  A Block whose
    GroupNorm the ablation removed gets an identity one (its module is
    swapped for identity on the port's side too)."""
    tree = _subtree(params)
    for name, node in tree.items():
        for b in ("Block_0", "Block_1"):
            if name.startswith("ResnetBlock_") and "GroupNorm_0" not in node[b]:
                c = node[b]["Conv3d_0"]["kernel"].shape[-1]
                node[b]["GroupNorm_0"] = {"scale": np.ones(c, np.float32),
                                          "bias": np.zeros(c, np.float32)}
    w = _Writer(tree)
    w.conv(["init_conv"], "init_conv")
    w.cond_mlp(["time_mlp"], "time_mlp", embed=True, unflatten=True)
    w.cond_mlp(["cond_mlp"], "cond_mlp", embed=True, unflatten=False)
    rb = attn = 0
    for side in ("downs", "ups"):
        for i in range(keep):
            for j in range(2):
                w.resnet_block([f"ResnetBlock_{rb}"], f"{side}.{i}.{j}")
                rb += 1
            if block_attn:
                w.attention([], attn, f"{side}_attn.{i}")
                attn += 1
            if i < keep - 1:
                if side == "downs":
                    w.conv([f"Conv3d_{i}"], f"downs.{i}.2")
                else:
                    w.conv([f"Conv3dTranspose_{i}"], f"ups.{i}.2", transpose=True)
    w.resnet_block([f"ResnetBlock_{rb}"], "final_conv.0")
    w.conv(["final_conv"], "final_conv.1")
    return w.sd


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *SHAPE, 3)).astype(np.float32)
    return x, rng.uniform(0.1, 0.9, 2).astype(np.float32), rng.uniform(0.1, 0.9, 2).astype(
        np.float32)


def _jax_truncated(jlp, keep, block_attn):
    return jlp.TruncatedUnet(
        keep_levels=keep, out_dim=1, cond_dim=COND, cylindrical=True, compress_Z=True,
        data_shape=SHAPE, cond_size=1, dtype=jnp.float32, layer_sizes=tuple(LS),
        block_attn=block_attn, mid_attn=False)


def _compare_truncated(jlp, keep, block_attn, patch=lambda model: contextlib.nullcontext()):
    jm = _jax_truncated(jlp, keep, block_attn)
    x, cond, t = _inputs()
    params = random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, cond, t), seed=keep)
    want = np.asarray(jax.jit(jm.apply)(params, x, cond, t))
    model = tlp.make_model(dict(block_attn=block_attn, mid_attn=False), keep, layer_sizes=LS,
                           cond_dim=COND, dtype=torch.float32, device="cpu")
    model.load_state_dict(truncated_state_dict(params, keep, block_attn), strict=True)
    with torch.no_grad(), patch(model):
        got = model(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(cond),
                    torch.from_numpy(t))
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (2, *SHAPE, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_ATOL)
    return model


@pytest.mark.parametrize("keep", [1, 2])
def test_truncated_unet_matches_jax(jlp, keep):
    model = _compare_truncated(jlp, keep, block_attn=True)
    assert tlp.k1_blocks(model) == 2 * keep


@pytest.mark.parametrize("silu", [False, True], ids=["no_gn", "no_gn_no_silu"])
def test_elementwise_ablation_matches_jax(jlp, jl0, monkeypatch, silu):
    """Both packages patched: JAX's M.GroupNorm -> IdentityGN (and
    flax.linen.silu -> identity), the port's Block norms (and its two SiLU
    sites) swapped by ``elementwise_identity``; restored afterwards."""
    import flax.linen as fnn

    monkeypatch.setattr(jM, "GroupNorm", jl0.IdentityGN)
    if silu:
        monkeypatch.setattr(fnn, "silu", lambda x: x)
    real_f = M.F
    model = _compare_truncated(
        jlp, 1, block_attn=False,
        patch=lambda m: tl0.elementwise_identity(m, gn=True, silu=silu))
    assert M.F is real_f
    assert all(isinstance(m.norm, M.GroupNorm) for m in model.modules() if isinstance(m, M.Block))
    assert all(isinstance(m.mlp[0], torch.nn.SiLU) for m in model.modules()
               if isinstance(m, M.ResnetBlock) and m.mlp is not None)


def test_elementwise_identity_reaches_its_sites_only():
    model = tlp.make_model(tl0.NO_ATTN, 1, layer_sizes=LS, cond_dim=COND, dtype=torch.float32,
                           device="cpu")
    x = torch.randn(2, 8, 4, 4, 3)
    with tl0.elementwise_identity(model, gn=True, silu=True):
        block = model.downs[0][0].block1
        assert isinstance(block.norm, torch.nn.Identity)
        assert torch.equal(block(x), block.proj(x))
        assert isinstance(model.downs[0][0].mlp[0], torch.nn.Identity)
        # the GELUs of the conditioning MLPs are untouched
        assert any(isinstance(m, torch.nn.GELU) for m in model.time_mlp)
        assert M.F.gelu is torch.nn.functional.gelu and M.F.silu(x) is x
    assert M.F is torch.nn.functional


def test_im2col_matches_jax_and_cudnn():
    jim = _load_jax("im2col_microbench")
    rng = np.random.default_rng(3)
    for spatial, cin, cout in (((5, 4, 3), 8, 8), ((6, 5, 3), 8, 16)):
        x = rng.standard_normal((2, *spatial, cin)).astype(np.float32)
        w = (0.05 * rng.standard_normal((3, 3, 3, cin, cout))).astype(np.float32)
        want = np.asarray(jim.im2col_cyl_conv3d(jnp.asarray(x), jnp.asarray(w)))
        xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()
        wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).contiguous()
        got = tim.im2col_cyl_conv3d(xt, wt)
        ref = cylindrical_conv3d(xt, wt, padding=1)
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, rtol=0,
                                   atol=IM2COL_RTOL * scale)
        assert float((got - ref).abs().max()) <= IM2COL_RTOL * scale
        assert tim.rel_err(xt.to(torch.bfloat16), wt.to(torch.bfloat16)) <= IM2COL_RTOL


@pytest.mark.parametrize("shape,widths", [((45, 16, 9), [32, 32, 64, 32]),
                                          ((45, 50, 18), [32, 32, 32, 32])], ids=["ds2", "ds3"])
def test_levels_for_matches_jax(shape, widths):
    """JAX's formula, and the conv table's geometries are its levels.  (It
    rounds A and R up, where the U-Net's (3, 4, 4) stride-2 downsampling
    takes them to floor(n / 2): ds2's level 1 runs at (23, 8, 4), not
    (23, 8, 5); the table keeps the JAX script's geometries.)"""
    jrl = _load_jax("ds3_roofline")
    got = trl.levels_for(shape, True, widths)
    assert got == jrl.levels_for(shape, True, widths)
    family = "ds2" if shape[1] == 16 else "ds3"
    assert sorted({sp for sp, _, _ in trl.CONV_CASES[family]}) == sorted(got)


def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def test_conv_case_keys_match_jax(monkeypatch):
    """JAX's row with its timing stubbed (the keys come from the row it
    builds) against the port's in both layouts."""
    jrl = _load_jax("ds3_roofline")
    monkeypatch.setattr(jrl, "scan_time", lambda fn, args, iters=30: 1e-3)
    want = set(jrl.conv_case(2, (4, 4, 3), 8, 8, "f32", iters=1)) - TPU_ONLY
    card = {"layout", "bound_ms", "bound_by", "pct_of_bound", "graph_ms", "eager_ms", "host_ms"}
    for layout in trl.LAYOUTS:
        got = trl.conv_case(2, (4, 4, 3), 8, 8, "f32", iters=1, layout=layout, device="cpu")
        assert set(got) == want | card and got["layout"] == layout
        assert all(_finite(got[k]) for k in want | {"bound_ms", "pct_of_bound", "eager_ms"}
                   if not isinstance(got[k], list))
        assert got["graph_ms"] is None and got["host_ms"] is None  # no graph on the CPU
        assert got["pct_of_bound"] == pytest.approx(100 * got["bound_ms"]
                                                    / got["time_per_conv_ms"])
        assert got["useful_mfu_pct"] == pytest.approx(100 * got["achieved_tflops"] * 1e12
                                                      / trl.PEAK)


def test_pair_bound_by_hand():
    """The larger of the pair's FLOPs over 989 TFLOP/s and its bytes (x in,
    the result out, both weights) over 3.35 TB/s: every conv of the table
    is bound by operations (27 Cout FLOPs a byte, past the card's 295); a
    width-8 pair by bytes."""
    for spatial, cin, cout, by in (((45, 50, 18), 32, 64, "operations"),
                                   ((6, 2, 2), 64, 64, "operations"), ((6, 2, 2), 8, 8, "bytes")):
        vox = math.prod(spatial)
        flops = 2 * 128 * vox * 27 * cin * cout * 2
        nbytes = (2 * 128 * vox * cin + 2 * 27 * cin * cout) * 2
        t, got = trl.pair_bound_ms(128, spatial, cin, cout)
        assert got == by and t == pytest.approx(1e3 * max(flops / 989e12, nbytes / 3.35e12))


def test_model_measurements_keys_match_jax(monkeypatch):
    """JAX's rows with its sampling stubbed (bench.measure_sampling returns
    a rate and, where asked, FLOPs) against the port's at batch 2, 1 step."""
    jrl = _load_jax("ds3_roofline")
    import bench

    monkeypatch.setattr(bench, "measure_sampling",
                        lambda cfg, batch, steps, runs=1, want_flops=False:
                        (1.0, (1e9, 0.5) if want_flops else None))
    monkeypatch.setattr(jrl, "log", lambda msg: None)
    card = {"step_flops", "flops_per_run", "achieved_tflops", "useful_mfu_pct", "k1_blocks",
            "eager_ms", "graph_ms", "host_ms", "graph_showers_per_sec", "graph_useful_mfu_pct",
            "graph_vs_eager_max_abs_err", "unet_calls", "steps", "batch"}
    for name, blocks in (("ds2", 7), ("ds3", 7)):
        want = jrl.model_measurements(name, 2, steps=1)
        got = trl.model_measurements(name, 2, steps=1, device="cpu")
        assert list(got) == list(want) == ["full", "no_block_attn", "no_attn"]
        for tag in want:
            assert set(want[tag]) <= set(got[tag]) == set(want[tag]) | {"showers_per_sec"} | card
            assert all(_finite(got[tag][k]) for k in set(want["full"]) | {"step_flops",
                                                                          "eager_ms"})
            assert got[tag]["graph_ms"] is None  # no graph on the CPU
        assert [got[t]["k1_blocks"] for t in got] == [blocks, 1, 0]
        assert got["full"]["step_flops"] > got["no_block_attn"]["step_flops"] > \
            got["no_attn"]["step_flops"]


def _hand_flops(model, x, E, sigma, layers) -> float:
    """The FLOPs of a denoise from its layers' shapes: 2 x MACs of every
    convolution (a transpose: the input as it runs, phi-padded where
    cylindrical, times Cout k^3), every Dense, and K1's count for each
    fused attention block."""
    total, hooks = [0.0], []

    def conv(mod, args, out):
        w = mod.weight
        if isinstance(mod, M.Conv3dTranspose):
            b, _, z, a, r = args[0].shape
            pa = M.triple(mod.padding)[1] if mod.cylindrical else 0
            total[0] += 2 * b * z * (a + 2 * pa) * r * w.shape[0] * w.shape[1] * math.prod(
                w.shape[2:])
        else:
            total[0] += 2 * out.numel() * math.prod(w.shape[1:])

    def dense(mod, args, out):
        total[0] += 2 * out.numel() * mod.weight.shape[1]

    def attention(mod, args, out):
        b, c, *sp = args[0].shape
        total[0] += trl.k1_flops(b, math.prod(sp), c)

    # a fused attention block is counted whole, by K1's formula
    inner = {id(m) for blk in model.net.modules() if isinstance(blk, M.PreNormResidual)
             for m in blk.modules() if m is not blk}
    for m in model.net.modules():
        if id(m) in inner:
            continue
        if isinstance(m, (M.Conv3d, M.Conv3dTranspose)):
            hooks.append(m.register_forward_hook(conv))
        elif isinstance(m, M.Dense):
            hooks.append(m.register_forward_hook(dense))
        elif isinstance(m, M.PreNormResidual):
            hooks.append(m.register_forward_hook(attention))
    try:
        with torch.inference_mode():
            model.denoise(x, E=E, sigma=sigma, layers=layers)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def test_denoise_flops_match_a_count_by_hand():
    cfg = tiny_ds2_config(LAYER_SIZE_UNET=LS, COND_SIZE_UNET=COND, BLOCK_ATTN=True,
                          MID_ATTN=True, PRECISION="f32")
    model = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, *model._data_shape)
    E, sigma = torch.rand(2, 1), torch.full((2, 1, 1, 1, 1), 0.7)
    layers = torch.randn(2, cfg["SHAPE_FINAL"][2] + 1)
    counted, blocks = trl.denoise_flops(model, x, E, sigma, layers)
    hand = _hand_flops(model, x, E, sigma, layers)
    assert blocks == 7
    assert abs(counted - hand) <= FLOP_RTOL * hand, (counted, hand)


@pytest.fixture
def tiny_probe(monkeypatch):
    """The probes' U-Net at widths LS and cond 16 in f32 (the scripts' ds2
    grid kept)."""
    monkeypatch.setattr(tlp, "LS", LS)
    real = tlp.make_model
    monkeypatch.setattr(tlp, "make_model", lambda kw, keep=None, **k: real(
        kw, keep, **dict(k, cond_dim=COND, dtype=torch.float32)))


def test_level_profile_end_to_end(tiny_probe, jlp, tmp_path, capsys):
    out = tmp_path / "lp.json"
    report = tlp.main(CPU + ["--batch", "2", "--iters", "1", "--out", str(out)])
    assert out.exists() and set(report["cases"]) == {c[0] for c in tlp.CASES}
    assert [report["cases"][c[0]]["k1_blocks"] for c in tlp.CASES] == [7, 0, 4, 2, 0]
    for key, _, _, _ in tlp.DERIVED:
        assert _finite(report[f"{key}_ms"]) and _finite(report[f"{key}_eager_ms"])
    for case in report["cases"].values():
        assert _finite(case["eager_ms"]) and case["graph_ms"] is None
        assert case["k1_launches"] == 0  # the plain version on the CPU
        assert case["calls"] == tlp.WARMUP + tlp.REPS  # K = 1
    # every label the JAX script prints, in its order
    text = (ROOT / "scripts" / "level_profile.py").read_text()
    labels = [c[1] for c in tlp.CASES] + [d[1] for d in tlp.DERIVED]
    positions = [text.index(f'"{label}') for label in labels]
    assert positions == sorted(positions)
    printed = capsys.readouterr().out
    assert all(label in printed for label in labels)


def test_l0_ablation_end_to_end(tiny_probe, tmp_path):
    report = tl0.main(CPU + ["--batch", "2", "--iters", "1", "--out", str(tmp_path / "l0.json")])
    assert set(report["cases"]) == {c[0] for c in tl0.CASES}
    assert all(c["k1_blocks"] == 0 for c in report["cases"].values())
    text = (ROOT / "scripts" / "l0_elementwise_ablation.py").read_text()
    for key, label, _, _ in tl0.DERIVED:
        assert _finite(report[f"{key}_ms"]) and f'"{label}' in text
    assert all(f'"{label}' in text for _, label, _, _ in tl0.CASES)
    assert report["convs_only_l0_floor_ms"] == report["cases"]["l0_no_gn_no_silu"]["eager_ms"]
    assert M.F is torch.nn.functional


def test_im2col_end_to_end(tmp_path, monkeypatch):
    assert len(tim.CASES) == 8
    monkeypatch.setattr(tim, "CASES", [("tiny", 2, (5, 4, 3), 8, 8),
                                       ("tiny 8->16", 2, (5, 4, 3), 8, 16)])
    report = tim.main(CPU + ["--iters", "1", "--out", str(tmp_path / "im.json")])
    keys = {"rel_err", "native_ms", "native_tflops", "im2col_ms", "im2col_tflops", "speedup"}
    for row in report["cases"]:
        assert all(_finite(row[k]) for k in keys) and row["rel_err"] <= IM2COL_RTOL
        assert set(row["native"]) >= {"graph_ms", "eager_ms"}


def test_roofline_end_to_end(tmp_path, monkeypatch):
    jax_report = (ROOT / "roofline_report.json").stat().st_mtime_ns
    monkeypatch.setattr(trl, "CONV_CASES", {"ds2": [((4, 4, 3), 8, 16)], "ds3": []})
    report = trl.main(CPU + ["--which", "ds2", "--iters", "1", "--steps", "1", "--batch", "2",
                             "--out", str(tmp_path / "roof.json")])
    assert [c["layout"] for c in report["conv_cases"]] == list(trl.LAYOUTS)
    assert set(report) == {"card", "conv_cases", "ds2"}
    assert report["ds2"]["full"]["unet_calls"] == 3  # warm-up, one run, the FLOP count
    assert (ROOT / "roofline_report.json").stat().st_mtime_ns == jax_report


@pytest.mark.parametrize("script", [tlp, tl0, tim, trl],
                         ids=["level_profile", "l0_ablation", "im2col", "roofline"])
def test_scripts_without_a_card_refuse(script, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        script.main(["--out", str(tmp_path / "r.json")])
    assert not (tmp_path / "r.json").exists()
