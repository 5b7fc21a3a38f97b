"""The analytic counts of ``portbench/counts.py`` against what
``FlopCounterMode`` counts on today's port, at a tiny width on the CPU, and
the bounds' arithmetic."""

from __future__ import annotations

import pytest
import torch
from conftest import SHIPPED, tiny_config
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts, inputs
from portbench.trace import attention_blocks


def _model(config):
    from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion

    model = CaloDiffusion(config, n_steps=config["NSTEPS"], loss_type=config["LOSS_TYPE"],
                          device="cpu")
    model.load_state_dict(inputs.make_weights(config, 3, "cpu"))
    return model


def _denoise_inputs(config, B):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((B, *config["SHAPE_PAD"][1:]), generator=g)
    E = torch.rand((B, 1), generator=g)
    layers = torch.randn((B, config["SHAPE_FINAL"][2] + 1), generator=g)
    sigma = torch.full((B, 1, 1, 1, 1), 0.7)
    return x, E, sigma, layers


def _attention_flops(config, B, backward: bool):
    """The plain attention blocks' products as autograd runs them: the
    forward's count once, its backward twice over."""
    k1 = sum(counts.k1_flops(B, op.positions, op.cin) for op in counts.attention_ops(config))
    return k1 * (3 if backward else 1)


@pytest.mark.parametrize("name", ["calochallenge_ds2", "calochallenge_ds3"])
@pytest.mark.parametrize("backward", [False, True])
def test_counts_match_flop_counter_on_the_port(name, backward):
    config = tiny_config(name)
    B = 3
    model = _model(config)
    x, E, sigma, layers = _denoise_inputs(config, B)
    counter = FlopCounterMode(display=False)
    with counter:
        if backward:
            model.denoise(x, E=E, sigma=sigma, layers=layers).sum().backward()
        else:
            with torch.no_grad():
                model.denoise(x, E=E, sigma=sigma, layers=layers)
    analytic = sum(op.flops(B) + (op.backward_flops(B) if backward else 0)
                   for op in counts.network_ops(config) if op.kind != "attn")
    analytic += _attention_flops(config, B, backward)
    assert counter.get_total_flops() == analytic
    expected_train = counts.denoise_flops(config, B) + sum(
        op.backward_flops(B) for op in counts.network_ops(config))
    assert counts.train_step_flops(config, B) == expected_train


@pytest.mark.parametrize("name,gflop", [("calochallenge_ds2", 5.44), ("calochallenge_ds3", 30.35)])
def test_full_size_denoise_matches_the_port_at_its_widths(name, gflop):
    """A denoise of the shipped configurations, per shower: the figures
    the port's own FLOP count gave on the card (5.44 and 30.35 GFLOP)."""
    config = SHIPPED.config(name)
    assert counts.denoise_flops(config, 1) / 1e9 == pytest.approx(gflop, abs=0.01)


def test_network_ops_follow_the_ports_modules():
    """One count per convolution module the port calls, and one attention
    block per block-attention residual."""
    config = tiny_config("calochallenge_ds3")
    model = _model(config)
    convs = [m for m in model.net.unet.modules()
             if isinstance(getattr(m, "weight", None), torch.Tensor) and m.weight.dim() == 5]
    blocks = attention_blocks(model.net)
    n_attn = len(counts.attention_ops(config))
    assert len(blocks) == n_attn == 7
    # each block holds one projection conv pair (qkv, out) that runs fused
    assert len(counts.conv_ops(config)) == len(convs) - 2 * n_attn


def test_bounds_take_the_longer_of_bytes_and_operations():
    op = counts.Op("conv", 1000, 32, 32, 27, 32 * 1000, 32 * 1000)
    B = 64
    t_bytes = op.nbytes(B) / counts.HBM_BYTES_PER_S
    t_ops = op.flops(B) / counts.PEAK_BF16_FLOPS
    assert op.bound_s(B) == max(t_bytes, t_ops)
    assert op.nbytes(B) == (B * 64000 + 32 * 32 * 27 + 32) * 2
    # K1: x read and written once, the projections once, five f32 vectors
    assert counts.attention_bytes(2, 10, 32) == 2 * 2 * 10 * 32 * 2 + (32 * 96 + 32 * 32) * 2 + 5 * 32 * 4
    assert counts.k1_flops(2, 10, 32) == 2 * 2 * 10 * (96 * 32 + 2 * 32 * 32 + 32 * 32)
