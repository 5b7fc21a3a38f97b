"""calodiffusion_tpu_torch's CUDA kernels against their plain versions on
the card.  A CUDA kernel has no CPU mode, so every test here needs a card
and skips without one.  The file imports no JAX, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports JAX, so run it
there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from calodiffusion_tpu_torch.models.diffusion import CaloDiffusion
from calodiffusion_tpu_torch.ops import linear_attention as tattn
from calodiffusion_tpu_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "config_dataset2.json"

pytestmark = pytest.mark.gpu

# kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|; the
# reasons are stated beside the same numbers in chip_smoke.py
TOL = {torch.bfloat16: (0.0625, 2.0**-6), torch.float32: (1e-4, 0.0)}


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _block_args(B, N, C, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to("cuda", dt).contiguous()

    return (t(rng.standard_normal((B, N, C)), dtype),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)),
            t(0.2 * rng.standard_normal((C, 96)), dtype),
            t(0.2 * rng.standard_normal((32, C)), dtype),
            t(0.1 * rng.standard_normal(C)),
            t(1.0 + 0.1 * rng.standard_normal(C)), t(0.1 * rng.standard_normal(C)))


# the ds2 (N, C) of the main path, and ragged N: one position, a partial
# tile, one past a whole tile of 256
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,N,C", [(4, 6480, 32), (4, 736, 64), (4, 736, 32), (4, 96, 32),
                                   (4, 96, 64), (3, 1, 32), (1, 257, 64), (2, 300, 32)])
def test_attention_block_kernel_matches_plain(B, N, C, dtype):
    args = _block_args(B, N, C, dtype, seed=B + N + C)
    before = tattn.fused_attention_block.launches
    got = tattn.fused_attention_block(*args)
    torch.cuda.synchronize()
    assert tattn.fused_attention_block.launches == before + 1
    assert got.shape == (B, N, C) and got.dtype == dtype
    want = tattn.attention_block_reference(*args).float()
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def test_attention_block_kernel_rejects_what_it_does_not_take():
    x, *rest = _block_args(2, 64, 32, torch.float32, seed=0)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention_block(x.transpose(0, 1).contiguous().transpose(0, 1), *rest)
    with pytest.raises(TypeError, match="dtype"):
        tattn.fused_attention_block(x.bfloat16(), *rest)
    x48, *rest48 = _block_args(2, 64, 48, torch.float32, seed=0)
    with pytest.raises(ValueError, match="C in"):
        tattn.fused_attention_block(x48, *rest48)


def test_denoise_on_card_matches_cpu():
    """The same weights in f32: the card (kernels, cuDNN) against the CPU
    (plain versions), within the weight-transfer bound of docs/DESIGN.md:32.
    The ds2 config at its widths (the kernel takes C in {32, 64})."""
    cfg = dict(load_config(str(CONFIG)), PRECISION="f32")
    cpu = CaloDiffusion(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = CaloDiffusion(cfg)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    x, E, layers = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((2, 1, 45, 16, 9)), rng.uniform(0.1, 1.0, (2, 1)),
        rng.standard_normal((2, 46))))
    sigma = torch.full((2, 1, 1, 1, 1), 0.7)
    before = tattn.fused_attention_block.launches
    with torch.no_grad():
        want = cpu.denoise(x, E=E, sigma=sigma, layers=layers)
        got = card.denoise(x.cuda(), E=E.cuda(), sigma=sigma.cuda(), layers=layers.cuda())
    assert tattn.fused_attention_block.launches == before + 7
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=2e-4)
