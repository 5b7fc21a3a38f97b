"""calodiffusion_tpu_torch CondUnet against the JAX CondUnet on the CPU
for every shipped Z (5, 7, 28, 47), which exercise the odd-dimension
output-padding bookkeeping of the up path.  Weights come from the JAX
parameter tree through ``params_to_state_dict``."""

import numpy as np
import pytest
import torch

import jax

from calodiffusion_tpu.models.nn_modules import CondUnet as JaxUnet
from calodiffusion_tpu_torch.models.nn_modules import CondUnet
from calodiffusion_tpu_torch.tools.jax_import import params_to_state_dict
from tests.test_torch_port_model import random_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# (Z, A, R) of SHAPE_FINAL in the ds1 photon, ds1 pion and HGCal configs
@pytest.mark.parametrize("shape", [(5, 10, 30), (7, 10, 23), (28, 12, 21), (47, 12, 21)])
def test_condunet_matches_jax(shape):
    kw = dict(layer_sizes=(8, 8, 16, 8), cond_dim=16, block_attn=True, mid_attn=True,
              compress_Z=True, cylindrical=True, data_shape=shape, time_embed=False,
              cond_embed=False, cond_size=3, channels=3)
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((2, *shape, 3)).astype(np.float32)
    cond = rng.standard_normal((2, 3)).astype(np.float32)
    time = rng.standard_normal((2,)).astype(np.float32)

    junet = JaxUnet(**kw)
    params = random_params(jax.eval_shape(junet.init, jax.random.PRNGKey(0), x, cond, time),
                           seed=1)
    want = np.asarray(jax.jit(junet.apply)(params, x, cond, time))

    unet = CondUnet(**kw)
    unet.load_state_dict(params_to_state_dict(params, {
        "LAYER_SIZE_UNET": list(kw["layer_sizes"]), "BLOCK_ATTN": True, "MID_ATTN": True,
        "TIME_EMBED": "log", "COND_EMBED": "id"}))
    with torch.no_grad():
        got = unet(torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
                   torch.from_numpy(cond), torch.from_numpy(time))
    got = np.moveaxis(got.numpy(), 1, -1)
    assert got.shape == want.shape == (2, *shape, 1)
    # the weight-transfer bound of docs/DESIGN.md:32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
