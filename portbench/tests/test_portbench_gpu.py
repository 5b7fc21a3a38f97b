"""The controls on the card at the cells' own sizes: each must come out as
not correct against the limits the cells hold (``portbench/limits/``).

Run on a machine with the card:

    python3 -m pytest portbench/tests/test_portbench_gpu.py -q

It skips without one.  One seed each; ``calibrate.py`` reads a dozen.
"""

from __future__ import annotations

import pytest
import torch
from conftest import SHIPPED

from portbench import calibrate

pytestmark = pytest.mark.gpu
SEED = 2**35 + 3


def _cell(name):
    w = SHIPPED.workload(name)
    return SHIPPED.config(w["config"]), SHIPPED.traffic(w["traffic"]), SHIPPED.limits(name)


@pytest.mark.parametrize("name", ["ds2.generate.ddim400", "ds3.generate.ddim400"])
def test_the_int8_control_fails_the_generation_check(card, name):
    config, traffic, limits = _cell(name)
    r = calibrate.generation_readings(config, traffic, SEED, torch.device("cuda"), control=True)
    assert r["control_gap"] > limits["gap"] >= r["gap"]


@pytest.mark.parametrize("name", ["ds2.train", "ds3.train"])
def test_the_fp8_control_and_half_batch_fail_the_training_check(card, name):
    config, traffic, limits = _cell(name)
    r = calibrate.training_readings(config, traffic, SEED, torch.device("cuda"), control=True)
    assert all(r[k] <= limits[k] for k in limits)
    for bad in ("control", "half_batch"):
        assert any(r[bad][k] > limits[k] for k in limits), bad
