"""attn_roofline: the least time of the attention blocks of the traced
network evaluations (K1's bytes and operations, ``counts.attention_ops``)
over the device time of the kernels launched inside the blocks' ranges."""

from portbench import counts
from portbench.trace import ATTN


def read(run):
    tr = run.trace
    if run.entry != "generate" or tr is None or tr.units <= 0:
        return None
    spent = tr.range_device_s.get(ATTN, 0.0)
    ops = counts.attention_ops(run.config)
    if spent <= 0 or not ops:
        return None
    bound = tr.units * sum(op.bound_s(run.batch) for op in ops)
    return 100.0 * bound / spent
