"""conv_roofline: the least time of the convolutions of the traced network
evaluations (``counts.conv_ops``: each the longer of its bytes over the HBM
rate and its operations over the bf16 peak) over the device time of the
kernels launched inside the convolutions' ranges (their padding and layout
copies included)."""

from portbench import counts
from portbench.trace import CONV


def read(run):
    tr = run.trace
    if run.entry != "generate" or tr is None or tr.units <= 0:
        return None
    spent = tr.range_device_s.get(CONV, 0.0)
    if spent <= 0:
        return None
    bound = tr.units * sum(op.bound_s(run.batch) for op in counts.conv_ops(run.config))
    return 100.0 * bound / spent
