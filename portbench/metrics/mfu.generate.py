"""mfu.generate: the operations of the network evaluations completed in the
window (``counts.denoise_flops``, from the configuration) over the window's
seconds, as a share of the bf16 peak (989 TFLOP/s)."""

from portbench import counts


def read(run):
    if run.entry != "generate" or run.window_s <= 0:
        return None
    flops = counts.denoise_flops(run.config, run.batch) * run.units
    return 100.0 * flops / run.window_s / counts.PEAK_BF16_FLOPS
