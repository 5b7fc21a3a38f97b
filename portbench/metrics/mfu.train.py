"""mfu.train: the operations of the train steps completed in the window
(``counts.train_step_flops``, from the configuration) over the window's
seconds, as a share of the bf16 peak (989 TFLOP/s)."""

from portbench import counts


def read(run):
    if run.entry != "train_step" or run.window_s <= 0:
        return None
    flops = counts.train_step_flops(run.config, run.batch) * run.units
    return 100.0 * flops / run.window_s / counts.PEAK_BF16_FLOPS
