"""device_idle_pct.train: the share of the traced span of training in which
no kernel, copy or set ran on the device (the union of their intervals)."""


def read(run):
    tr = run.trace
    if run.entry != "train_step" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
