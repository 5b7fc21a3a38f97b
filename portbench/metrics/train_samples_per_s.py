"""train_samples_per_s: batch x train steps completed in the window, over
the window's seconds (host clock)."""


def read(run):
    if run.entry != "train_step" or run.window_s <= 0:
        return None
    return run.batch * run.units / run.window_s
