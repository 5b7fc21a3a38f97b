"""showers_per_s: batch x network evaluations completed in the window over
the evaluations of one call, over the window's seconds (host clock)."""


def read(run):
    if run.entry != "generate" or run.window_s <= 0 or run.evals_per_call <= 0:
        return None
    return run.batch * run.units / run.evals_per_call / run.window_s
