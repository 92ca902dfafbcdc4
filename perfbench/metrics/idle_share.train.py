"""Share of the traced training segment in which no kernel, copy or set
ran on the device (the profiler's device timeline), in %."""


def read(run):
    if run.driver != "train" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
