"""The whole training step's share of the card's peak: the least time the
card could take for the work a step needs (`counts.step_terms`, the mean
over the window's steps) over the measured `train_ms_per_iter`, in %."""


def read(run):
    least = run.work.get("step_least_s")
    ms = run.e2e.get("train_ms_per_iter")
    if run.driver != "train" or not least or not ms:
        return None
    return 100.0 * least / (ms * 1e-3)
