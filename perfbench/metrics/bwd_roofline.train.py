"""The backward compositing kernel's share of its roofline in the traced
training steps: the frozen bound (`counts.bwd_bytes`, `counts.bwd_ops` on
the reference binning of each step's camera) over the kernel's device
time in those steps, in %."""

KERNEL = "composite_bwd_kernel"


def read(run):
    if run.driver != "train" or run.trace is None:
        return None
    times = run.trace.kernels(KERNEL)
    least = run.work.get("bwd_least_s_traced")
    if len(times) != run.traced_steps or not least or sum(times) <= 0:
        return None
    return 100.0 * least / sum(times)
