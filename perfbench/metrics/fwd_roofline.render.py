"""The forward compositing kernel's share of its roofline in the traced
views: the frozen bound (`counts.fwd_bytes`, `counts.fwd_ops` on the
reference binning of each view) over the kernel's device time, in %."""

KERNEL = "composite_fwd_kernel"


def read(run):
    if run.driver != "render" or run.trace is None:
        return None
    times = run.trace.kernels(KERNEL)
    least = run.work.get("fwd_least_s_traced")
    if len(times) != run.traced_steps or not least or sum(times) <= 0:
        return None
    return 100.0 * least / sum(times)
