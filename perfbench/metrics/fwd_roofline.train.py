"""The forward compositing kernel's share of its roofline in the traced
training steps: the frozen bound (`counts.fwd_bytes`, `counts.fwd_ops` on
the reference binning of each render of a step) over the kernel's device
time in those steps, in %. A driver that makes several renders a step
reports `renders_per_step` in its work: the trace then holds that many
launches of the kernel a traced step, and the bound sums all of them."""

KERNEL = "composite_fwd_kernel"


def read(run):
    if run.driver != "train" or run.trace is None:
        return None
    times = run.trace.kernels(KERNEL)
    renders = run.work.get("renders_per_step", 1)
    least = run.work.get("fwd_least_s_traced")
    if len(times) != renders * run.traced_steps or not least or sum(times) <= 0:
        return None
    return 100.0 * least / sum(times)
