"""Device ms a training step of the kernels launched under the program's
lens flow and warp (`calib/distortion.py::compute_flow`,
`apply_distortion`, the iResNet inverse of `calib/iresnet.py` inside
them) and under the backward nodes their operations created: the
benchmark's "bench.lens" spans in the traced steps, matched to the
backward by the autograd sequence numbers the profiler records."""


def read(run):
    if run.driver != "train" or run.lens_s is None or not run.traced_steps:
        return None
    if run.lens_s <= 0:
        return None
    return 1e3 * run.lens_s / run.traced_steps
