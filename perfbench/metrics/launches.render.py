"""Kernel launches a traced view made on the main thread inside the
program's "bags.render" and "bags.projection" spans: the view's launches
but the driver's copy."""

from layer_spans import launches


def read(run):
    return launches(run, "render", ("render", "projection"))
