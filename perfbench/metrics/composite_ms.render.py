"""Device ms a traced view under the program's "bags.composite" spans: the
forward compositing kernel, the background blend and the tiles to
image."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "render", "composite")
