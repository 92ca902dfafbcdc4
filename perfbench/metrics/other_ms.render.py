"""Device ms a traced view that no layer span of the program covers: the
host-traced segment's device time (every kernel, copy and set summed) less
the device time of "bags.projection", "bags.binning", "bags.gather" and
"bags.composite" (the driver's copy into the client's page-locked
buffer)."""

from layer_spans import RENDER_LAYERS, other_ms


def read(run):
    return other_ms(run, "render", RENDER_LAYERS)
