"""Device ms a traced training step under the program's "bags.cubemap_rays"
spans: the cubemap ray field (the tan warp of the pixel grid, the cubemap
net's forward residual on the control grid, its upsample) and its
backward. Nested in "bags.lens"; None where the program opens no such
span."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "cubemap_rays")
