"""Device ms a traced training step under the program's "bags.composite"
spans: the forward compositing kernel, the background blend and the tiles
to image, and their backward (the backward compositing kernel)."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "composite")
