"""Device ms a traced training step under the program's "bags.projection"
spans: the activations, the specular colour, the EWA projection and SH
colour, the densify probe and the sort key, with the backward of each."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "projection")
