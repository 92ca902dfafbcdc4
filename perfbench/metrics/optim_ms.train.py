"""Device ms a traced training step under the program's "bags.optimizers"
spans: the gradients' zeroing, every Adam step and the densify
statistics."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "optimizers")
