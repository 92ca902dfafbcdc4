"""Device ms a traced training step that no layer span of the program
covers: the host-traced segment's device time (every kernel, copy and set
summed) less the device time of "bags.projection", "bags.binning",
"bags.gather", "bags.composite", "bags.loss", "bags.optimizers" and
"bags.lens" (the gradients' copies into the leaves, the step's own small
work)."""

from layer_spans import TRAIN_LAYERS, other_ms


def read(run):
    return other_ms(run, "train", TRAIN_LAYERS)
