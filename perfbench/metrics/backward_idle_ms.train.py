"""Device idle ms a traced training step while the host is inside the
program's "bags.backward" span (`loss.backward()`): gaps of the
host-traced segment's device timeline whose middle lies in the span."""

from layer_spans import idle_ms_inside


def read(run):
    return idle_ms_inside(run, "train", "backward")
