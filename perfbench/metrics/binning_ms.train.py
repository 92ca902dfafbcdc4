"""Device ms a traced training step under the program's "bags.binning"
and "bags.gather" spans: the tile binning and its sort, the packet table
and its gather by instance, and the gather's backward (`index_add_`)."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "binning", "gather")
