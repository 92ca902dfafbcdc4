"""Device ms a traced view under the program's "bags.binning" and
"bags.gather" spans: the tile binning and its sort, the packet table and
its gather by instance."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "render", "binning", "gather")
