"""Device ms a traced view under the program's "bags.projection" spans:
the activations, the EWA projection and SH colour."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "render", "projection")
