"""Device ms a traced training step under the program's own "bags.lens"
spans: the lens flow (the iResNet's Newton inverse, its upsampling) and
the warp and crop, with their backward. It reads the same work as
`lens_ms.fisheye`, from the program's span instead of the benchmark's."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "lens")
