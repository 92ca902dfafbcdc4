"""Device ms a traced training step under the program's "bags.loss" spans:
the masks and vignetting, L1 and SSIM with their backward, the step's
l1."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "loss")
