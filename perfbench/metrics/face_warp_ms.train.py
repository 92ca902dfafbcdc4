"""Device ms a traced training step under the program's "bags.face_warp"
spans: each of the five faces' square mask, reprojection onto the face,
gather (`grid_sample`) and half mask, with their backward. Nested in
"bags.lens"; None where the program opens no such span."""

from layer_spans import layer_ms


def read(run):
    return layer_ms(run, "train", "face_warp")
