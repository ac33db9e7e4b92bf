"""The whole step's share of the chip's bf16 dense peak over the window,
in %: the model FLOPs of one image (``flops_per_image`` of the
configuration's file, counted on the plain reference by
``portbench/flops.py``: the forward, or for a train step its forward, loss
and backward, as the driver says) times the images of the window outside
the profiled slice, over that time and the peak."""

from portbench import harness


def read(found):
    run = found["run"]
    if found["images"] == 0 or run.device.type != "cuda":
        return None
    per = run.cfg["flops_per_image"][found["flops"]]
    peak = harness.peaks()["flops_per_s"]["bfloat16"]
    return 100.0 * per * found["images"] / found["elapsed_s"] / peak
