"""K1's share of its roofline in the profiled slice, in %: the least time
the chip needs for every K1 launch of the slice (``rooflines/k1.py`` at
layer1's shape, the activation of the batch at a quarter of the crop, 256
channels, mid 64) over K1's device time summed by kernel name."""

from portbench import harness
from portbench.rooflines import k1


def read(found):
    trace = found["trace"]
    launches = trace.kernels(k1.KERNEL) if trace else []
    if not launches:
        return None
    cfg, batch = found["run"].cfg, found["run"].traffic["batch"]
    side = cfg["image_size"] // 4
    c = cfg["backbone_dims"][0]
    bound = k1.bound_s(harness.peaks(), batch, side, side, c, c // 4, c)
    spent = sum(e - s for _, s, e in launches) * 1e-6
    return 100.0 * bound * len(launches) / spent
