"""K5's share of its roofline in the profiled train steps, in %: the least
time the chip needs for the splats of every step (``rooflines/k5.py``:
both hands at each refine stage's map size, a sixteenth and an eighth of
the crop) over K5's device time summed by kernel name."""

from portbench import harness
from portbench.rooflines import k5


def read(found):
    trace = found["trace"]
    launches = trace.kernels(k5.KERNEL) if trace else []
    if not launches:
        return None
    cfg, batch = found["run"].cfg, found["run"].traffic["batch"]
    sizes = [cfg["image_size"] // 16, cfg["image_size"] // 8]
    per_step = 2 * len(sizes)
    if len(launches) != per_step * trace.units:
        return None
    peaks = harness.peaks()
    bound = trace.units * sum(2 * k5.bound_s(peaks, batch, s,
                                             cfg["joint_dim"])
                              for s in sizes)
    spent = sum(e - s for _, s, e in launches) * 1e-6
    return 100.0 * bound / spent
