"""K5, the bone splat (``csrc/bone_splat.cu``): for every pixel centre of
an S x S map and each of the 20 bones, the two endpoint features weighted
by the pixel's distance to them, where the pixel lies within the threshold
of the bone; (B, 21, 2) fp32 joints and (B, 21, C) features in, a
(B, S, S, 20 * C) map out.

Each input byte is counted once and each output byte once. The operations
are the two products and the sum of every output element, and the
geometry of every (pixel, bone) pair (about 30 operations)."""

KERNEL = "bone_splat"
GEOMETRY_OPS = 30


def work(batch: int, size: int, channels: int,
         itemsize: int = 2) -> tuple[float, float]:
    out = batch * size * size * 20 * channels
    flops = 3.0 * out + GEOMETRY_OPS * batch * size * size * 20
    nbytes = batch * 21 * 2 * 4 + batch * 21 * channels * itemsize \
        + out * itemsize
    return flops, float(nbytes)


def bound_s(peaks: dict, *shape, **kw) -> float:
    flops, nbytes = work(*shape, **kw)
    return max(flops / peaks["flops_per_s"]["float32"],
               nbytes / peaks["hbm_bytes_per_s"])
