"""K1, the fused bf16 bottleneck (``csrc/fused_bottleneck.cu``, identity
form): conv1x1 (C -> mid), conv3x3 (mid -> mid), conv1x1 (mid -> O), each
with its folded BatchNorm and ReLU, the residual add and the last ReLU, on
an NHWC bf16 activation.

Each input byte is counted once and each output byte once, whatever the
kernel reads again: the activation in, the folded weights (bf16) and
biases (fp32), the activation out."""

KERNEL = "fused_bottleneck_kernel"


def work(batch: int, h: int, w: int, c: int, mid: int, out: int,
         itemsize: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of one launch."""
    px = batch * h * w
    flops = 2.0 * px * (c * mid + 9 * mid * mid + mid * out)
    weights = (c * mid + 9 * mid * mid + mid * out) * itemsize
    biases = (mid + mid + out) * 4
    acts = px * (c + out) * itemsize
    return flops, float(acts + weights + biases)


def bound_s(peaks: dict, *shape, **kw) -> float:
    flops, nbytes = work(*shape, **kw)
    return max(flops / peaks["flops_per_s"]["bfloat16"],
               nbytes / peaks["hbm_bytes_per_s"])
