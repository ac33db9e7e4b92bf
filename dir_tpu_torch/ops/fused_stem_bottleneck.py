"""Stem BN + ReLU + 3x3/2 max pool + the projection bottleneck (layer1_0)
as one op, fed by the raw stem-conv output (kernel K4).

Counterpart of ``dir_tpu/ops/pallas_bottleneck.py:fused_stem_bottleneck``.
No model calls it, in the JAX package or here: it stands alone, with its
tests. On a CUDA tensor :func:`fused_stem_bottleneck` launches the
hand-written Hopper kernel of ``csrc/fused_stem_bottleneck.cu``; on a CPU
tensor it runs :func:`fused_stem_bottleneck_plain`, the plain PyTorch
version with the same rounding points. There is no other fallback: a CUDA
tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops.fused_bottleneck import fused_bottleneck_infer_plain

NAME = "fused_stem_bottleneck"       # csrc/fused_stem_bottleneck.cu
# H100: dynamic shared memory one block may use.
_MAX_SMEM = 232448


def fused_stem_bottleneck_plain(x, g1, t1, w1, b1, w2, b2, w3, b3, wd,
                                bd) -> torch.Tensor:
    """Plain PyTorch version, any float dtype, any device.

    Args:
        x: (B, 2H, 2W, C) raw stem-conv output. g1, t1: (C,) inference-BN
        affine (g = scale / sqrt(var + eps), t = bias - mean * g). w1
        (C, M), b1 (M,), w2 (3, 3, M, M), b2 (M,), w3 (M, O), b3 (O,): the
        folded bottleneck; wd (C, O), bd (O,): its folded projection.
    Returns:
        (B, H, W, O) in x's dtype. The affine runs in x's dtype with g1 and
        t1 cast to it (product and sum each rounded), then ReLU and the
        3x3 stride-2 max pool with padding 1, then the projection form of
        ``fused_bottleneck_infer_plain``.
    """
    dt = x.dtype
    a = torch.relu(x * g1.to(dt) + t1.to(dt))
    pooled = F.max_pool2d(a.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    return fused_bottleneck_infer_plain(pooled, w1, b1, w2, b2, w3, b3, wd,
                                        bd)


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    sources; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(cuda_build.library_path(NAME))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_stem_bottleneck_bf16.argtypes = [vp] * 12 + [ci] * 6 + [vp]
    lib.fused_stem_bottleneck_bf16.restype = ci
    lib.fused_stem_bottleneck_smem_bytes.argtypes = [ci, ci, ci]
    lib.fused_stem_bottleneck_smem_bytes.restype = ci
    lib.fused_stem_bottleneck_error_string.argtypes = [ci]
    lib.fused_stem_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd) -> torch.Tensor:
    """Launch K4 on a CUDA ``x``; raises on anything the kernel does not
    take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, 2H, 2W, C) tensor")
    b, h2, w2_, c = x.shape
    h, w = h2 // 2, w2_ // 2
    mid, o = w1.shape[-1], w3.shape[-1]
    dev = x.device
    shapes = (("g1", g1, (c,)), ("t1", t1, (c,)), ("w1", w1, (c, mid)),
              ("b1", b1, (mid,)), ("w2", w2, (3, 3, mid, mid)),
              ("b2", b2, (mid,)), ("w3", w3, (mid, o)), ("b3", b3, (o,)),
              ("wd", wd, (c, o)), ("bd", bd, (o,)))
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if c % 16 or o % 16 or mid not in (16, 32, 64, 128):
        raise ValueError(f"C and O must be multiples of 16 and mid one of "
                         f"16, 32, 64, 128; got {c}, {mid}, {o}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    lib = _library()
    smem = lib.fused_stem_bottleneck_smem_bytes(c, mid, o)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={mid}, O={o} need {smem} bytes of "
                         "shared memory, beyond the block's")
    bf = torch.bfloat16
    ws = [t.to(bf).contiguous() for t in (w1, w2, w3, wd)]
    fs = [t.float().contiguous() for t in (g1, t1, b1, b2, b3, bd)]
    # WMMA reads 32-byte-aligned operands, the raw loads 16-byte vectors
    if x.data_ptr() % 16 or any(t.data_ptr() % 32 for t in ws):
        raise ValueError("x must be 16-byte and the weights 32-byte aligned")
    out = torch.empty((b, h, w, o), dtype=bf, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_stem_bottleneck_bf16(
            x.data_ptr(), fs[0].data_ptr(), fs[1].data_ptr(),
            ws[0].data_ptr(), fs[2].data_ptr(), ws[1].data_ptr(),
            fs[3].data_ptr(), ws[2].data_ptr(), fs[4].data_ptr(),
            ws[3].data_ptr(), fs[5].data_ptr(), out.data_ptr(),
            b, h, w, c, mid, o, stream)
    if rc != 0:
        msg = lib.fused_stem_bottleneck_error_string(rc).decode()
        raise RuntimeError(f"fused stem bottleneck launch failed: {msg}")
    fused_stem_bottleneck.launches += 1
    return out


def fused_stem_bottleneck(x, g1, t1, w1, b1, w2, b2, w3, b3, wd,
                          bd) -> torch.Tensor:
    """Stem BN + ReLU + max pool + layer1_0 in one op.

    Same arguments and result as :func:`fused_stem_bottleneck_plain`. The
    pooled height must be a multiple of 4 and the input's height and width
    even, as in the JAX package. A CUDA ``x`` must be bf16 and contiguous
    and goes to the kernel; a CPU ``x`` goes to the plain version.
    ``fused_stem_bottleneck.launches`` counts the kernel's launches, on the
    card only; ``.plain_runs`` counts the CPU calls that ran the plain
    version in its place.
    """
    if x.dim() != 4:
        raise ValueError("x must be (B, 2H, 2W, C)")
    _, h2, w2_, _ = x.shape
    if h2 % 2 or w2_ % 2 or (h2 // 2) % 4:
        raise ValueError("fused_stem_bottleneck needs an even input height "
                         "and width and a pooled height that is a multiple "
                         f"of 4, got input {tuple(x.shape)}")
    if x.device.type == "cpu":
        fused_stem_bottleneck.plain_runs += 1
        return fused_stem_bottleneck_plain(x, g1, t1, w1, b1, w2, b2, w3, b3,
                                           wd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"no fused stem bottleneck for device {x.device}")
    return _launch(x, g1, t1, w1, b1, w2, b2, w3, b3, wd, bd)


fused_stem_bottleneck.launches = 0
fused_stem_bottleneck.plain_runs = 0
