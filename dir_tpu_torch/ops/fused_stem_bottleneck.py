"""Stem BN + ReLU + 3x3/2 max pool + the projection bottleneck (layer1_0)
as one op, fed by the raw stem-conv output (kernel K4).

Counterpart of ``dir_tpu/ops/pallas_bottleneck.py:fused_stem_bottleneck``.
No model calls it, in the JAX package or here: it stands alone, with its
tests. On a CUDA tensor :func:`fused_stem_bottleneck` launches the
hand-written Hopper kernel of ``csrc/fused_stem_bottleneck.cu``, a
persistent, warp-specialised kernel (raw row strips by TMA, the pool in
shared memory, ``wgmma`` products); :func:`kernel_operands` lays the folded
weights out as the kernel reads them and :func:`launch` launches on them. On
a CPU tensor it runs :func:`fused_stem_bottleneck_plain`, the plain PyTorch
version with the same rounding points. There is no other fallback: a CUDA
tensor the kernel does not take raises.

The kernel is the PyTorch op ``torch.ops.dir_tpu.fused_stem_bottleneck``
on the operands (:func:`call`): its CUDA implementation is :func:`launch`,
its CPU implementation unpacks the operands and runs the plain version, and
its fake implementation gives the output's shape. The wrapper lays the
operands out in the activations' dtype (:func:`pack`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops import fused_bottleneck as fb

NAME = "fused_stem_bottleneck"       # csrc/fused_stem_bottleneck.cu
NVCC_EXTRA_FLAGS = ("-ldl",)       # dlopen of the CUDA driver's cuTensorMapEncodeTiled
# The kernel's layout constants (csrc/fused_stem_bottleneck.cu), in bytes.
_MAX_SMEM = 232448                   # H100: dynamic shared memory of a block
_ROW = 128                           # a strip, halo or weight panel row
_STRIP_SLOT = 24 * 1024              # a raw strip's stage
_FIXED = 2 * 1024                    # alignment and the mbarriers
_HALO_ROWS, _Y1_SKEW = 192, 8        # the pooled halo, then y1 in its place
_GT = 2 * 64 * 2                     # g1 and t1, bf16, padded to 64 channels
_MAX_STAGES = 4
_KC = 64                             # the kernel takes C up to one 64-wide panel
_MIDS = (16, 32, 64)


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
    return fb.fused_bottleneck_infer_plain(pooled, w1, b1, w2, b2, w3, b3,
                                           wd, bd)


class Operands(NamedTuple):
    """What the CUDA kernel reads beside ``x`` (:func:`kernel_operands`)."""
    image: torch.Tensor   # bf16: w1, w2, w3, wd as K1's projection form
    vec: torch.Tensor     # fp32: b1, b2 (mid), b3, bd (O padded to chunks)
    gt: torch.Tensor      # bf16 (2, 64): g1, t1, zero-padded
    c: int
    mid: int
    o: int


class Layout(NamedTuple):
    """The kernel's shapes for one set of widths (:func:`layout`)."""
    image_bytes: int      # of the bf16 weight image
    smem: int             # dynamic shared memory of a block
    stages: int           # of the ring of raw strips


@functools.lru_cache(maxsize=64)
def layout(c: int, mid: int, o: int) -> Layout:
    """The image size, shared memory and stages of the kernel for these
    widths, as ``csrc/fused_stem_bottleneck.cu:layout`` computes them."""
    n3 = fb.conv3_chunk(mid)
    op = -(-o // n3) * n3
    image = (mid + 9 * mid + 2 * op) * _ROW     # w1, w2's taps, w3, wd
    halo = -(-_HALO_ROWS * max(_ROW, 2 * (mid + _Y1_SKEW)) // 1024) * 1024
    fixed = _FIXED + image + halo + _GT + 4 * (2 * mid + 2 * op)
    stages = next((s for s in range(_MAX_STAGES, 1, -1)
                   if fixed + s * _STRIP_SLOT <= _MAX_SMEM), 2)
    return Layout(image, fixed + stages * _STRIP_SLOT, stages)


def kernel_operands(g1, t1, w1, b1, w2, b2, w3, b3, wd, bd) -> Operands:
    """The folded weights and the BN affine as the kernel reads them, made
    on their device. The weight image is K1's for the projection form
    (``fused_bottleneck.kernel_operands``: one gather from a per-shape
    index); the biases are one fp32 vector, b3 and bd zero-padded to whole
    conv3 chunks; g1 and t1 are cast to bf16, as the plain version casts
    them, and zero-padded to 64 channels. A caller may keep the result."""
    check_widths(w1.shape[0], w1.shape[1])
    return pack(g1, t1, w1, b1, w2, b2, w3, b3, wd, bd)


def check_widths(c: int, mid: int) -> None:
    """Raise unless the kernel takes these widths."""
    if c > _KC or mid not in _MIDS:
        raise ValueError(f"the stem kernel takes C up to {_KC} and mid one "
                         f"of {_MIDS}; got C={c}, mid={mid}")


def pack(g1, t1, w1, b1, w2, b2, w3, b3, wd, bd,
         dtype=torch.bfloat16) -> Operands:
    """:func:`kernel_operands` without the kernel's width check (C up to 64
    still), the image and g1, t1 in ``dtype``, for the plain route of the
    op (:func:`unpack` inverts it)."""
    dev = w1.device
    c, mid = w1.shape
    o = w3.shape[-1]
    for name, t in (("g1", g1), ("t1", t1)):
        fb._check(t, name, (c,), dev)
    if c > _KC:
        raise ValueError(f"the stem kernel takes C up to {_KC}, got {c}")
    ops = fb.pack(w1, b1, w2, b2, w3, b3, wd, bd, bands=0, dtype=dtype)
    op = _padded_o(mid, o)
    vec = torch.cat([ops.b1, ops.b2, F.pad(ops.b3, (0, op - o)),
                     F.pad(ops.bd, (0, op - o))])
    gt = F.pad(torch.stack([g1, t1]).to(dtype), (0, _KC - c))
    return Operands(ops.image, vec, gt.contiguous(), c, mid, o)


def _padded_o(mid: int, o: int) -> int:
    n3 = fb.conv3_chunk(mid)
    return -(-o // n3) * n3


def unpack(operands: Operands) -> list:
    """``[g1, t1, w1, b1, w2, b2, w3, b3, wd, bd]`` from operands of
    :func:`pack`, the weights and g1, t1 in the image's dtype; exact."""
    op = operands
    w1, w2, w3, wd = fb.unpack_weights(op.image, op.c, op.mid, op.o, True)
    b1, b2, b3, bd = torch.split(op.vec, [op.mid, op.mid] + [
        _padded_o(op.mid, op.o)] * 2)
    return [op.gt[0, :op.c], op.gt[1, :op.c], w1, b1, w2, b2, w3,
            b3[:op.o], wd, bd[:op.o]]


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    sources; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME, NVCC_EXTRA_FLAGS)


def bind(path: str) -> ctypes.CDLL:
    """Load a build of the kernel library and declare its C interface."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_stem_bottleneck_bf16.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.fused_stem_bottleneck_bf16.restype = ci
    lib.fused_stem_bottleneck_layout.argtypes = [ci] * 3 + [vp]
    lib.fused_stem_bottleneck_layout.restype = ci
    lib.fused_stem_bottleneck_error_string.argtypes = [ci]
    lib.fused_stem_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    return bind(cuda_build.library_path(NAME))


def library_layout(lib: ctypes.CDLL, c: int, mid: int, o: int) -> Layout:
    """:class:`Layout` as the library computes it, to hold :func:`layout`
    against; raises for widths it does not take."""
    out = (ctypes.c_int * 3)()
    if lib.fused_stem_bottleneck_layout(c, mid, o, out) != 0:
        raise ValueError(f"the stem kernel does not take C={c}, mid={mid}, "
                         f"O={o}")
    return Layout(*out)


def launch(x: torch.Tensor, operands: Operands) -> torch.Tensor:
    """Launch K4 on a CUDA ``x`` with the operands of
    :func:`kernel_operands`; raises on anything the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, 2H, 2W, C) tensor")
    b, h2, w2, c = x.shape
    op = operands
    if op.c != c or op.image.device != x.device:
        raise ValueError(f"the operands are for C={op.c} on "
                         f"{op.image.device}, x has C={c} on {x.device}")
    if b <= 0 or h2 % 2 or w2 % 2:
        raise ValueError(f"x {tuple(x.shape)}: needs a batch and an even "
                         "height and width")
    check_widths(c, op.mid)
    if op.image.dtype != torch.bfloat16 or op.gt.dtype != torch.bfloat16:
        raise TypeError("the CUDA kernel takes a bf16 image and BN affine")
    # TMA and the bulk copies read 16-byte aligned addresses
    if any(t.data_ptr() % 16 for t in (x, *op[:3])):
        raise ValueError("x and the operands must be 16-byte aligned")
    smem = layout(c, op.mid, op.o).smem
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={op.mid}, O={op.o} need {smem} bytes "
                         "of shared memory, beyond the block's")
    out = launch_on(_library(), x, op)
    fused_stem_bottleneck.launches += 1
    return out


def launch_on(lib: ctypes.CDLL, x: torch.Tensor, op: Operands) -> torch.Tensor:
    """One launch through ``lib`` (:func:`bind`) on checked inputs; counts
    nothing."""
    b, h2, w2, c = x.shape
    if op.image.numel() * 2 != layout(c, op.mid, op.o).image_bytes:
        raise ValueError("the weight image does not have the kernel's size")
    out = torch.empty((b, h2 // 2, w2 // 2, op.o), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_stem_bottleneck_bf16(
            x.data_ptr(), op.image.data_ptr(), op.vec.data_ptr(),
            op.gt.data_ptr(), out.data_ptr(), b, h2 // 2, w2 // 2, c, op.mid,
            op.o, stream)
    if rc != 0:
        msg = lib.fused_stem_bottleneck_error_string(rc).decode()
        raise RuntimeError(f"fused stem bottleneck launch failed: {msg}")
    return out


@torch.library.custom_op(
    "dir_tpu::fused_stem_bottleneck", mutates_args=(), device_types="cpu",
    schema="(Tensor x, Tensor image, Tensor vec, Tensor gt, int mid, int o) "
           "-> Tensor")
def _op(x, image, vec, gt, mid, o):
    """The CPU implementation: the plain version on the unpacked operands."""
    fused_stem_bottleneck.plain_runs += 1
    return fused_stem_bottleneck_plain(
        x, *unpack(Operands(image, vec, gt, x.shape[-1], mid, o)))


@_op.register_kernel("cuda")
def _op_cuda(x, image, vec, gt, mid, o):
    return launch(x, Operands(image, vec, gt, x.shape[-1], mid, o))


@_op.register_fake
def _op_fake(x, image, vec, gt, mid, o):
    b, h2, w2, _ = x.shape
    return x.new_empty((b, h2 // 2, w2 // 2, o))


def call(x: torch.Tensor, operands: Operands) -> torch.Tensor:
    """``torch.ops.dir_tpu.fused_stem_bottleneck`` on ``x`` and the
    operands: K4 on the card, the plain version on the CPU."""
    op = operands
    return torch.ops.dir_tpu.fused_stem_bottleneck(x, op.image, op.vec,
                                                   op.gt, op.mid, op.o)


def fused_stem_bottleneck(x, g1, t1, w1, b1, w2, b2, w3, b3, wd,
                          bd) -> torch.Tensor:
    """Stem BN + ReLU + max pool + layer1_0 in one op.

    Same arguments and result as :func:`fused_stem_bottleneck_plain`. The
    pooled height must be a multiple of 4 and the input's height and width
    even, as in the JAX package. The operands are laid out in ``x``'s dtype
    (:func:`pack`) and go with ``x`` to the op (:func:`call`): a CUDA ``x``
    must be bf16 and contiguous and goes to the kernel (:func:`launch`); a
    CPU ``x`` goes to the plain version. ``fused_stem_bottleneck.launches``
    counts the kernel's launches, on the card only; ``.plain_runs`` counts
    the CPU calls that ran the plain version in its place.
    """
    if x.dim() != 4:
        raise ValueError("x must be (B, 2H, 2W, C)")
    _, h2, w2_, _ = x.shape
    if h2 % 2 or w2_ % 2 or (h2 // 2) % 4:
        raise ValueError("fused_stem_bottleneck needs an even input height "
                         "and width and a pooled height that is a multiple "
                         f"of 4, got input {tuple(x.shape)}")
    fb.check_device(x, w1)
    return call(x, pack(g1, t1, w1, b1, w2, b2, w3, b3, wd, bd, x.dtype))


fused_stem_bottleneck.launches = 0
fused_stem_bottleneck.plain_runs = 0
