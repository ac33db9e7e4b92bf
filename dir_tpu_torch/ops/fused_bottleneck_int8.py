"""Fused stride-1 ResNet bottleneck at int8 static-scale inference
(kernel K3).

Counterpart of
``dir_tpu/ops/pallas_bottleneck.py:fused_bottleneck_int8_infer``. The
weights arrive BN-folded in fp32 and are quantized per output channel
here; the three calibrated activation scales (the inputs of conv1, which
is also the projection's input, of conv2 and of conv3) are device scalars
and are never read on the host. On a CUDA tensor
:func:`fused_bottleneck_int8_infer` launches the hand-written Hopper kernel
of ``csrc/fused_bottleneck_int8.cu``, a persistent, warp-specialised
template (TMA halo loads, s8 ``wgmma`` products) whose form follows from
the widths: weights resident in shared memory (the layer1 shape) or
streamed through the ring of stages (the layer2 shape).
:func:`kernel_operands` lays the quantized weights out as the kernel reads
them and :func:`launch` launches on them; a caller may keep the operands
(``models/resnet.py:Bottleneck.k3_operands`` does). On a CPU tensor it runs
:func:`fused_bottleneck_int8_infer_plain`, the plain PyTorch version with
the kernel's rounding points. There is no other fallback: a CUDA tensor the
kernel does not take raises.

The kernel multiplies by ``1 / scale`` where ``ops/quant.py:quantize_act``
divides by the scale, as in the JAX package; the plain version follows the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops.fused_bottleneck import (_check, _pad, _panels,
                                              channel_order)
from dir_tpu_torch.ops.quant import (conv_s32, int_matmul,
                                     quantize_weight_per_channel)

NAME = "fused_bottleneck_int8"       # csrc/fused_bottleneck_int8.cu
# The dequantize is a product and a sum, each rounded in fp32, as in the
# plain version: no FMA contraction. -ldl: dlopen of the driver's
# cuTensorMapEncodeTiled.
NVCC_EXTRA_FLAGS = ("-fmad=false", "-ldl")
# The kernel's layout constants (csrc/fused_bottleneck_int8.cu), in bytes.
_MAX_SMEM = 232448                   # H100: dynamic shared memory of a block
_PANEL = 128                         # int8 K values (bytes) of a panel row
_X_SLOT = 25 * 1024                  # a halo box's stage
_XC = 16 * 8 * 128                   # the tile's own pixels, one box
_FIXED = 2 * 1024                    # alignment and the mbarriers
_HALO_ROWS, _Y1_SKEW = 192, 16       # xq, then y1q in its place
_MAX_STAGES, _MIN_RESIDENT_STAGES = 6, 3


def _quantize(v: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v.float() * inv_s), -127, 127).to(
        torch.int8)


def _quantized_operands(w1, w2, w3, wd, s_in, s_mid1, s_mid2):
    """Per-channel int8 weights, the three reciprocal activation scales and
    the dequantize vectors ``act_scale * w_scale[o]``; all on the device of
    the inputs, no host synchronisation."""
    mid = w1.shape[-1]
    f32 = torch.float32
    w1q, sw1 = quantize_weight_per_channel(w1)
    w2q, sw2 = quantize_weight_per_channel(w2.reshape(9 * mid, mid))
    w3q, sw3 = quantize_weight_per_channel(w3)
    s_in, s_mid1, s_mid2 = (s.to(f32).reshape(()) for s in
                            (s_in, s_mid1, s_mid2))
    inv = torch.stack([1.0 / s_in, 1.0 / s_mid1, 1.0 / s_mid2])
    wdq = md = None
    if wd is not None:
        wdq, swd = quantize_weight_per_channel(wd)
        md = s_in * swd
    return (w1q, w2q, w3q, wdq, inv, s_in * sw1, s_mid1 * sw2, s_mid2 * sw3,
            md)


def fused_bottleneck_int8_infer_plain(x, w1, b1, w2, b2, w3, b3, s_in,
                                      s_mid1, s_mid2, wd=None, bd=None,
                                      bands: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the fused int8 block, any float dtype, any
    device.

    Args:
        x: (B, H, W, C). w1: (C, M); w2: (3, 3, M, M); w3: (M, O); wd:
        optional (C, O) folded projection, identity residual if None;
        biases (M,), (M,), (O,), (O,); all folded, fp32. s_in, s_mid1,
        s_mid2: scalar activation scales. ``bands`` changes a schedule on
        the TPU, not the math, and is ignored here.
    Returns:
        (B, H, W, O) in x's dtype. Each conv input is quantized as
        ``clip(round(v * (1/s)), +-127)``; the s32 sums are exact; each is
        dequantized as ``s32 * m[o] + b`` in fp32 (two roundings), cast to
        x's dtype, then through ReLU; conv2's int8 windows are zero-padded;
        the residual is x itself or the int8 projection of the quantized x;
        the add and the last ReLU run in x's dtype.
    """
    dt = x.dtype
    b, h, w, c = x.shape
    mid = w1.shape[-1]
    w1q, w2q, w3q, wdq, inv, m1, m2, m3, md = _quantized_operands(
        w1, w2, w3, wd, s_in, s_mid1, s_mid2)

    def dequant(acc, m, bias):
        return (acc.float() * m + bias.float()).to(dt)

    xq = _quantize(x, inv[0]).reshape(b * h * w, c)
    y1 = torch.relu(dequant(int_matmul(xq, w1q), m1, b1))
    y1q = _quantize(y1, inv[1]).reshape(b, h, w, mid)
    a2 = conv_s32(y1q, w2q.reshape(3, 3, mid, mid), (1, 1), ((1, 1), (1, 1)))
    y2 = torch.relu(dequant(a2.reshape(b * h * w, mid), m2, b2))
    y3 = dequant(int_matmul(_quantize(y2, inv[2]), w3q), m3, b3)
    if wd is None:
        res = x.reshape(b * h * w, c)
    else:
        res = dequant(int_matmul(xq, wdq), md, bd)
    return torch.relu(y3 + res).reshape(b, h, w, -1)


def k_order(k: int, device=None) -> torch.Tensor:
    """The input channel at each of ``k`` (a multiple of 32) K positions of
    w3 in the image: in every group of 32, position ``16 half + 4 t + i``
    holds channel ``2 t + (idx % 2) + 8 (idx // 2)`` with
    ``idx = 4 half + i``. A thread (t = lane % 4) holds those channels,
    {2t, 2t+1, 2t+8, 2t+9, 2t+16, 2t+17, 2t+24, 2t+25}, in the s32
    accumulators of a 32-column group of conv2, where conv3's s8 k32 A
    fragment wants K positions {4t..4t+3, 4t+16..4t+19}: the kernel packs
    what it holds and the weights' K follows."""
    p = torch.arange(k, device=device)
    r = p % 32
    t, i = (r % 16) // 4, r % 4
    idx = 4 * (r // 16) + i
    return p - r + 2 * t + idx % 2 + 8 * (idx // 2)


class Layout(NamedTuple):
    """The kernel's shapes for one set of widths (``layout``)."""
    image_bytes: int   # of the int8 weight image
    smem: int          # dynamic shared memory of a block
    resident: bool     # w1, w2, w3 kept in shared memory (else streamed)
    stages: int        # of the ring
    nj: int            # conv3 chunks of mid output channels


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def layout(c: int, mid: int, o: int, has_down: bool) -> Layout:
    """The image size, shared memory and form of the kernel for these
    widths, as ``csrc/fused_bottleneck_int8.cu:layout`` computes them: the
    resident form where w1, w2 and w3 leave room for three stages."""
    ncp, nj = _ceil(c, _PANEL), _ceil(o, mid)
    panel = mid * _PANEL                       # one panel of mid rows
    wd_off = (ncp + _ceil(9 * mid, _PANEL) + _ceil(nj * mid, _PANEL)) * panel
    end = wd_off + (nj * ncp * panel if has_down else 0)

    def stage(resident):
        s = max(_X_SLOT, _XC + panel) if has_down else _X_SLOT
        if not resident:
            s = max(s, _X_SLOT + panel)
        return _ceil(s, 1024) * 1024

    def smem(resident, stages):
        xq = _ceil(_HALO_ROWS * max(_PANEL, mid + _Y1_SKEW), 1024) * 1024
        vectors = 4 * (4 * mid + 2 * nj * mid * (1 + has_down))
        return (_FIXED + stages * stage(resident)
                + (wd_off if resident else 0) + xq + vectors)

    def fit(resident):
        return next((s for s in range(_MAX_STAGES, 1, -1)
                     if smem(resident, s) <= _MAX_SMEM), 0)

    resident = fit(True) >= _MIN_RESIDENT_STAGES
    stages = fit(resident)
    return Layout(end, smem(resident, max(stages, 2)), resident, stages, nj)


@functools.lru_cache(maxsize=64)
def _image_index(c: int, mid: int, o: int, has_down: bool,
                 device: torch.device) -> torch.Tensor:
    """Where each byte of the weight image comes from: positions in
    ``[0, w1q, w2q, w3q, wdq]`` flattened and concatenated (0 is the zero of
    the padding). Every weight is an (N, K) K-major matrix of units side by
    side along K, cut into 128-wide swizzled panels (``_panels``), K
    zero-padded: w1 (mid, C); w2 (mid, 9 mid), tap t at K t * mid; w3
    (mid, nj * mid), conv3 chunk j at K j * mid; wd per chunk j (mid, C).
    The K of w3 is in :func:`k_order` (its A comes from registers; w1's and
    wd's from the quantized x in shared memory, in channel order), the N of
    w3 and wd in ``channel_order`` (O zero-padded to whole chunks). The
    layout is made once per shape by running the packing on the positions
    themselves; a call is then one gather."""
    lay = layout(c, mid, o, has_down)
    nj = lay.nj
    sizes = [c * mid, 9 * mid * mid, mid * o] + ([c * o] if has_down else [])
    pos = torch.arange(1, 1 + sum(sizes), dtype=torch.int32, device=device)
    w1, w2, w3, *wd = torch.split(pos, sizes)
    w1, w2, w3 = (w1.reshape(c, mid), w2.reshape(9, mid, mid),
                  w3.reshape(mid, o))
    op = nj * mid
    order = channel_order(op, device)

    def panels(m):                 # (N, K) -> panels, K padded to 128
        return _panels(_pad(m, m.shape[0], _ceil(m.shape[1], _PANEL) * _PANEL),
                       _PANEL)

    def out_rows(w):               # (K, O) -> (Op, K) in channel_order
        return _pad(w, w.shape[0], op)[:, order].t()

    parts = [panels(w1.t()),
             panels(torch.cat([w2[t].t() for t in range(9)], dim=1))]
    w3r = out_rows(w3[k_order(mid, device)])
    parts.append(panels(torch.cat([w3r[j * mid:(j + 1) * mid]
                                   for j in range(nj)], dim=1)))
    if has_down:
        wdr = out_rows(wd[0].reshape(c, o))
        parts += [panels(wdr[j * mid:(j + 1) * mid]) for j in range(nj)]
    index = torch.cat([t.reshape(-1) for t in parts])
    assert index.numel() == lay.image_bytes
    return index


class Operands(NamedTuple):
    """What the CUDA kernel reads beside ``x`` (:func:`kernel_operands`)."""
    image: torch.Tensor        # int8: the w1, w2, w3 (and wd) images, in order
    inv: torch.Tensor          # fp32 (3,): 1 / the activation scales
    m1: torch.Tensor           # fp32 (mid,): dequantize of conv1
    b1: torch.Tensor           # fp32 (mid,)
    m2: torch.Tensor           # fp32 (mid,)
    b2: torch.Tensor           # fp32 (mid,)
    m3: torch.Tensor           # fp32 (O,)
    b3: torch.Tensor           # fp32 (O,)
    md: torch.Tensor | None    # fp32 (O,), or None for the identity residual
    bd: torch.Tensor | None    # fp32 (O,), or None
    c: int
    mid: int
    o: int


def kernel_operands(w1, b1, w2, b2, w3, b3, s_in, s_mid1, s_mid2, wd=None,
                    bd=None) -> Operands:
    """What the CUDA kernel reads beside ``x``, made on the weights' device:
    the weights quantized per output channel and laid out in one int8 image
    (:func:`_image_index`: one gather), the reciprocal activation scales and
    the dequantize vectors ``act_scale * w_scale[o]`` and biases, fp32 in
    channel order. They depend on the block's weights and scales only, so a
    caller that serves many requests may keep them."""
    dev = w1.device
    c, mid = w1.shape
    o = w3.shape[-1]
    has_down = wd is not None
    _check(b1, "b1", (mid,), dev)
    _check(w2, "w2", (3, 3, mid, mid), dev)
    _check(b2, "b2", (mid,), dev)
    _check(w3, "w3", (mid, o), dev)
    _check(b3, "b3", (o,), dev)
    for name, s in (("s_in", s_in), ("s_mid1", s_mid1), ("s_mid2", s_mid2)):
        if s.device != dev:
            raise ValueError(f"{name} is on {s.device}, w1 on {dev}")
    if has_down:
        _check(wd, "wd", (c, o), dev)
        _check(bd, "bd", (o,), dev)
    elif o != c:
        raise ValueError(f"identity residual needs O == C, got {o} vs {c}")
    if c % 32 or o % 32 or mid not in (32, 64, 128):
        raise ValueError(f"C and O must be multiples of 32 and mid one of "
                         f"32, 64, 128; got {c}, {mid}, {o}")
    w1q, w2q, w3q, wdq, inv, m1, m2, m3, md = _quantized_operands(
        w1, w2, w3, wd, s_in, s_mid1, s_mid2)
    srcs = [w1q, w2q, w3q] + ([wdq] if has_down else [])
    flat = torch.cat([torch.zeros(1, dtype=torch.int8, device=dev)]
                     + [w.reshape(-1) for w in srcs])
    image = flat[_image_index(c, mid, o, has_down, dev)]
    f32 = [t if t is None else t.float().contiguous()
           for t in (inv, m1, b1, m2, b2, m3, b3, md, bd)]
    return Operands(image, *f32, c, mid, o)


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME, NVCC_EXTRA_FLAGS)


def bind(path: str) -> ctypes.CDLL:
    """Load a build of the kernel library and declare its C interface."""
    lib = ctypes.CDLL(path)
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_bottleneck_int8_bf16.argtypes = [vp] * 12 + [ci] * 7 + [vp]
    lib.fused_bottleneck_int8_bf16.restype = ci
    lib.fused_bottleneck_int8_image_bytes.argtypes = [ci] * 4
    lib.fused_bottleneck_int8_image_bytes.restype = ci
    lib.fused_bottleneck_int8_smem_bytes.argtypes = [ci] * 4 + [pi, pi]
    lib.fused_bottleneck_int8_smem_bytes.restype = ci
    lib.fused_bottleneck_int8_error_string.argtypes = [ci]
    lib.fused_bottleneck_int8_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    return bind(cuda_build.library_path(NAME))


def library_layout(lib: ctypes.CDLL, c: int, mid: int, o: int,
                   has_down: bool) -> tuple:
    """``(image bytes, shared memory, resident, stages)`` as the library
    computes them, to hold :func:`layout` against."""
    resident, stages = ctypes.c_int(), ctypes.c_int()
    smem = lib.fused_bottleneck_int8_smem_bytes(
        c, mid, o, int(has_down), ctypes.byref(resident),
        ctypes.byref(stages))
    return (lib.fused_bottleneck_int8_image_bytes(c, mid, o, int(has_down)),
            smem, bool(resident.value), stages.value)


def launch(x: torch.Tensor, operands: Operands) -> torch.Tensor:
    """Launch K3 on a CUDA ``x`` with the operands of
    :func:`kernel_operands`; raises on anything the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, H, W, C) tensor "
                         "(an NCHW tensor in channels_last, permuted)")
    b, h, w, c = x.shape
    op = operands
    if op.c != c or op.image.device != x.device:
        raise ValueError(f"the operands are for C={op.c} on "
                         f"{op.image.device}, x has C={c} on {x.device}")
    if b <= 0:
        raise ValueError(f"batch {b} is empty")
    lay = layout(c, op.mid, op.o, op.md is not None)
    if lay.smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={op.mid}, O={op.o} need {lay.smem} "
                         "bytes of shared memory, beyond the block's")
    # TMA, the bulk copies and the epilogue's vector loads read 16-byte
    # aligned addresses
    if any(t.data_ptr() % 16 for t in (x, *op[:10]) if t is not None):
        raise ValueError("x, the weight image and the vectors must be "
                         "16-byte aligned")
    out = launch_on(_library(), x, op)
    fused_bottleneck_int8_infer.launches += 1
    return out


def launch_on(lib: ctypes.CDLL, x: torch.Tensor,
              op: Operands) -> torch.Tensor:
    """One launch through ``lib`` (:func:`bind`) on checked inputs; counts
    nothing."""
    b, h, w, c = x.shape
    has_down = op.md is not None
    if op.image.numel() != lib.fused_bottleneck_int8_image_bytes(
            c, op.mid, op.o, int(has_down)):
        raise ValueError("the weight image does not have the kernel's size")
    out = torch.empty((b, h, w, op.o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_bottleneck_int8_bf16(
            x.data_ptr(), *(None if t is None else t.data_ptr()
                            for t in op[:10]),
            out.data_ptr(), b, h, w, c, op.mid, op.o, int(has_down), stream)
    if rc != 0:
        msg = lib.fused_bottleneck_int8_error_string(rc).decode()
        raise RuntimeError(f"fused int8 bottleneck launch failed: {msg}")
    return out


def fused_bottleneck_int8_infer(x, w1, b1, w2, b2, w3, b3, s_in, s_mid1,
                                s_mid2, wd=None, bd=None,
                                bands: int = 1) -> torch.Tensor:
    """One fused stride-1 bottleneck block, int8 with static scales.

    Same arguments and result as :func:`fused_bottleneck_int8_infer_plain`.
    ``H % bands`` must be 0, as in the JAX package, though the kernel's
    tiling does not depend on ``bands``. A CUDA ``x`` must be bf16 and
    NHWC-contiguous and goes to the kernel (:func:`kernel_operands`, some
    sixty small launches that quantize the weights and lay them out, then
    :func:`launch`); a CPU ``x`` goes to the plain version.
    ``fused_bottleneck_int8_infer.launches`` counts the kernel's launches,
    on the card only; ``.plain_runs`` counts the CPU calls that ran the
    plain version in its place.
    """
    if bands < 1 or x.shape[1] % bands:
        raise ValueError(f"bands={bands} must be >= 1 and divide "
                         f"H={x.shape[1]}")
    for name, s in (("s_in", s_in), ("s_mid1", s_mid1), ("s_mid2", s_mid2)):
        if not isinstance(s, torch.Tensor) or s.numel() != 1:
            raise TypeError(f"{name} must be a scalar tensor, a calibrated "
                            "scale: a dynamic scale is a reduction over the "
                            "whole batch, which no block of this kernel sees")
    if x.device.type == "cpu":
        fused_bottleneck_int8_infer.plain_runs += 1
        return fused_bottleneck_int8_infer_plain(
            x, w1, b1, w2, b2, w3, b3, s_in, s_mid1, s_mid2, wd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"no fused int8 bottleneck for device {x.device}")
    if w1.device != x.device:
        raise ValueError(f"w1 is on {w1.device}, x on {x.device}")
    return launch(x, kernel_operands(w1, b1, w2, b2, w3, b3, s_in, s_mid1,
                                     s_mid2, wd, bd))


fused_bottleneck_int8_infer.launches = 0
fused_bottleneck_int8_infer.plain_runs = 0
