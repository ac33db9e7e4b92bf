"""Fused stride-1 ResNet bottleneck at int8 static-scale inference
(kernel K3).

Counterpart of
``dir_tpu/ops/pallas_bottleneck.py:fused_bottleneck_int8_infer``. The
weights arrive BN-folded in fp32 and are quantized per output channel
here; the three calibrated activation scales (the inputs of conv1, which
is also the projection's input, of conv2 and of conv3) are device scalars
and are never read on the host. On a CUDA tensor
:func:`fused_bottleneck_int8_infer` launches the hand-written Hopper kernel
of ``csrc/fused_bottleneck_int8.cu``; on a CPU tensor it runs
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

import torch

from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops.quant import (conv_s32, int_matmul,
                                     quantize_weight_per_channel)

NAME = "fused_bottleneck_int8"       # csrc/fused_bottleneck_int8.cu
# The dequantize is a product and a sum, each rounded in fp32, as in the
# plain version: no FMA contraction.
NVCC_EXTRA_FLAGS = ("-fmad=false",)
# H100: dynamic shared memory one block may use.
_MAX_SMEM = 232448


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


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME, NVCC_EXTRA_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(cuda_build.library_path(NAME))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck_int8_bf16.argtypes = [vp] * 15 + [ci] * 7 + [vp]
    lib.fused_bottleneck_int8_bf16.restype = ci
    lib.fused_bottleneck_int8_smem_bytes.argtypes = [ci, ci, ci]
    lib.fused_bottleneck_int8_smem_bytes.restype = ci
    lib.fused_bottleneck_int8_error_string.argtypes = [ci]
    lib.fused_bottleneck_int8_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def _kernel_order(wq: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> (N, K) contiguous, the rows of every group of 32
    output channels in the order the kernel's accumulator fragments hold
    them: row ``j*8 + n`` of a group is channel ``(n>>1)*8 + j*2 + (n&1)``,
    so that a thread's eight values of four 16x8 fragments are eight
    consecutive channels (one 16-byte store)."""
    n = wq.shape[1]
    p = torch.arange(32, device=wq.device)
    j, n8 = p // 8, p % 8
    within = (n8 // 2) * 8 + j * 2 + (n8 % 2)
    rows = (torch.arange(0, n, 32, device=wq.device)[:, None]
            + within[None, :]).reshape(-1)
    return wq.t()[rows].contiguous()


def kernel_operands(w1, b1, w2, b2, w3, b3, s_in, s_mid1, s_mid2, wd=None,
                    bd=None) -> tuple:
    """What the CUDA kernel reads beside ``x``, made on the weights' device:
    ``(inv, w1t, m1, b1, w2t, m2, b2, w3t, m3, b3, wdt, md, bd)`` with the
    int8 weights output-channel major in the kernel's order
    (:func:`_kernel_order`) and every vector fp32 and contiguous; the last
    three None without a projection. They depend on the block's weights and
    scales only, so a caller that serves many requests may keep them."""
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
    w2t = torch.stack([_kernel_order(t) for t in w2q.reshape(9, mid, mid)])
    ops = [inv, _kernel_order(w1q), m1, b1, w2t, m2, b2, _kernel_order(w3q),
           m3, b3]
    ops += [_kernel_order(wdq), md, bd] if has_down else [None, None, None]
    return tuple(t if t is None or t.dtype == torch.int8
                 else t.float().contiguous() for t in ops)


def launch(x: torch.Tensor, operands: tuple) -> torch.Tensor:
    """Launch K3 on a CUDA ``x`` with the ``operands`` of
    :func:`kernel_operands`; raises on anything the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, H, W, C) tensor "
                         "(an NCHW tensor in channels_last, permuted)")
    b, h, w, c = x.shape
    w1t, w3t = operands[1], operands[7]
    mid, o = w1t.shape[0], w3t.shape[0]
    if w1t.shape[1] != c or w1t.device != x.device:
        raise ValueError(f"the operands are for C={w1t.shape[1]} on "
                         f"{w1t.device}, x has C={c} on {x.device}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    lib = _library()
    smem = lib.fused_bottleneck_int8_smem_bytes(c, mid, o)
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={mid}, O={o} need {smem} bytes of "
                         "shared memory, beyond the block's")
    if x.data_ptr() % 16 or any(t.data_ptr() % 16 for t in operands
                                if t is not None and t.dtype == torch.int8):
        raise ValueError("x and the weights must be 16-byte aligned")
    out = torch.empty((b, h, w, o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_bottleneck_int8_bf16(
            x.data_ptr(),
            *(None if t is None else t.data_ptr() for t in operands),
            out.data_ptr(), b, h, w, c, mid, o,
            int(operands[10] is not None), stream)
    if rc != 0:
        msg = lib.fused_bottleneck_int8_error_string(rc).decode()
        raise RuntimeError(f"fused int8 bottleneck launch failed: {msg}")
    fused_bottleneck_int8_infer.launches += 1
    return out


def fused_bottleneck_int8_infer(x, w1, b1, w2, b2, w3, b3, s_in, s_mid1,
                                s_mid2, wd=None, bd=None,
                                bands: int = 1) -> torch.Tensor:
    """One fused stride-1 bottleneck block, int8 with static scales.

    Same arguments and result as :func:`fused_bottleneck_int8_infer_plain`.
    ``H % bands`` must be 0, as in the JAX package, though the kernel's
    tiling does not depend on ``bands``. A CUDA ``x`` must be bf16 and
    NHWC-contiguous and goes to the kernel (:func:`kernel_operands`, some
    sixty small launches that quantize and order the weights, then
    :func:`launch`); a CPU ``x`` goes to the plain version. ``fused_bottleneck_int8_infer.launches`` counts the kernel's
    launches, on the card only; ``.plain_runs`` counts the CPU calls that
    ran the plain version in its place.
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
