"""Fused stride-1 ResNet bottleneck at inference (kernels K1 and K2).

Counterpart of ``dir_tpu/ops/pallas_bottleneck.py:fused_bottleneck_infer``.
On a CUDA tensor :func:`fused_bottleneck_infer` launches a hand-written
Hopper kernel from ``csrc/fused_bottleneck.cu``: with ``bands=0`` K1, which
keeps a tile's whole input halo and each phase's weights in shared memory
(the layer1 shape), and with ``bands>0`` K2, which streams the input and
the weights through shared memory in chunks and so takes any width (the
layer2 shape, where K1's working set does not fit). On a CPU tensor it
runs :func:`fused_bottleneck_infer_plain`, the plain PyTorch version with
the same rounding points; banding changes a schedule, not the math, so
one plain version serves both. There is no other fallback: a CUDA tensor
a kernel does not take raises.

The kernels are compiled at first use (``ops/cuda_build.py``) from this
package's sources only, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dir_tpu_torch.ops import cuda_build

NAME = "fused_bottleneck"            # csrc/fused_bottleneck.cu
# H100: dynamic shared memory one block may use.
_MAX_SMEM = 232448


def fold_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    """Fold an inference BatchNorm into the preceding conv, in fp32:
    BN(conv(x, W)) == conv(x, W * g) + (b - m * g), g = scale/sqrt(var+eps).
    kernel: (..., O) (output channels last); returns fp32 (kernel, bias)."""
    g = (scale / torch.sqrt(var + eps)).float()
    return kernel.float() * g, bias.float() - mean.float() * g


def fused_bottleneck_infer_plain(x, w1, b1, w2, b2, w3, b3, wd=None,
                                 bd=None) -> torch.Tensor:
    """Plain PyTorch version of the fused block, any float dtype, any
    device.

    Args:
        x: (B, H, W, C). w1: (C, M); w2: (3, 3, M, M); w3: (M, O);
        wd: optional (C, O) folded projection, identity residual if None.
        Biases (M,), (M,), (O,), (O,).
    Returns:
        (B, H, W, O) in x's dtype. Weights are cast to x's dtype and every
        product accumulates in at least fp32; y1 and y2 are rounded after
        the ReLU, y3 and the projected residual after their bias, and the
        residual add runs in x's dtype.
    """
    dt = x.dtype
    acc = torch.promote_types(dt, torch.float32)

    def mm(a, wt):
        return a.to(acc) @ wt.to(dt).to(acc)

    _, h, w, _ = x.shape
    mid = w1.shape[-1]
    y1 = torch.relu(mm(x, w1) + b1.to(acc)).to(dt)
    # the 3x3's zero padding pads y1 itself (not conv1 of a zero pixel)
    y1p = F.pad(y1, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([y1p[:, dy:dy + h, dx:dx + w]
                      for dy in range(3) for dx in range(3)], dim=-1)
    y2 = torch.relu(mm(cols, w2.reshape(9 * mid, mid)) + b2.to(acc)).to(dt)
    y3 = (mm(y2, w3) + b3.to(acc)).to(dt)
    res = x if wd is None else (mm(x, wd) + bd.to(acc)).to(dt)
    return torch.relu(y3 + res)


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(cuda_build.library_path(NAME))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.fused_bottleneck_bf16, lib.fused_bottleneck_streamed_bf16):
        fn.argtypes = [vp] * 10 + [ci] * 7 + [vp]
        fn.restype = ci
    lib.fused_bottleneck_smem_bytes.argtypes = [ci, ci, ci]
    lib.fused_bottleneck_smem_bytes.restype = ci
    lib.fused_bottleneck_streamed_smem_bytes.argtypes = [ci]
    lib.fused_bottleneck_streamed_smem_bytes.restype = ci
    lib.fused_bottleneck_error_string.argtypes = [ci]
    lib.fused_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")


def _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, streamed) -> torch.Tensor:
    """Launch K2 (``streamed``) or K1 on a CUDA ``x``; raises on anything
    the kernel does not take."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, H, W, C) tensor "
                         "(an NCHW tensor in channels_last, permuted)")
    b, h, w, c = x.shape
    mid, o = w1.shape[-1], w3.shape[-1]
    has_down = wd is not None
    dev = x.device
    _check(w1, "w1", (c, mid), dev)
    _check(b1, "b1", (mid,), dev)
    _check(w2, "w2", (3, 3, mid, mid), dev)
    _check(b2, "b2", (mid,), dev)
    _check(w3, "w3", (mid, o), dev)
    _check(b3, "b3", (o,), dev)
    if has_down:
        _check(wd, "wd", (c, o), dev)
        _check(bd, "bd", (o,), dev)
    elif o != c:
        raise ValueError(f"identity residual needs O == C, got {o} vs {c}")
    if c % 16 or o % 16 or mid not in (16, 32, 64, 128):
        raise ValueError(f"C and O must be multiples of 16 and mid one of "
                         f"16, 32, 64, 128; got {c}, {mid}, {o}")
    if not 0 < b <= 65535:
        raise ValueError(f"batch {b} outside 1..65535")
    lib = _library()
    if streamed:
        kernel, smem = (lib.fused_bottleneck_streamed_bf16,
                        lib.fused_bottleneck_streamed_smem_bytes(mid))
    else:
        kernel, smem = (lib.fused_bottleneck_bf16,
                        lib.fused_bottleneck_smem_bytes(c, mid, o))
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={mid}, O={o} exceed the block's "
                         "shared memory; bands > 0 selects the kernel that "
                         "streams them")

    bf = torch.bfloat16
    ws = [w1.to(bf).contiguous(), w2.to(bf).contiguous(),
          w3.to(bf).contiguous()]
    bs = [b1.float().contiguous(), b2.float().contiguous(),
          b3.float().contiguous()]
    if has_down:
        ws.append(wd.to(bf).contiguous())
        bs.append(bd.float().contiguous())
    # WMMA reads 32-byte-aligned operands, the halo load 16-byte vectors
    if x.data_ptr() % 16 or any(t.data_ptr() % 32 for t in ws):
        raise ValueError("x must be 16-byte and the weights 32-byte aligned")
    out = torch.empty((b, h, w, o), dtype=bf, device=dev)
    down_w = ws[3].data_ptr() if has_down else None
    down_b = bs[3].data_ptr() if has_down else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(
            x.data_ptr(), ws[0].data_ptr(), bs[0].data_ptr(),
            ws[1].data_ptr(), bs[1].data_ptr(), ws[2].data_ptr(),
            bs[2].data_ptr(), down_w, down_b, out.data_ptr(),
            b, h, w, c, mid, o, int(has_down), stream)
    if rc != 0:
        msg = lib.fused_bottleneck_error_string(rc).decode()
        raise RuntimeError(f"fused bottleneck launch failed: {msg}")
    if streamed:
        fused_bottleneck_infer.streamed_launches += 1
    else:
        fused_bottleneck_infer.launches += 1
    return out


def fused_bottleneck_infer(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                           bands: int = 0) -> torch.Tensor:
    """One fused stride-1 bottleneck block at inference.

    Same arguments and result as :func:`fused_bottleneck_infer_plain`, plus
    ``bands``: 0 launches K1, N > 0 launches K2 (the JAX package's row-banded
    schedule, needed for the layer2 shape; ``H % bands`` must be 0 as
    there, though K2's tiling does not depend on N). A CUDA ``x`` must be
    bf16 and NHWC-contiguous and goes to the kernel; a CPU ``x`` goes to the
    plain version. ``fused_bottleneck_infer.launches`` counts K1's launches
    and ``.streamed_launches`` K2's, on the card only; ``.plain_runs``
    counts the CPU calls that ran the plain version in a kernel's place.
    """
    if bands < 0 or (bands and x.shape[1] % bands):
        raise ValueError(f"bands={bands} must be 0 or divide H={x.shape[1]}")
    if x.device.type == "cpu":
        fused_bottleneck_infer.plain_runs += 1
        return fused_bottleneck_infer_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)
    if x.device.type != "cuda":
        raise ValueError(f"no fused bottleneck for device {x.device}")
    return _launch(x, w1, b1, w2, b2, w3, b3, wd, bd, streamed=bands > 0)


fused_bottleneck_infer.launches = 0
fused_bottleneck_infer.streamed_launches = 0
fused_bottleneck_infer.plain_runs = 0
