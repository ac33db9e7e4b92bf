"""Fused stride-1 ResNet bottleneck at inference (kernels K1 and K2).

Counterpart of ``dir_tpu/ops/pallas_bottleneck.py:fused_bottleneck_infer``.
On a CUDA tensor :func:`fused_bottleneck_infer` launches the hand-written
Hopper kernel of ``csrc/fused_bottleneck.cu``, a persistent, warp-specialised
template (TMA halo loads, ``wgmma`` products) in two forms: with ``bands=0``
K1, which keeps w1, w2 and w3 in shared memory for a block's whole life (the
layer1 shape), and with ``bands>0`` K2, which streams every weight through
the ring of stages and so takes any width (the layer2 shape, where the
weights do not fit). :func:`kernel_operands` lays the folded weights out as
the kernel reads them and :func:`launch` launches on them; a caller may keep
the operands. On a CPU tensor it runs :func:`fused_bottleneck_infer_plain`,
the plain PyTorch version with the same rounding points; banding changes a
schedule, not the math, so one plain version serves both. There is no other
fallback: a CUDA tensor the kernel does not take raises.

The kernel is the PyTorch op ``torch.ops.dir_tpu.fused_bottleneck`` on the
operands (:func:`call`): its CUDA implementation is :func:`launch`, its CPU
implementation unpacks the weight image and runs the plain version, and its
fake implementation gives the output's shape, so that a traced or exported
graph names the op whatever the device. The wrapper lays the weights out in
the activations' dtype (:func:`pack`); on the CPU an fp32 image holds the
fp32 weights exactly.

The kernel is compiled at first use (``ops/cuda_build.py``) from this
package's sources only, and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from dir_tpu_torch.ops import cuda_build

NAME = "fused_bottleneck"            # csrc/fused_bottleneck.cu
# H100: dynamic shared memory one block may use.
_MAX_SMEM = 232448


def fold_bn(kernel: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5):
    """Fold an inference BatchNorm into the preceding conv, in at least
    fp32: BN(conv(x, W)) == conv(x, W * g) + (b - m * g),
    g = scale/sqrt(var+eps). kernel: (..., O) (output channels last);
    returns (kernel, bias) in fp32, or fp64 for an fp64 kernel."""
    acc = torch.promote_types(kernel.dtype, torch.float32)
    g = scale.to(acc) / torch.sqrt(var.to(acc) + eps)
    return kernel.to(acc) * g, bias.to(acc) - mean.to(acc) * g


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


NVCC_EXTRA_FLAGS = ("-ldl",)       # dlopen of the driver's cuTensorMapEncodeTiled
KC = 64                              # channels of a K panel: one 128-byte row
# kernel_operands' packing; the kernel's Shape<M> in csrc/fused_bottleneck.cu
# must agree


class Operands(NamedTuple):
    """What the CUDA kernel reads beside ``x`` (:func:`kernel_operands`)."""
    image: torch.Tensor        # bf16: the w1, w2, w3 (and wd) images, in order
    b1: torch.Tensor           # fp32 (mid,)
    b2: torch.Tensor           # fp32 (mid,)
    b3: torch.Tensor           # fp32 (O,)
    bd: torch.Tensor | None    # fp32 (O,), or None for the identity residual
    c: int
    mid: int
    o: int
    bands: int


def conv3_chunk(mid: int) -> int:
    """Output channels of one conv3 chunk (the kernel's N3)."""
    return max(32, mid)


def channel_order(n: int, device=None) -> torch.Tensor:
    """The output channel of each of ``n`` (a multiple of 32) conv3 columns:
    column ``32q + 8jj + 2tig + e`` holds channel ``32q + 8tig + 2jj + e``,
    so that the eight values a thread holds of four 8-column accumulator
    tiles are eight consecutive channels (one 16-byte store)."""
    p = torch.arange(n, device=device)
    q, r = p // 32, p % 32
    return 32 * q + 8 * ((r % 8) // 2) + 2 * (r // 8) + r % 2


def _pad(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return F.pad(m, (0, cols - m.shape[1], 0, rows - m.shape[0]))


def _panels(m: torch.Tensor, width: int = KC) -> torch.Tensor:
    """(R, K) with K a multiple of ``width`` -> (K/width, R, width): each
    panel of ``width`` columns (128 bytes a row: 64 bf16 or 128 int8 values)
    as wgmma reads it K-major with the 128-byte swizzle (the 16-byte chunk c
    of row r stored at chunk c ^ (r % 8))."""
    r, k = m.shape
    p = m.reshape(r, k // width, 8, width // 8).permute(1, 0, 2, 3)
    rows = torch.arange(r, device=m.device)
    chunk = torch.arange(8, device=m.device)[None, :] ^ (rows % 8)[:, None]
    return p[:, rows[:, None], chunk].reshape(k // width, r, width)


@functools.lru_cache(maxsize=64)
def _image_index(c: int, mid: int, o: int, has_down: bool,
                 device: torch.device) -> torch.Tensor:
    """Where each element of the weight image comes from: positions in
    ``[0, w1, w2, w3, wd]`` flattened and concatenated (0 is the zero of the
    padding). The layout is made once per shape by running the packing on
    the positions themselves; a call is then one gather."""
    sizes = [c * mid, 9 * mid * mid, mid * o] + ([c * o] if has_down else [])
    pos = torch.arange(1, 1 + sum(sizes), dtype=torch.int32, device=device)
    w1, w2, w3, *wd = torch.split(pos, sizes)
    w1, w2, w3 = w1.reshape(c, mid), w2.reshape(3, 3, mid, mid), w3.reshape(mid, o)
    cp, kp = -(-c // KC) * KC, -(-mid // KC) * KC
    n3 = conv3_chunk(mid)
    op = -(-o // n3) * n3
    order = channel_order(op, device)

    def out_rows(w):          # (K, O) -> (Op, K) in the kernel's column order
        return _pad(w, w.shape[0], op)[:, order].t()

    parts = [_panels(_pad(w1.t(), mid, cp))]
    parts += [_panels(_pad(w2[dy, dx].t(), mid, kp))
              for dy in range(3) for dx in range(3)]
    w3r = _pad(out_rows(w3), op, kp)
    parts += [_panels(w3r[j:j + n3]) for j in range(0, op, n3)]
    if has_down:
        wdr = _pad(out_rows(wd[0].reshape(c, o)), op, cp)
        parts += [_panels(wdr[j:j + n3]) for j in range(0, op, n3)]
    return torch.cat([t.reshape(-1) for t in parts])


def kernel_operands(w1, b1, w2, b2, w3, b3, wd=None, bd=None, *,
                    bands: int) -> Operands:
    """The folded weights as the kernel reads them, made on their device.

    One bf16 tensor holds the images of the weights, each an (N, K) matrix
    (N output channels as rows, K-major) cut into 64-wide K panels that are
    128-byte swizzled (:func:`_panels`), K zero-padded to a multiple of 64:
    w1 as (mid, C) panels; w2 tap by tap as (mid, mid); w3 as (O, mid) in
    chunks of :func:`conv3_chunk` rows; wd as (O, C) panels per chunk. The
    columns of w3 and wd are in :func:`channel_order` and O is zero-padded
    to whole chunks. Biases stay fp32 in channel order. ``bands`` names the
    kernel form the operands are for (0: K1, weights resident in shared
    memory; > 0: K2, streamed). A caller that serves many requests may keep
    the result."""
    check_widths(w1.shape[0], w1.shape[1], w3.shape[-1])
    return pack(w1, b1, w2, b2, w3, b3, wd, bd, bands=bands)


def check_widths(c: int, mid: int, o: int) -> None:
    """Raise unless the kernel takes these widths."""
    if c % 16 or o % 16 or mid not in (16, 32, 64, 128):
        raise ValueError(f"C and O must be multiples of 16 and mid one of "
                         f"16, 32, 64, 128; got {c}, {mid}, {o}")


def pack(w1, b1, w2, b2, w3, b3, wd=None, bd=None, *, bands: int,
         dtype=torch.bfloat16) -> Operands:
    """:func:`kernel_operands` without the kernel's width check, the image
    in ``dtype``: the same layout at any mid up to 32 or multiple of 32,
    for the plain route of the op (:func:`unpack_weights` inverts it)."""
    dev = w1.device
    c, mid = w1.shape
    o = w3.shape[-1]
    has_down = wd is not None
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
    srcs = [w1, w2, w3] + ([wd] if has_down else [])
    flat = torch.cat([torch.zeros(1, device=dev)]
                     + [w.reshape(-1).float() for w in srcs])
    image = flat.to(dtype)[_image_index(c, mid, o, has_down, dev)]
    f32 = [t if t is None else t.float().contiguous().clone()
           for t in (b1, b2, b3, bd)]
    return Operands(image, *f32, c, mid, o, bands)


def source_index(index: torch.Tensor) -> torch.Tensor:
    """The inverse of an image index (``_image_index``): where in the image
    each weight element (in the order of the flattened sources) lies. Every
    position but the padding's 0 appears once in an image."""
    idx = index.long()
    src = torch.zeros(int(idx.max()) + 1, dtype=torch.long, device=idx.device)
    src[idx] = torch.arange(idx.numel(), device=idx.device)
    return src[1:]


@functools.lru_cache(maxsize=64)
def _source_index(c: int, mid: int, o: int, has_down: bool,
                  device: torch.device) -> torch.Tensor:
    return source_index(_image_index(c, mid, o, has_down, device))


def unpack_weights(image: torch.Tensor, c: int, mid: int, o: int,
                   has_down: bool) -> tuple:
    """``(w1, w2, w3, wd)`` in the image's dtype from a weight image of
    :func:`pack` (``wd`` None without the projection); exact."""
    flat = image[_source_index(c, mid, o, has_down, image.device)]
    sizes = [c * mid, 9 * mid * mid, mid * o] + ([c * o] if has_down else [])
    w1, w2, w3, *wd = torch.split(flat, sizes)
    return (w1.reshape(c, mid), w2.reshape(3, 3, mid, mid),
            w3.reshape(mid, o), wd[0].reshape(c, o) if has_down else None)


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME, NVCC_EXTRA_FLAGS)


def bind(path: str) -> ctypes.CDLL:
    """Load a build of the kernel library and declare its C interface."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_bottleneck_bf16.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.fused_bottleneck_bf16.restype = ci
    lib.fused_bottleneck_image_bytes.argtypes = [ci] * 4
    lib.fused_bottleneck_image_bytes.restype = ci
    lib.fused_bottleneck_smem_bytes.argtypes = [ci] * 5
    lib.fused_bottleneck_smem_bytes.restype = ci
    lib.fused_bottleneck_error_string.argtypes = [ci]
    lib.fused_bottleneck_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    return bind(cuda_build.library_path(NAME))


def _check(t: torch.Tensor, name: str, shape: tuple, device) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, w1 on {device}")


def launch(x: torch.Tensor, operands: Operands, bands: int) -> torch.Tensor:
    """Launch K1 (``bands`` 0) or K2 on a CUDA ``x`` with the operands of
    :func:`kernel_operands`; raises on anything the kernel does not take."""
    if x.dtype != torch.bfloat16 or operands.image.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16 activations and a bf16 "
                        f"image, got {x.dtype} and {operands.image.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC (B, H, W, C) tensor "
                         "(an NCHW tensor in channels_last, permuted)")
    b, h, w, c = x.shape
    op = operands
    if op.c != c or op.image.device != x.device:
        raise ValueError(f"the operands are for C={op.c} on "
                         f"{op.image.device}, x has C={c} on {x.device}")
    check_widths(c, op.mid, op.o)
    if bool(op.bands) != bool(bands):
        raise ValueError(f"the operands were made for bands={op.bands}, "
                         f"launched with bands={bands}")
    if b <= 0:
        raise ValueError(f"batch {b} is empty")
    # TMA, the bulk copies and the epilogue's vector loads read 16-byte
    # aligned addresses
    if any(t.data_ptr() % 16 for t in (x, *op[:5]) if t is not None):
        raise ValueError("x, the weight image and the biases must be 16-byte "
                         "aligned")
    lib = _library()
    has_down = op.bd is not None
    smem = lib.fused_bottleneck_smem_bytes(c, op.mid, op.o, int(has_down),
                                           int(bands == 0))
    if smem > _MAX_SMEM:
        raise ValueError(f"C={c}, mid={op.mid}, O={op.o} need {smem} bytes "
                         "of shared memory in the "
                         f"{'streamed' if bands else 'resident'} form, beyond "
                         "the block's; bands > 0 selects the kernel that "
                         "streams the weights")
    out = launch_on(lib, x, op, bands)
    if bands:
        fused_bottleneck_infer.streamed_launches += 1
    else:
        fused_bottleneck_infer.launches += 1
    return out


def launch_on(lib: ctypes.CDLL, x: torch.Tensor, op: Operands,
              bands: int) -> torch.Tensor:
    """One launch through ``lib`` (:func:`bind`) on checked inputs; counts
    nothing."""
    b, h, w, c = x.shape
    has_down = op.bd is not None
    if op.image.numel() * 2 != lib.fused_bottleneck_image_bytes(
            c, op.mid, op.o, int(has_down)):
        raise ValueError("the weight image does not have the kernel's size")
    out = torch.empty((b, h, w, op.o), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_bottleneck_bf16(
            x.data_ptr(), op.image.data_ptr(), op.b1.data_ptr(),
            op.b2.data_ptr(), op.b3.data_ptr(),
            op.bd.data_ptr() if has_down else None, out.data_ptr(),
            b, h, w, c, op.mid, op.o, int(has_down), int(bands == 0), stream)
    if rc != 0:
        msg = lib.fused_bottleneck_error_string(rc).decode()
        raise RuntimeError(f"fused bottleneck launch failed: {msg}")
    return out


_SCHEMA = ("(Tensor x, Tensor image, Tensor b1, Tensor b2, Tensor b3, "
           "Tensor? bd, int mid, int o, int bands) -> Tensor")


@torch.library.custom_op("dir_tpu::fused_bottleneck", mutates_args=(),
                         device_types="cpu", schema=_SCHEMA)
def _op(x, image, b1, b2, b3, bd, mid, o, bands):
    """The CPU implementation: the plain version on the unpacked image."""
    w1, w2, w3, wd = unpack_weights(image, x.shape[-1], mid, o,
                                    bd is not None)
    fused_bottleneck_infer.plain_runs += 1
    return fused_bottleneck_infer_plain(x, w1, b1, w2, b2, w3, b3, wd, bd)


@_op.register_kernel("cuda")
def _op_cuda(x, image, b1, b2, b3, bd, mid, o, bands):
    return launch(x, Operands(image, b1, b2, b3, bd, x.shape[-1], mid, o,
                              bands), bands)


@_op.register_fake
def _op_fake(x, image, b1, b2, b3, bd, mid, o, bands):
    return x.new_empty((*x.shape[:3], o))


def call(x: torch.Tensor, operands: Operands, bands: int) -> torch.Tensor:
    """``torch.ops.dir_tpu.fused_bottleneck`` on ``x`` and the operands:
    K1 or K2 on the card, the plain version on the CPU."""
    op = operands
    return torch.ops.dir_tpu.fused_bottleneck(
        x, op.image, op.b1, op.b2, op.b3, op.bd, op.mid, op.o, bands)


def check_device(x: torch.Tensor, w1: torch.Tensor) -> None:
    """Raise unless ``x`` is on the CPU or a card and ``w1`` beside it."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if w1.device != x.device:
        raise ValueError(f"w1 is on {w1.device}, x on {x.device}")


def fused_bottleneck_infer(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None,
                           bands: int = 0) -> torch.Tensor:
    """One fused stride-1 bottleneck block at inference.

    Same arguments and result as :func:`fused_bottleneck_infer_plain`, plus
    ``bands``: 0 launches K1, N > 0 launches K2 (the JAX package's row-banded
    schedule, needed for the layer2 shape; ``H % bands`` must be 0 as
    there, though K2's tiling does not depend on N). The weights are laid
    out in ``x``'s dtype (:func:`pack`) and go with ``x`` to the op
    (:func:`call`): a CUDA ``x`` must be bf16 and NHWC-contiguous and goes
    to the kernel (:func:`launch`); a CPU ``x`` goes to the plain version.
    ``fused_bottleneck_infer.launches`` counts K1's launches and
    ``.streamed_launches`` K2's, on the card only; ``.plain_runs`` counts
    the CPU calls that ran the plain version in a kernel's place.
    """
    if bands < 0 or (bands and x.shape[1] % bands):
        raise ValueError(f"bands={bands} must be 0 or divide H={x.shape[1]}")
    check_device(x, w1)
    return call(x, pack(w1, b1, w2, b2, w3, b3, wd, bd, bands=bands,
                        dtype=x.dtype), bands)


fused_bottleneck_infer.launches = 0
fused_bottleneck_infer.streamed_launches = 0
fused_bottleneck_infer.plain_runs = 0
