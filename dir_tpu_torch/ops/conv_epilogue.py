"""An eval-mode convolution with its BatchNorm folded in, and the bias, an
optional residual and the ReLU in one pass after it.

``relu(BN(conv(x, W) + c) [+ z])``, with the eval BatchNorm
``BN(v) = (v - m) * g + beta``, ``g = gamma / sqrt(var + eps)``, is
``relu(conv(x, W * g) + (c - m) * g + beta [+ z])``. :func:`fold` makes the
folded weight and bias once, in fp32 (``fused_bottleneck.fold_bn``, as
K1's operands are made), and casts the weight to the trunk's dtype;
:class:`Kept` keeps them with the tensors they were made from.
:func:`conv_bias_relu` then runs the folded conv without its bias and
:func:`bias_add_relu_` adds the fp32 bias and the residual to the conv's
output and applies the ReLU, rounding once.

The JAX package has no kernel here: XLA fuses the BatchNorm, the add and
the ReLU into its convolution. In the port they were one pass over device
memory each, at the ResNet's and the decoder's full map sizes. The pass
is bound by bytes (two or three bf16 reads and one write of the map a
site, no reuse), so the kernel is one Triton pass over the channels-last
map, in place, reading the conv's output and ``z`` once.

On a CUDA tensor :func:`bias_add_relu_` launches the kernel; on a CPU
tensor it runs :func:`bias_add_relu_plain`, the plain version with the same
rounding point. There is no other fallback: a CUDA tensor the kernel does
not take raises.

A site takes this route only where :func:`engages` says so: inference (not
training, no gradient) on a CUDA device with a bf16 trunk, outside an
export. Everywhere else it runs the unfused composition, so CPU, fp32,
training and exported graphs compute as before.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F

from dir_tpu_torch.ops.fused_bottleneck import fold_bn

# The kernel's tile: rows (pixels) by channels of the channels-last map.
_BLOCK_ROWS = 128
_BLOCK_CHANNELS = 64


def engages(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether a site of ``module`` (a module with a compute ``dtype``)
    takes the fused route for its input ``x``: eval mode, no gradient
    recorded, bf16 activations and trunk on a CUDA device, and no graph
    being exported (which traces the unfused ops)."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and module.dtype == torch.bfloat16 and not module.training
            and not torch.is_grad_enabled()
            and not torch.compiler.is_exporting())


def fold(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype) -> tuple:
    """``conv`` with the eval ``bn`` after it folded in by
    ``fused_bottleneck.fold_bn`` (in at least fp32; the conv's own bias
    ``c`` enters as the mean ``m - c``): the weight (O, I, kh, kw) cast to
    ``dtype``, channels-last, and the bias (O,)."""
    mean = bn.running_mean
    if conv.bias is not None:
        mean = mean - conv.bias
    w, b = fold_bn(conv.weight.permute(1, 2, 3, 0), bn.weight, bn.bias,
                   mean, bn.running_var, bn.eps)
    w = w.permute(3, 0, 1, 2).to(dtype)
    return w.contiguous(memory_format=torch.channels_last), b


def sources(conv: nn.Conv2d, bn: nn.BatchNorm2d) -> list:
    """The tensors that :func:`fold` makes its operands from."""
    tensors = [conv.weight, bn.weight, bn.bias, bn.running_mean,
               bn.running_var]
    return tensors if conv.bias is None else tensors + [conv.bias]


class Kept:
    """Operands made from (conv, BN) pairs (and any ``extra`` tensors),
    made once and kept. They are made anew when any source tensor
    (:func:`sources`) was replaced, moved or changed in place (its
    identity, storage or version), or a BN's eps changed; so
    ``load_state_dict``, an optimizer step and ``.to()`` are seen. A write
    through ``.data`` bypasses the version, as everywhere in autograd.
    Operands made from inference tensors keep no version and are not
    kept."""

    __slots__ = ("key", "eps", "value")

    def __init__(self):
        self.key = self.eps = self.value = None

    def get(self, pairs, make, extra=()):
        """``make()``, or what it returned before for the same sources."""
        tensors = [t for conv, bn in pairs for t in sources(conv, bn)]
        try:
            key = [(t, t.data_ptr(), t._version) for t in (*tensors, *extra)]
        except RuntimeError:                 # an inference tensor
            key = None
        eps = tuple(bn.eps for _, bn in pairs)
        if (key is not None and self.key is not None and self.eps == eps
                and len(self.key) == len(key)
                and all(ta is tb and pa == pb and va == vb
                        for (ta, pa, va), (tb, pb, vb) in zip(self.key, key))):
            return self.value
        value = make()
        self.key, self.eps, self.value = (
            (key, eps, value) if key is not None else (None, None, None))
        return value


def bias_add_relu_plain(y: torch.Tensor, bias: torch.Tensor,
                        z: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(y + bias [+ z])`` summed in at least fp32 and rounded once to
    ``y``'s dtype; ``y``, ``z``: (B, C, H, W), ``bias``: (C,)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    v = y.to(acc) + bias.to(acc)[:, None, None]
    if z is not None:
        v = v + z.to(acc)
    return torch.relu(v).to(y.dtype)


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def bias_add_relu_kernel(y_ptr, b_ptr, z_ptr, rows, channels,
                             HAS_Z: tl.constexpr, BLOCK_R: tl.constexpr,
                             BLOCK_C: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
        inside = (r[:, None] < rows) & (c[None, :] < channels)
        at = r[:, None].to(tl.int64) * channels + c[None, :]
        v = tl.load(y_ptr + at, mask=inside).to(tl.float32)
        v += tl.load(b_ptr + c, mask=c < channels)[None, :]
        if HAS_Z:
            v += tl.load(z_ptr + at, mask=inside).to(tl.float32)
        tl.store(y_ptr + at, tl.maximum(v, 0.0).to(tl.bfloat16), mask=inside)

    return triton, bias_add_relu_kernel


def _launch(y: torch.Tensor, bias: torch.Tensor, z) -> torch.Tensor:
    cl = torch.channels_last
    if y.dim() != 4 or not y.is_contiguous(memory_format=cl):
        raise ValueError("y: a channels-last (B, C, H, W) map, got shape "
                         f"{tuple(y.shape)}, strides {y.stride()}")
    if y.dtype != torch.bfloat16:
        raise ValueError(f"y: dtype {y.dtype}, the kernel takes bf16")
    channels = y.shape[1]
    if (bias.dtype != torch.float32 or bias.shape != (channels,)
            or not bias.is_contiguous() or bias.device != y.device):
        raise ValueError(f"bias: fp32 ({channels},) on {y.device}, got "
                         f"{bias.dtype} {tuple(bias.shape)} on {bias.device}")
    if z is not None and (z.shape != y.shape or z.dtype != y.dtype
                          or z.device != y.device
                          or not z.is_contiguous(memory_format=cl)):
        raise ValueError("z: a channels-last map of y's shape, dtype and "
                         "device")
    if y.numel() == 0:
        return y
    rows = y.numel() // channels
    triton, kernel = _kernel()
    grid = (triton.cdiv(rows, _BLOCK_ROWS),
            triton.cdiv(channels, _BLOCK_CHANNELS))
    with torch.cuda.device(y.device):
        kernel[grid](y, bias, y if z is None else z, rows, channels,
                     z is not None, _BLOCK_ROWS, _BLOCK_CHANNELS,
                     num_warps=4)
    bias_add_relu_.launches += 1
    return y


def bias_add_relu_(y: torch.Tensor, bias: torch.Tensor,
                   z: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(y + bias [+ z])`` into ``y`` (a conv's fresh output) and
    returned: the kernel on a CUDA tensor (a bf16 channels-last map, fp32
    ``bias``, ``z`` in ``y``'s layout and dtype), in place; on a CPU tensor
    :func:`bias_add_relu_plain`, whose result is returned.
    ``bias_add_relu_.launches`` counts the kernel's launches;
    ``.plain_runs`` the CPU calls."""
    if y.is_cuda:
        return _launch(y, bias, z)
    bias_add_relu_.plain_runs += 1
    return bias_add_relu_plain(y, bias, z)


bias_add_relu_.launches = 0
bias_add_relu_.plain_runs = 0


def conv_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   stride=1, padding=0,
                   z: torch.Tensor | None = None) -> torch.Tensor:
    """``relu(conv(x, weight) + bias [+ z])`` on folded operands
    (:func:`fold`): the conv in ``x``'s dtype without its bias, then
    :func:`bias_add_relu_`. ``conv_bias_relu.fused_runs`` counts the
    calls: each is a site that took the fused route."""
    conv_bias_relu.fused_runs += 1
    return bias_add_relu_(F.conv2d(x, weight, None, stride, padding), bias,
                          z)


conv_bias_relu.fused_runs = 0
