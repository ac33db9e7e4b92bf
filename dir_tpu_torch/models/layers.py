"""Shared building blocks (counterpart of ``dir_tpu/models/layers.py``).

Parameters are stored in fp32, as in the JAX package; each conv and
linear layer casts its input and weights to the module's compute dtype
when it runs (the trunk dtype, bf16 or fp32), as flax's ``dtype=`` does.
Conv modules work on NCHW tensors, which the models keep in
``torch.channels_last`` memory format. BatchNorm is PyTorch's own
(eval-mode running statistics, eps 1e-5); under a data mesh of more than
one rank its training-mode statistics span the global batch.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from dir_tpu_torch.ops.quant import (ActAmax, module_act_scale,
                                     module_quant_conv, quant_conv)
from dir_tpu_torch.parallel.batch_norm import global_batch_norm


class _GlobalStats:
    """PyTorch's BatchNorm, whose training-mode statistics span every rank's
    block once :func:`~dir_tpu_torch.parallel.mesh.replicate` has handed it a
    mesh of more than one rank. Without one, or in a world of 1, or in eval
    mode, it is PyTorch's own forward; the ``state_dict`` is the same."""

    mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.mesh is not None and self.mesh.parallel:
            return global_batch_norm(x, self, self.mesh)
        return super().forward(x)


class BatchNorm2d(_GlobalStats, nn.BatchNorm2d):
    pass


class BatchNorm1d(_GlobalStats, nn.BatchNorm1d):
    pass


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """``conv`` applied in ``dtype``: input, weight and bias cast."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding)


def conv1x1_tokens(x: torch.Tensor, conv: nn.Conv1d, dtype) -> torch.Tensor:
    """A kernel-1 Conv1d applied to (B, N, C) tokens: a linear layer."""
    return F.linear(x.to(dtype), conv.weight[:, :, 0].to(dtype),
                    conv.bias.to(dtype))


def linear(x: torch.Tensor, lin: nn.Linear, dtype) -> torch.Tensor:
    """``lin`` applied in ``dtype``."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def bn_tokens(x: torch.Tensor, bn: BatchNorm1d) -> torch.Tensor:
    """BatchNorm1d over the channels of (B, N, C) tokens."""
    return bn(x.transpose(1, 2)).transpose(1, 2)


def _same_pads(size: int, kernel: int, stride: int) -> tuple:
    """flax's "SAME" padding of one axis: (low, high), the extra pixel on
    the high side."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvBNRelu(nn.Module):
    """Conv ("SAME" padding, as flax pads) -> optional BN -> optional ReLU
    (``dir_tpu/models/layers.py:ConvBNRelu``; DIR never builds it)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, use_relu: bool = True,
                 use_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.use_relu = use_relu
        self.conv = nn.Conv2d(in_ch, features, kernel, stride,
                              bias=use_bias)
        self.bn = BatchNorm2d(features) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        ph = _same_pads(x.shape[2], k, s)
        pw = _same_pads(x.shape[3], k, s)
        x = conv2d(F.pad(x, (*pw, *ph)), self.conv, self.dtype)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.use_relu else x


class ConvHolder(nn.Module):
    """Holds one conv as ``.conv`` (the reference's ``conv1.conv`` keys)."""

    def __init__(self, cin: int, cout: int, k: int, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)


class Residual(nn.Module):
    """Hourglass pre-activation bottleneck residual:
    BN-ReLU-1x1 -> BN-ReLU-3x3 -> BN-ReLU-1x1, plus a 1x1 skip conv when
    the input width differs from the output width.

    ``pair``: an optional second input; the block then runs on
    ``cat([x, pair])``, which is exactly what the JAX package's
    concat-free pair path computes."""

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32,
                 quant_eval: bool = False, quant_static: bool = False):
        super().__init__()
        half = out_ch // 2
        self.dtype = dtype
        # Inference-only int8 path (ops/quant.py): each conv runs
        # s8 x s8 -> s32 on its own parameters; the pre-activation BNs stay
        # floating point.
        self.quant_eval = quant_eval
        self.quant_static = quant_static
        names = ("conv1_in", "conv2_in", "conv3_in") + (
            ("skip_in",) if in_ch != out_ch else ())
        self.quant_stats = ActAmax(names) if quant_eval else None
        self.bn1 = BatchNorm2d(in_ch)
        self.conv1 = ConvHolder(in_ch, half, 1)
        self.bn2 = BatchNorm2d(half)
        self.conv2 = ConvHolder(half, half, 3)
        self.bn3 = BatchNorm2d(half)
        self.conv3 = ConvHolder(half, out_ch, 1)
        self.skip_layer = (ConvHolder(in_ch, out_ch, 1)
                           if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor,
                pair: torch.Tensor | None = None) -> torch.Tensor:
        if pair is not None:
            x = torch.cat([x, pair], dim=1)
        if self.quant_eval and not self.training:
            return self._quant_infer(x)
        dt = self.dtype
        skip = (x if self.skip_layer is None
                else conv2d(x, self.skip_layer.conv, dt))
        out = conv2d(torch.relu(self.bn1(x.to(dt))), self.conv1.conv, dt)
        out = conv2d(torch.relu(self.bn2(out)), self.conv2.conv, dt)
        out = conv2d(torch.relu(self.bn3(out)), self.conv3.conv, dt)
        return out + skip


    def _quant_infer(self, x: torch.Tensor) -> torch.Tensor:
        """Int8 execution on the block's own parameters, on the NHWC view of
        ``x`` (the pair concat has materialized). The BNs are computed in
        fp32 and then cast, in the JAX package's order."""
        dt = self.dtype
        xn = x.permute(0, 2, 3, 1)

        def bn_inf(bn, v):
            mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
            return ((v.float() - bn.running_mean) * mul + bn.bias).to(dt)

        def qc(name, holder, v, k3=False):
            sc = module_act_scale(self.quant_stats, f"{name}_in", v,
                                  self.quant_static)
            return quant_conv(v, holder.conv.weight.permute(2, 3, 1, 0),
                              padding=((1, 1), (1, 1)) if k3 else "SAME",
                              bias=holder.conv.bias.float(), out_dtype=dt,
                              act_scale=sc)

        skip = (xn.to(dt) if self.skip_layer is None
                else qc("skip", self.skip_layer, xn))
        out = qc("conv1", self.conv1, torch.relu(bn_inf(self.bn1, xn)))
        out = qc("conv2", self.conv2, torch.relu(bn_inf(self.bn2, out)),
                 k3=True)
        out = qc("conv3", self.conv3, torch.relu(bn_inf(self.bn3, out)))
        return (out + skip).permute(0, 3, 1, 2)


class Hourglass(nn.Module):
    """Recursive hourglass of :class:`Residual` blocks with a 2x2 max pool
    and a nearest 2x upsample (``dir_tpu/models/layers.py:Hourglass``; DIR
    never builds it)."""

    def __init__(self, depth: int, features: int, increase: int = 0,
                 dtype=torch.float32):
        super().__init__()
        nf = features + increase
        self.up1 = Residual(features, features, dtype)
        self.low1 = Residual(features, nf, dtype)
        self.low2 = (Hourglass(depth - 1, nf, dtype=dtype) if depth > 1
                     else Residual(nf, nf, dtype))
        self.low3 = Residual(nf, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = self.low3(self.low2(self.low1(F.max_pool2d(x, 2, 2))))
        return self.up1(x) + F.interpolate(low, scale_factor=2,
                                           mode="nearest")


class MLP1d(nn.Sequential):
    """Conv1d(k=1) -> BN1d -> ReLU -> Conv1d(k=1) over (B, N, C) tokens;
    the Sequential layout gives the reference keys ``0``, ``1`` and ``3``."""

    def __init__(self, in_ch: int, hidden: int, out: int,
                 dtype=torch.float32):
        super().__init__(nn.Conv1d(in_ch, hidden, 1), BatchNorm1d(hidden),
                         nn.ReLU(), nn.Conv1d(hidden, out, 1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv1x1_tokens(x, self[0], self.dtype)
        x = torch.relu(bn_tokens(x, self[1]))
        return conv1x1_tokens(x, self[3], self.dtype)


class ConvHead(nn.Sequential):
    """Conv3x3 -> BN -> ReLU -> Conv1x1 (the attention-pool, seg and dense
    heads and the decoder's final conv; keys ``0``, ``1`` and ``3``)."""

    def __init__(self, in_ch: int, mid: int, out: int,
                 first_bias: bool = True, dtype=torch.float32,
                 quant_eval: bool = False, quant_static: bool = False,
                 quant_second: bool = False):
        super().__init__(nn.Conv2d(in_ch, mid, 3, padding=1, bias=first_bias),
                         BatchNorm2d(mid), nn.ReLU(),
                         nn.Conv2d(mid, out, 1))
        self.dtype = dtype
        # Inference-only int8 path (cfg.quant_aux_eval): the 3x3 conv with
        # the BN folded in; the 1x1 conv stays floating point (a few logits
        # into a sigmoid or a loss) unless quant_second (the decoder's
        # final conv, which feeds the heads).
        self.quant_eval = quant_eval
        self.quant_static = quant_static
        self.quant_second = quant_second
        names = ("conv1_in",) + (("conv2_in",) if quant_second else ())
        self.quant_stats = ActAmax(names) if quant_eval else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if not (self.quant_eval and not self.training):
            x = torch.relu(self[1](conv2d(x, self[0], dt)))
            return conv2d(x, self[3], dt)
        y = torch.relu(module_quant_conv(
            self.quant_stats, "conv1", x.to(dt).permute(0, 2, 3, 1), self[0],
            static=self.quant_static, out_dtype=dt, bn=self[1]))
        if self.quant_second:
            y = module_quant_conv(self.quant_stats, "conv2", y, self[3],
                                  static=self.quant_static, out_dtype=dt)
            return y.permute(0, 3, 1, 2)
        return conv2d(y.permute(0, 3, 1, 2), self[3], dt)


def _upsample_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Half-pixel bilinear 2x along ``axis``: out[2i] = 0.75 in[i] +
    0.25 in[i-1], out[2i+1] = 0.75 in[i] + 0.25 in[i+1], edges clamped."""
    n = x.shape[axis]
    edged = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                      axis)
    mid = 0.75 * x
    pair = torch.stack([torch.add(mid, edged.narrow(axis, 0, n), alpha=0.25),
                        torch.add(mid, edged.narrow(axis, 2, n), alpha=0.25)],
                       axis + 1)
    shape = list(x.shape)
    shape[axis] = 2 * n
    return pair.reshape(shape)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling of (B, H, W, C) maps with torch
    ``align_corners=False`` semantics, in the JAX package's algebra (its
    default transposed-conv form, ``_upsample2x_tconv``): separable per
    axis, summed in at least fp32 and rounded once to ``x``'s dtype. Its
    backward is slices and weighted adds, with no atomics."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return _upsample_axis(_upsample_axis(x.to(acc), 1), 2).to(x.dtype)
