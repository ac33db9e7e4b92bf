"""Shared building blocks (counterpart of ``dir_tpu/models/layers.py``).

Parameters are stored in fp32, as in the JAX package; each conv and
linear layer casts its input and weights to the module's compute dtype
when it runs (the trunk dtype, bf16 or fp32), as flax's ``dtype=`` does.
Conv modules work on NCHW tensors, which the models keep in
``torch.channels_last`` memory format. BatchNorm is PyTorch's own
(eval-mode running statistics, eps 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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


def bn_tokens(x: torch.Tensor, bn: nn.BatchNorm1d) -> torch.Tensor:
    """BatchNorm1d over the channels of (B, N, C) tokens."""
    return bn(x.transpose(1, 2)).transpose(1, 2)


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

    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        half = out_ch // 2
        self.dtype = dtype
        self.bn1 = nn.BatchNorm2d(in_ch)
        self.conv1 = ConvHolder(in_ch, half, 1)
        self.bn2 = nn.BatchNorm2d(half)
        self.conv2 = ConvHolder(half, half, 3)
        self.bn3 = nn.BatchNorm2d(half)
        self.conv3 = ConvHolder(half, out_ch, 1)
        self.skip_layer = (ConvHolder(in_ch, out_ch, 1)
                           if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor,
                pair: torch.Tensor | None = None) -> torch.Tensor:
        if pair is not None:
            x = torch.cat([x, pair], dim=1)
        dt = self.dtype
        skip = (x if self.skip_layer is None
                else conv2d(x, self.skip_layer.conv, dt))
        out = conv2d(torch.relu(self.bn1(x.to(dt))), self.conv1.conv, dt)
        out = conv2d(torch.relu(self.bn2(out)), self.conv2.conv, dt)
        out = conv2d(torch.relu(self.bn3(out)), self.conv3.conv, dt)
        return out + skip


class MLP1d(nn.Sequential):
    """Conv1d(k=1) -> BN1d -> ReLU -> Conv1d(k=1) over (B, N, C) tokens;
    the Sequential layout gives the reference keys ``0``, ``1`` and ``3``."""

    def __init__(self, in_ch: int, hidden: int, out: int,
                 dtype=torch.float32):
        super().__init__(nn.Conv1d(in_ch, hidden, 1), nn.BatchNorm1d(hidden),
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
                 first_bias: bool = True, dtype=torch.float32):
        super().__init__(nn.Conv2d(in_ch, mid, 3, padding=1, bias=first_bias),
                         nn.BatchNorm2d(mid), nn.ReLU(),
                         nn.Conv2d(mid, out, 1))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self[1](conv2d(x, self[0], self.dtype)))
        return conv2d(x, self[3], self.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling of (B, H, W, C) maps with torch
    ``align_corners=False`` semantics; the JAX package's transposed-conv
    form is the same algebra."""
    up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                       mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1)
