"""ResNet-50 backbone returning the 4-level feature pyramid
(counterpart of ``dir_tpu/models/resnet.py``, conv7 stem).

torchvision v1.5 bottlenecks: the stride sits on the 3x3 conv, padding
is symmetric, and a 1x1 projection exists where the residual shapes
differ. Tensors are NCHW in ``torch.channels_last`` memory format, so
the fused kernel reads them as NHWC without a copy.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dir_tpu_torch.models.layers import conv2d
from dir_tpu_torch.ops.fused_bottleneck import fold_bn, fused_bottleneck_infer


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32,
                 fused_eval: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.dtype = dtype
        # Inference-only fused kernel (ops/fused_bottleneck.py) for the
        # blocks its guard takes; the parameters are the same either way.
        self.fused_eval = fused_eval
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False),
            nn.BatchNorm2d(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The guard of the JAX package: not training, stride 1, >= 128
        # input channels and >= 4096 spatial positions (layer1_1, layer1_2).
        if (self.fused_eval and not self.training and self.stride == 1
                and x.shape[1] >= 128 and x.shape[2] * x.shape[3] >= 4096):
            return self._fused_infer(x)
        dt = self.dtype
        out = torch.relu(self.bn1(conv2d(x, self.conv1, dt)))
        out = torch.relu(self.bn2(conv2d(out, self.conv2, dt)))
        out = self.bn3(conv2d(out, self.conv3, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](
                conv2d(x, self.downsample[0], dt))
        return torch.relu(out + identity)

    def folded_weights(self) -> list:
        """The BNs folded into the convs in fp32, in the fused kernel's
        argument order ``[w1, b1, w2, b2, w3, b3, wd, bd]`` (``wd``, ``bd``
        None without a projection)."""
        def fold(conv, bn):
            return fold_bn(conv.weight.permute(2, 3, 1, 0), bn.weight,
                           bn.bias, bn.running_mean, bn.running_var, bn.eps)

        w1, b1 = fold(self.conv1, self.bn1)
        w2, b2 = fold(self.conv2, self.bn2)
        w3, b3 = fold(self.conv3, self.bn3)
        wd = bd = None
        if self.downsample is not None:
            wd, bd = fold(self.downsample[0], self.downsample[1])
            wd = wd[0, 0]
        return [w1[0, 0], b1, w2, b2, w3[0, 0], b3, wd, bd]

    def _fused_infer(self, x: torch.Tensor) -> torch.Tensor:
        """Run the whole block as one fused kernel on the NHWC view of
        ``x``, with the folded weights."""
        y = fused_bottleneck_infer(x.to(self.dtype).permute(0, 2, 3, 1),
                                   *self.folded_weights())
        return y.permute(0, 3, 1, 2)


class ResNetPyramid(nn.Module):
    """ResNet (conv7 stem) emitting [c1, c2, c3, c4] at strides 4/8/16/32."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.float32, fused_eval: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for stage, (blocks, planes) in enumerate(
                zip(layers, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                down = b == 0 and (stride != 1
                                   or inplanes != planes * Bottleneck.expansion)
                seq.append(Bottleneck(inplanes, planes,
                                      stride if b == 0 else 1, down,
                                      dtype=dtype, fused_eval=fused_eval))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*seq))

    def forward(self, x: torch.Tensor) -> list:
        """x: (B, 3, H, W); returns four channels_last NCHW maps."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.bn1(conv2d(x, self.conv1, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            feats.append(x)
        return feats
