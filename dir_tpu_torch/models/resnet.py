"""ResNet backbones returning the 4-level feature pyramid (counterpart of
``dir_tpu/models/resnet.py``, conv7 and s2d stems): DIR's ResNet-50, and
the ResNet-18/34 of :class:`BasicBlock` that DIR never builds.

torchvision v1.5 bottlenecks: the stride sits on the 3x3 conv, padding
is symmetric, and a 1x1 projection exists where the residual shapes
differ. Tensors are NCHW in ``torch.channels_last`` memory format, so
the fused kernel reads them as NHWC without a copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dir_tpu_torch.models.layers import BatchNorm2d, conv2d, conv_bn_relu
from dir_tpu_torch.ops import conv_epilogue as ce
from dir_tpu_torch.ops.fused_bottleneck import fold_bn, fused_bottleneck_infer
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops.fused_bottleneck_int8 import Operands, kernel_operands
from dir_tpu_torch.ops.quant import (ActAmax, module_act_scale,
                                     module_quant_conv, quant_conv)


def kernel_takes(x: torch.Tensor, dtype) -> bool:
    """Whether the fused kernels (K1, K2, K3) take a block's activations of
    ``dtype`` on ``x``'s device. On the card they take bf16 only; on the CPU
    their wrappers run the plain versions, which take any dtype, as the JAX
    package's kernels do."""
    return x.device.type != "cuda" or dtype == torch.bfloat16


class Bottleneck(nn.Module):
    expansion = 4
    # Runs of blocks that a fused guard took by shape but whose activations
    # the kernels do not take (:func:`kernel_takes`): they ran the block's
    # unfused computation instead (fp32 on the card).
    fp32_unfused_runs = 0

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32,
                 fused_eval: bool = False, fused_l2_bands: int = 0,
                 quant_eval: bool = False, quant_static: bool = False,
                 quant_fused: bool = False, quant_fused_l2_bands: int = 0):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.dtype = dtype
        # Inference-only fused kernels (ops/fused_bottleneck.py) for the
        # blocks the guard takes; the parameters are the same either way.
        # fused_l2_bands > 0 extends the guard to the 32x32 (layer2) shape.
        self.fused_eval = fused_eval
        self.fused_l2_bands = fused_l2_bands
        # Inference-only int8 path (ops/quant.py) for the blocks the fused
        # guard above does not take: BN-folded convs as s8 x s8 -> s32, the
        # activation scales live (dynamic) or calibrated (quant_static).
        # With quant_static, quant_fused sends the blocks its guard takes
        # through the fused int8 kernel (ops/fused_bottleneck_int8.py), and
        # quant_fused_l2_bands > 0 extends that guard to the layer2 shape.
        self.quant_eval = quant_eval
        self.quant_static = quant_static
        self.quant_fused = quant_fused
        self.quant_fused_l2_bands = quant_fused_l2_bands
        names = ("conv1_in", "conv2_in", "conv3_in") + (
            ("down_in",) if downsample else ())
        self.quant_stats = ActAmax(names) if quant_eval else None
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False),
            BatchNorm2d(out)) if downsample else None)
        # K3's operands, kept with what they were made from (k3_operands)
        self._k3_cache = ce.Kept()
        # The folded operands of the fused eval route (_epilogue_infer)
        self._folded = ce.Kept()

    def _fused_bands(self, x: torch.Tensor, l2_bands: int) -> int | None:
        """The guard of the JAX package's fused blocks (K1/K2, or K3 with
        its ``l2_bands``): stride 1, >= 128 input channels, and >= 4096
        spatial positions (layer1_1, layer1_2: bands 0) or, with
        ``l2_bands``, >= 1024 (layer2_1..3: bands ``l2_bands``). None where
        it does not take the block, and where the kernels do not take its
        activations (:func:`kernel_takes`; on the card bf16 only), which
        ``fp32_unfused_runs`` counts: the block then runs unfused."""
        spatial = x.shape[2] * x.shape[3]
        if (self.stride != 1 or x.shape[1] < 128
                or not (spatial >= 4096 or (spatial >= 1024 and l2_bands))):
            return None
        if not kernel_takes(x, self.dtype):
            Bottleneck.fp32_unfused_runs += 1
            return None
        return 0 if spatial >= 4096 else l2_bands

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = (self._fused_bands(x, self.fused_l2_bands)
                 if self.fused_eval and not self.training else None)
        if bands is not None:
            return self._fused_infer(x, bands)
        if self.quant_eval and not self.training:
            return self._quant_infer(x)
        if ce.engages(self, x):
            return self._epilogue_infer(x)
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

    def _fused_infer(self, x: torch.Tensor, bands: int = 0) -> torch.Tensor:
        """Run the whole block as one fused kernel on the NHWC view of
        ``x``, with the folded weights."""
        y = fused_bottleneck_infer(x.to(self.dtype).permute(0, 2, 3, 1),
                                   *self.folded_weights(), bands=bands)
        return y.permute(0, 3, 1, 2)

    def _pairs(self) -> list:
        """Each conv with the BN after it, the projection's last."""
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2),
                 (self.conv3, self.bn3)]
        if self.downsample is not None:
            pairs.append(tuple(self.downsample))
        return pairs

    def _epilogue_operands(self) -> list:
        """``[w1, b1, w2, b2, w3, b3, wd]`` for :meth:`_epilogue_infer`:
        each BN folded into its conv (``conv_epilogue.fold``), the
        projection's folded bias moved into ``b3``; ``wd`` None without a
        projection."""
        folded = [ce.fold(conv, bn, self.dtype) for conv, bn in self._pairs()]
        (w1, b1), (w2, b2), (w3, b3) = folded[:3]
        wd = None
        if self.downsample is not None:
            wd, bd = folded[3]
            b3 = b3 + bd
        return [w1, b1, w2, b2, w3, b3, wd]

    def _epilogue_infer(self, x: torch.Tensor) -> torch.Tensor:
        """The block at inference with each conv's BN folded in and its
        bias, the residual and the ReLU in the pass after it:
        ``relu(conv3'(y2) + conv_d'(x) + (b3 + bd))`` with a projection
        (whose conv runs without a bias), ``relu(conv3'(y2) + b3 + x)``
        without."""
        w1, b1, w2, b2, w3, b3, wd = self._folded.get(
            self._pairs(), self._epilogue_operands)
        out = ce.conv_bias_relu(x, w1, b1)
        out = ce.conv_bias_relu(out, w2, b2, self.stride, 1)
        z = x if wd is None else F.conv2d(x, wd, None, self.stride)
        return ce.conv_bias_relu(out, w3, b3, z=z)

    def k3_operands(self) -> Operands:
        """The operands of K3 for this block (``kernel_operands`` of the
        folded weights and the calibrated scales), made once and kept
        (``conv_epilogue.Kept``, with the three scales among the sources);
        never while calibrating, when the scales are still moving."""
        if self.quant_stats.calibrating:
            raise RuntimeError("K3's operands are not made while "
                               "calibrating")
        if torch.compiler.is_exporting():
            # the parameters are fake while a graph is exported: the
            # operands kept from a forward on the real ones become the
            # graph's constants
            if self._k3_cache.value is None:
                raise RuntimeError("K3's operands are made by a forward "
                                   "before the model is exported")
            return self._k3_cache.value
        names = ("conv1_in", "conv2_in", "conv3_in")

        def make():
            with torch.no_grad():
                scales = [module_act_scale(self.quant_stats, n, None, True)
                          for n in names]
                w = self.folded_weights()
                return kernel_operands(*w[:6], *scales, *w[6:])

        return self._k3_cache.get(
            self._pairs(), make,
            extra=[getattr(self.quant_stats, n) for n in names])

    def _quant_infer(self, x: torch.Tensor) -> torch.Tensor:
        """Run the block's convs int8-quantized on the NHWC view of ``x``:
        BN folded into each conv, the folded kernels quantized per output
        channel, the activations per tensor; the residual add and the ReLU
        stay in the trunk dtype."""
        dt, st = self.dtype, (self.stride, self.stride)
        xn = x.permute(0, 2, 3, 1)

        def scale(name, v):
            return module_act_scale(self.quant_stats, name, v,
                                    self.quant_static)

        # The fused int8 kernel where the fused guard takes the block:
        # static scales only (a dynamic scale is a reduction over the whole
        # batch), never while calibrating (the unfused route records the
        # maxes); layer2 through quant_fused_l2_bands. It runs the op on the
        # block's kept operands: K3 on the card, its plain version on the
        # CPU. Elsewhere the block runs the unfused int8 route.
        if (self.quant_fused and self.quant_static
                and not self.quant_stats.calibrating
                and self._fused_bands(x, self.quant_fused_l2_bands)
                is not None):
            return q8.call(xn.to(dt), self.k3_operands()).permute(0, 3, 1, 2)

        w1, b1, w2, b2, w3, b3, wd, bd = self.folded_weights()
        out = torch.relu(quant_conv(xn, w1[None, None], bias=b1, out_dtype=dt,
                                    act_scale=scale("conv1_in", xn)))
        out = torch.relu(quant_conv(out, w2, st, ((1, 1), (1, 1)), b2, dt,
                                    act_scale=scale("conv2_in", out)))
        out = quant_conv(out, w3[None, None], bias=b3, out_dtype=dt,
                         act_scale=scale("conv3_in", out))
        identity = xn.to(dt)
        if self.downsample is not None:
            identity = quant_conv(xn, wd[None, None], st, "SAME", bd, dt,
                                  act_scale=scale("down_in", xn))
        return torch.relu(out + identity).permute(0, 3, 1, 2)


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C), channel index
    ((a*b)+bb)*C + c for the offset (a, bb) inside a block."""
    b_, h, w, c = x.shape
    x = x.reshape(b_, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b_, h // block, w // block, block * block * c)


def stem_weights_to_s2d(w7: torch.Tensor) -> torch.Tensor:
    """Exact rewrite of the 7x7/stride-2 stem kernel (7, 7, C, O) into the
    4x4/stride-1 kernel (4, 4, 4C, O) applied after ``space_to_depth(2)``
    with padding (2, 1).

    Output (i, j) of the original conv reads input rows 2i+di-3, di in
    [0, 7); in 2-block coordinates row r = 2p+a, so di = 2*pi - 1 + a for
    the block-row offset pi in [0, 4). Entries with di outside [0, 7) are
    zero.
    """
    w7 = np.asarray(w7)
    c, o = w7.shape[2], w7.shape[3]
    w4 = np.zeros((4, 4, 4 * c, o), w7.dtype)
    for pi in range(4):
        for pj in range(4):
            for a in range(2):
                for b_ in range(2):
                    di = 2 * pi - 1 + a
                    dj = 2 * pj - 1 + b_
                    if 0 <= di < 7 and 0 <= dj < 7:
                        ch = (a * 2 + b_) * c
                        w4[pi, pj, ch:ch + c] = w7[di, dj]
    return torch.from_numpy(w4)


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual (torchvision's ``BasicBlock``), the
    stride on the first conv; the blocks of ``resnet18``/``resnet34``.
    DIR never builds it. Training and eval run the plain computation: the
    fused and int8 paths belong to :class:`Bottleneck` only."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False),
            BatchNorm2d(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        out = torch.relu(self.bn1(conv2d(x, self.conv1, dt)))
        out = self.bn2(conv2d(out, self.conv2, dt))
        identity = x
        if self.downsample is not None:
            identity = self.downsample[1](conv2d(x, self.downsample[0], dt))
        return torch.relu(out + identity)


class ResNetPyramid(nn.Module):
    """ResNet emitting [c1, c2, c3, c4] at strides 4/8/16/32.

    stem: "conv7" is the torchvision layout; "s2d" applies
    space-to-depth(2), then the equivalent 4x4/stride-1 conv on the
    12-channel map, padded (2, 1) on both axes (``conv1.weight`` is then
    (64, 12, 4, 4); :func:`stem_weights_to_s2d` converts conv7 weights
    exactly).

    block: "bottleneck" (:class:`Bottleneck`, expansion 4) or "basic"
    (:class:`BasicBlock`, expansion 1, which takes none of the fused or
    int8 flags).
    """

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.float32, fused_eval: bool = False,
                 stem: str = "conv7", fused_l2_bands: int = 0,
                 quant_eval: bool = False, quant_static: bool = False,
                 quant_stem: bool = False, quant_fused: bool = False,
                 quant_fused_l2_bands: int = 0, block: str = "bottleneck"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        if block not in ("bottleneck", "basic"):
            raise ValueError(f"unknown block {block!r}")
        blk = Bottleneck if block == "bottleneck" else BasicBlock
        flags = dict(fused_eval=fused_eval, fused_l2_bands=fused_l2_bands,
                     quant_eval=quant_eval, quant_static=quant_static,
                     quant_fused=quant_fused,
                     quant_fused_l2_bands=quant_fused_l2_bands
                     ) if block == "bottleneck" else {}
        self.dtype = dtype
        self.stem = stem
        # Int8 stem conv with bn1 folded in (cfg.quant_aux_eval).
        self.quant_stem = quant_stem
        self.quant_static = quant_static
        self.quant_stats = ActAmax(("conv1_in",)) if quant_stem else None
        self.conv1 = (nn.Conv2d(3, 64, 7, 2, 3, bias=False) if stem == "conv7"
                      else nn.Conv2d(12, 64, 4, 1, 0, bias=False))
        self.bn1 = BatchNorm2d(64)
        # The stem's folded operands on the fused eval route (conv_bn_relu)
        self._folded = ce.Kept()
        inplanes = 64
        for stage, (blocks, planes) in enumerate(
                zip(layers, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            seq = []
            for b in range(blocks):
                down = b == 0 and (stride != 1
                                   or inplanes != planes * blk.expansion)
                seq.append(blk(inplanes, planes, stride if b == 0 else 1,
                               down, dtype=dtype, **flags))
                inplanes = planes * blk.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*seq))

    def _quant_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The stem conv in int8 with bn1 folded in, on the NHWC image;
        returns the channels_last NCHW map before the ReLU."""
        if self.stem == "s2d":
            x, stride, pad = space_to_depth(x), (1, 1), ((2, 1), (2, 1))
        else:
            stride, pad = (2, 2), ((3, 3), (3, 3))
        y = module_quant_conv(self.quant_stats, "conv1", x, self.conv1,
                              stride, pad, static=self.quant_static,
                              out_dtype=self.dtype, bn=self.bn1)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> list:
        """x: (B, 3, H, W); returns four channels_last NCHW maps."""
        x = x.to(self.dtype)
        if self.quant_stem and not self.training:
            x = torch.relu(self._quant_stem(x.permute(0, 2, 3, 1)))
        else:
            if self.stem == "s2d":
                x = space_to_depth(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
                x = F.pad(x, (2, 1, 2, 1))
            x = conv_bn_relu(self, self._folded, self.conv1, self.bn1,
                             x.contiguous(memory_format=torch.channels_last))
        x = F.max_pool2d(x, 3, 2, 1)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = []
        for name in ("layer1", "layer2", "layer3", "layer4"):
            x = getattr(self, name)(x)
            feats.append(x)
        return feats


def resnet50(**kw) -> ResNetPyramid:
    return ResNetPyramid(layers=(3, 4, 6, 3), **kw)


def resnet18(**kw) -> ResNetPyramid:
    """The reference's vendored ``resnet18`` (DIR never builds it)."""
    return ResNetPyramid(layers=(2, 2, 2, 2), block="basic", **kw)


def resnet34(**kw) -> ResNetPyramid:
    """The reference's vendored ``resnet34`` (DIR never builds it)."""
    return ResNetPyramid(layers=(3, 4, 6, 3), block="basic", **kw)
