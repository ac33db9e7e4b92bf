"""Serving entry points of the port: build the flagship model and answer
``img -> outputs`` requests (counterpart of ``__graft_entry__._flagship``
and of the inference step of ``dir_tpu/serve.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.device import resolve_device
from dir_tpu_torch.mano.assets import (ManoModel, fix_left_shapedirs,
                                       load_mano_pair, synthetic_mano)
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.models.gcn import PGraphConv
from dir_tpu_torch.ops import quant

# The keyword arguments of :func:`build_flagship` that select configuration B.
CONFIG_B = {"fused_l2_bands": 4, "fused_splat_conv": False,
            "use_pallas_splat": True}
# ... and configuration C: int8 static serving of the backbone, the decoder
# and the auxiliary convs, with the fused int8 bottleneck at layer1 and
# layer2. It needs :func:`calibrate_static_scales` before the first request.
CONFIG_C = {"fused_bottleneck_eval": False, "quant_backbone_eval": True,
            "quant_decoder_eval": True, "quant_aux_eval": True,
            "quant_static": True, "quant_fused": True,
            "quant_fused_l2_bands": 4}

# Linear layers that regress MANO parameters / the offset start near zero.
_HEAD_NAMES = ("mano_left", "mano_right", "offset")
# Bias of the MANO parameter heads set by :func:`condition_random_`: the
# identity 6D root and a camera scale at which the hand spans about half
# the crop.
_MANO_HEAD_BIAS = {0: 1.0, 4: 1.0, 61: 5.0}


def random_init_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights following the JAX package's initializers:
    truncated-normal fan-out convs, lecun-normal linear layers, N(0, 1e-3)
    parameter heads, the graph convs' torch xavier-uniform, and BatchNorm
    scales and shifts near 1 and 0 (running statistics stay at mean 0,
    variance 1, as ``init`` leaves them in the JAX package). All draws
    come from one CPU ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)

    def trunc(w: torch.Tensor, fan: int, scale: float) -> None:
        # variance_scaling(truncated_normal): the std of the truncated
        # draw is sqrt(scale / fan)
        std = math.sqrt(scale / fan) / 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Conv2d):
                o, _, kh, kw = m.weight.shape
                trunc(m.weight, o * kh * kw, 2.0)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                trunc(m.weight, m.weight.shape[1], 1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Linear):
                head = name.rsplit(".", 1)[-1]
                if head in _HEAD_NAMES:
                    m.weight.normal_(0.0, 1e-3, generator=g)
                else:
                    trunc(m.weight, m.weight.shape[1], 1.0)
                m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, PGraphConv):
                _, j, cin, cout = m.W.shape
                bound = 1.414 * math.sqrt(6.0 / (j * cin * cout
                                                 + 2 * cin * cout))
                m.W.uniform_(-bound, bound, generator=g)
                m.e_0.fill_(1.0)
                m.e_1.fill_(1.0)
                m.bias.uniform_(-1 / math.sqrt(j), 1 / math.sqrt(j),
                                generator=g)
        for name, p in model.named_parameters():
            if name.endswith("spatial_pos_embed"):
                p.zero_()
    return model


def condition_random_(model: DIR, mano_left: ManoModel,
                      mano_right: ManoModel, seed: int) -> DIR:
    """Make a randomly initialized model fit for holding its bf16 forward
    against its fp32 one; no request needs this, and real weights make it
    moot.

    It starts every MANO parameter head (the init regressor's and each
    refine stage's) at the identity root rotation and a camera scale at
    which the hand spans about half the crop: with zero biases the root
    6D vector is near zero, and normalizing it turns bf16 noise into
    rotations of tens of degrees. Then it sets every BatchNorm's running
    statistics to the batch statistics of 8 seeded N(0, 1) 256x256
    images, as training leaves them, so that activations stay at unit
    scale. Returns the model in eval mode.
    """
    dev = next(model.parameters()).device
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.rsplit(".", 1)[-1] in ("mano_left", "mano_right"):
                for i, v in _MANO_HEAD_BIAS.items():
                    m.bias[i] = v
        for m in norms:
            m.reset_running_stats()
            m.momentum = None          # cumulative average over the pass
        g = torch.Generator().manual_seed(seed)
        images = torch.randn((8, 256, 256, 3), generator=g).to(dev)
        model.train()
        model(images, mano_left.to(dev), mano_right.to(dev))
    for m in norms:
        m.momentum = 0.1
    return model.eval()


def flagship_mano(assets_dir: str = "./assets/mano"):
    """(left, right) MANO models: the converted assets when present,
    otherwise the seeded synthetic stand-ins."""
    try:
        return load_mano_pair(assets_dir)
    except FileNotFoundError:
        right = synthetic_mano("right", seed=0)
        return fix_left_shapedirs(synthetic_mano("left", seed=0), right), right


def build_flagship(device=None, dtype: str = "bfloat16",
                   fused_bottleneck_eval: bool = True, seed: int = 0,
                   fused_l2_bands: int = 0, fused_splat_conv: bool = True,
                   use_pallas_splat: bool = False,
                   quant_backbone_eval: bool = False,
                   quant_decoder_eval: bool = False,
                   quant_aux_eval: bool = False, quant_static: bool = False,
                   quant_fused: bool = False, quant_fused_l2_bands: int = 0):
    """The flagship DIR model (ResNet-50) in eval mode with seeded random
    weights, and the MANO pair of :func:`flagship_mano`.

    The defaults are configuration A (the fused bottleneck at layer1, the
    factored splat conv). ``fused_l2_bands=4, fused_splat_conv=False,
    use_pallas_splat=True`` is configuration B: the fused bottleneck at
    layer2 as well, and the materialized bone splat through its kernel.
    ``**CONFIG_C`` is configuration C: int8 static serving (the fused
    bf16 kernel off, the fused int8 kernel on), which serves only after
    :func:`calibrate_static_scales`. All hold the same parameters, so one
    ``state_dict`` loads into any of them.

    Runs on CUDA unless ``device`` names another device; raises when no
    card is present and none was named. Returns
    ``(model, cfg, mano_left, mano_right)``, all on ``device``.
    """
    dev = resolve_device(device)
    cfg = ModelConfig(dtype=dtype, fused_bottleneck_eval=fused_bottleneck_eval,
                      fused_l2_bands=fused_l2_bands,
                      fused_splat_conv=fused_splat_conv,
                      use_pallas_splat=use_pallas_splat,
                      quant_backbone_eval=quant_backbone_eval,
                      quant_decoder_eval=quant_decoder_eval,
                      quant_aux_eval=quant_aux_eval,
                      quant_static=quant_static, quant_fused=quant_fused,
                      quant_fused_l2_bands=quant_fused_l2_bands)
    model = random_init_(DIR(cfg), seed).to(dev).eval()
    mano_l, mano_r = (m.to(dev) for m in flagship_mano())
    return model, cfg, mano_l, mano_r


def calibrate_static_scales(model: DIR, img, mano_left: ManoModel,
                            mano_right: ManoModel) -> DIR:
    """One calibration forward of an int8 model on its own device: every
    int8 conv input's ``|max|`` over ``img`` ((B, H, W, 3) float32 array or
    tensor) is folded into the model's scales for static serving. The maxes
    accumulate over calls. Returns the model, in eval mode."""
    dev = next(model.parameters()).device
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(img)
    return quant.calibrate_static_scales(
        model.eval(), img.to(dev, torch.float32), mano_left.to(dev),
        mano_right.to(dev))


def make_infer(model: DIR, mano_left: ManoModel, mano_right: ManoModel):
    """``img -> outputs`` for an eval-mode model: ``img`` is a (B, H, W, 3)
    float32 array or tensor; it runs under ``torch.inference_mode()`` on
    the model's device and returns the model's output dict."""
    dev = next(model.parameters()).device
    mano_left, mano_right = mano_left.to(dev), mano_right.to(dev)
    model.eval()

    def infer(img) -> dict:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(img)
        with torch.inference_mode():
            return model(img.to(dev, torch.float32), mano_left, mano_right)

    return infer
