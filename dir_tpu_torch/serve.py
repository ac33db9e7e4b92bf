"""Serving entry points of the port: build the flagship model, answer
``img -> outputs`` requests, and export the inference step as a serving
artifact (counterpart of ``__graft_entry__._flagship`` and of
``dir_tpu/serve.py``).

The artifact (:func:`export_infer`) is a ``torch.export`` program of the
eval forward, traced once with the weights and the MANO tensors embedded
as constants, behind a magic header. The kernels are ops the program names
(``torch.ops.dir_tpu.*``, ``ops/library.py``): loading it (:func:`load_infer`)
needs those registrations and no model code; this module imports the models
only inside the functions that build one. The program holds constants made
on the device it was exported on, so it serves there: export on the device
you serve on, with the torch version you serve with.
"""

from __future__ import annotations

import io
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.device import no_tf32, resolve_device
from dir_tpu_torch.mano.assets import (ManoModel, fix_left_shapedirs,
                                       load_mano_pair, synthetic_mano)
from dir_tpu_torch.ops import quant
from dir_tpu_torch.weights import random_init_  # noqa: F401 (re-export)

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

# Bias of the MANO parameter heads set by :func:`condition_random_`: the
# identity 6D root and a camera scale at which the hand spans about half
# the crop.
_MANO_HEAD_BIAS = {0: 1.0, 4: 1.0, 61: 5.0}


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
                   quant_fused: bool = False, quant_fused_l2_bands: int = 0,
                   **overrides):
    """The flagship DIR model (ResNet-50) in eval mode with seeded random
    weights, and the MANO pair of :func:`flagship_mano`.

    The defaults are configuration A (the fused bottleneck at layer1, the
    factored splat conv). ``fused_l2_bands=4, fused_splat_conv=False,
    use_pallas_splat=True`` is configuration B: the fused bottleneck at
    layer2 as well, and the materialized bone splat through its kernel.
    ``**CONFIG_C`` is configuration C: int8 static serving (the fused
    bf16 kernel off, the fused int8 kernel on), which serves only after
    :func:`calibrate_static_scales`. All hold the same parameters, so one
    ``state_dict`` loads into any of them. ``overrides`` are further
    :class:`ModelConfig` fields (``backbone_stem``, ``backbone_layers``,
    ...), as ``__graft_entry__._flagship`` takes them.

    Runs on CUDA unless ``device`` names another device; raises when no
    card is present and none was named. Returns
    ``(model, cfg, mano_left, mano_right)``, all on ``device``.
    """
    from dir_tpu_torch.models.dir import DIR

    dev = resolve_device(device)
    cfg = ModelConfig(dtype=dtype, fused_bottleneck_eval=fused_bottleneck_eval,
                      fused_l2_bands=fused_l2_bands,
                      fused_splat_conv=fused_splat_conv,
                      use_pallas_splat=use_pallas_splat,
                      quant_backbone_eval=quant_backbone_eval,
                      quant_decoder_eval=quant_decoder_eval,
                      quant_aux_eval=quant_aux_eval,
                      quant_static=quant_static, quant_fused=quant_fused,
                      quant_fused_l2_bands=quant_fused_l2_bands, **overrides)
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
    float32 array or tensor; it runs under ``torch.inference_mode()`` with
    TF32 off (``device.no_tf32``) on the model's device and returns the
    model's output dict."""
    dev = next(model.parameters()).device
    mano_left, mano_right = mano_left.to(dev), mano_right.to(dev)
    model.eval()

    def infer(img) -> dict:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(img)
        with torch.inference_mode(), no_tf32():
            return model(img.to(dev, torch.float32), mano_left, mano_right)

    return infer


# Artifact header: magic and version, so that a foreign file fails loudly
# instead of reaching the archive reader.
_MAGIC = b"DIRTPU-TORCH-SERVE-v1\n"
# The range of a symbolic batch.
MAX_BATCH = 4096


class _Step(nn.Module):
    """The inference step ``img -> outputs`` with the MANO pair held as
    constants."""

    def __init__(self, model: nn.Module, mano_left: ManoModel,
                 mano_right: ManoModel):
        super().__init__()
        self.model = model
        self.mano_left, self.mano_right = mano_left, mano_right

    def forward(self, img: torch.Tensor) -> dict:
        return self.model(img, self.mano_left, self.mano_right)


def export_program(model: nn.Module, mano_left: ManoModel,
                   mano_right: ManoModel, batch_size: Optional[int] = None,
                   img_size: int = 256) -> torch.export.ExportedProgram:
    """The ``torch.export`` program of the eval forward on the model's
    device (non-strict, under ``torch.no_grad()`` with TF32 off).

    ``batch_size`` None makes the batch symbolic (1 to ``MAX_BATCH``).
    One forward on a seeded batch comes first, on the real tensors: it makes
    the per-device constants (``device.index_tensor``, the kernels' layout
    indices) and an int8 model's kept K3 operands, which the trace then
    holds as constants instead of tracing their making."""
    dev = next(model.parameters()).device
    mano_left, mano_right = mano_left.to(dev), mano_right.to(dev)
    step = _Step(model.eval(), mano_left, mano_right)
    b = batch_size or 2
    g = torch.Generator().manual_seed(0)
    img = torch.randn((b, img_size, img_size, 3), generator=g).to(dev)
    dynamic = (None if batch_size else
               ({0: torch.export.Dim("batch", min=1, max=MAX_BATCH)},))
    with torch.no_grad(), no_tf32():
        step(img)
        return torch.export.export(step, (img,), dynamic_shapes=dynamic,
                                   strict=False)


def export_infer(model: nn.Module, mano_left: ManoModel,
                 mano_right: ManoModel, batch_size: Optional[int] = None,
                 img_size: int = 256) -> bytes:
    """Serialize the inference step ``img -> outputs`` as an artifact
    (:func:`serialize` of :func:`export_program`: weights and MANO tensors
    embedded)."""
    return serialize(export_program(model, mano_left, mano_right,
                                    batch_size, img_size))


def serialize(program: torch.export.ExportedProgram) -> bytes:
    """The magic header, then the ``torch.export.save`` archive."""
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return _MAGIC + buf.getvalue()


def op_counts(program: torch.export.ExportedProgram) -> dict:
    """How many nodes of the program's graph call each ``dir_tpu`` op."""
    from dir_tpu_torch.ops.library import OPS

    counts = dict.fromkeys(OPS, 0)
    for node in program.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith("dir_tpu::"):
            counts[name.split("::")[1].split(".")[0]] += 1
    return counts


def load_infer(blob: bytes) -> Callable:
    """An artifact as ``img -> outputs``: ``img`` a (B, H, W, 3) float32
    array or tensor; the output dict is the model's (``stages[-1]
    ["pd_mesh_xyz_left"]``, ``seg``, ``dense``, ...). It runs as
    :func:`make_infer` runs the live model: under ``torch.inference_mode()``
    with TF32 off, on the device the artifact was exported on (the
    callable's ``device``). Imports the op registrations and no model
    code; raises ``ValueError`` on a foreign blob."""
    if not blob.startswith(_MAGIC):
        raise ValueError("not a dir_tpu_torch serving artifact (bad magic)")
    from dir_tpu_torch.ops import library  # noqa: F401  the ops it names

    module = torch.export.load(io.BytesIO(blob[len(_MAGIC):])).module()
    dev = next(module.parameters()).device

    def infer(img) -> dict:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(img)
        with torch.inference_mode(), no_tf32():
            return module(img.to(dev, torch.float32))

    infer.device = dev
    return infer


def save(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def load(path: str) -> Callable:
    with open(path, "rb") as f:
        return load_infer(f.read())
