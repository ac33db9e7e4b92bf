"""The fused guards' choice by dtype (models/resnet.py:kernel_takes).

On the card the fused kernels K1, K2 and K3 take bf16 activations only; a
block that a guard takes by shape but whose activations are fp32 runs the
block's unfused computation there (``Bottleneck.fp32_unfused_runs`` counts
it). On the CPU the wrappers run the plain versions in any dtype, as the JAX
package's kernels do. These tests need no card: the card's answer of the
predicate is patched in where a forward must take the card's route.
"""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from dir_tpu_torch import serve, weights
from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models import resnet
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.serve import (calibrate_static_scales, flagship_mano,
                                 make_infer, random_init_)

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


# The smallest backbone in which the layer1 guard takes two blocks.
LAYERS = (3, 1, 1, 1)


_KERNEL_TAKES = resnet.kernel_takes


def _on_card(x, dtype):
    """What kernel_takes answers for a CUDA tensor."""
    return _KERNEL_TAKES(types.SimpleNamespace(device=torch.device("cuda")),
                         dtype)


def test_kernel_takes_bf16_only_on_the_card():
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    assert resnet.kernel_takes(cuda, torch.bfloat16)
    assert not resnet.kernel_takes(cuda, torch.float32)
    assert not resnet.kernel_takes(cuda, torch.float16)
    cpu = torch.zeros(1)
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        assert resnet.kernel_takes(cpu, dt)


def _image(b=1):
    return np.random.RandomState(3).randn(b, 256, 256, 3).astype(np.float32)


def _model(seed=0, **cfg):
    return random_init_(DIR(ModelConfig(backbone_layers=LAYERS, **cfg)),
                        seed).eval()


def _outputs_equal(a: dict, b: dict) -> None:
    for sa, sb in zip(a["stages"], b["stages"]):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    for key in ("seg", "dense"):
        assert torch.equal(a[key], b[key]), key


def test_fp32_with_fused_flags_runs_unfused_on_the_card(monkeypatch):
    """fp32 with ``fused_bottleneck_eval=True, fused_l2_bands=4``: on the
    CPU layer1_1 and layer1_2 run K1's plain version; with the card's answer
    they run the unfused fp32 block, equal to the model without the flags."""
    img = _image()
    tl, tr = flagship_mano("/nonexistent")
    model = _model(fused_bottleneck_eval=True, fused_l2_bands=4)
    f = fb.fused_bottleneck_infer
    before = (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs)
    make_infer(model, tl, tr)(img)
    assert (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs) == (
        before[0] + 2, before[1])

    monkeypatch.setattr(resnet, "kernel_takes", _on_card)
    before = (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs)
    out = make_infer(model, tl, tr)(img)
    assert (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs) == (
        before[0], before[1] + 2)
    plain = _model(fused_bottleneck_eval=False)
    _outputs_equal(out, make_infer(plain, tl, tr)(img))

    # a bf16 block keeps the kernel's route with the card's answer
    block = resnet.Bottleneck(256, 64, dtype=torch.bfloat16,
                              fused_eval=True).eval()
    before = (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs)
    with torch.inference_mode():
        block(torch.randn(1, 256, 64, 64))
    assert (f.plain_runs, resnet.Bottleneck.fp32_unfused_runs) == (
        before[0] + 1, before[1])


def test_fp32_with_config_c_runs_the_unfused_int8_route_on_the_card(
        monkeypatch):
    """fp32 with the C flags: on the CPU K3's plain version takes layer1_1
    and layer1_2; with the card's answer they run the unfused int8 route,
    equal to the model with ``quant_fused=False`` on the same scales."""
    img = _image()
    tl, tr = flagship_mano("/nonexistent")
    cfg = dict(serve.CONFIG_C, dtype="float32")
    model = _model(**cfg)
    calibrate_static_scales(model, img, tl, tr)
    unfused = DIR(dataclasses.replace(model.cfg, quant_fused=False)).eval()
    unfused.load_state_dict(model.state_dict(), strict=True)
    weights.load_amax(unfused, weights.quant_stats_to_amax(
        weights.amax_to_quant_stats(model, LAYERS), LAYERS))
    k3 = q8.fused_bottleneck_int8_infer
    before = (k3.plain_runs, resnet.Bottleneck.fp32_unfused_runs)
    make_infer(model, tl, tr)(img)
    assert (k3.plain_runs, resnet.Bottleneck.fp32_unfused_runs) == (
        before[0] + 2, before[1])

    monkeypatch.setattr(resnet, "kernel_takes", _on_card)
    before = (k3.plain_runs, resnet.Bottleneck.fp32_unfused_runs)
    out = make_infer(model, tl, tr)(img)
    assert (k3.plain_runs, resnet.Bottleneck.fp32_unfused_runs) == (
        before[0], before[1] + 2)
    _outputs_equal(out, make_infer(unfused, tl, tr)(img))


@pytest.mark.parametrize("cfg", [dict(fused_bottleneck_eval=True),
                                 dict(serve.CONFIG_C)])
def test_training_never_reaches_a_fused_route(cfg):
    """In train mode neither guard takes a block, whatever the flags, and
    no K3 operands are made."""
    tl, tr = flagship_mano("/nonexistent")
    model = _model(**cfg).train()
    f, k3 = fb.fused_bottleneck_infer, q8.fused_bottleneck_int8_infer
    before = (f.plain_runs, k3.plain_runs,
              resnet.Bottleneck.fp32_unfused_runs)
    model(torch.from_numpy(_image()), tl, tr)
    assert (f.plain_runs, k3.plain_runs,
            resnet.Bottleneck.fp32_unfused_runs) == before
    assert all(m._k3_cache.value is None for m in model.modules()
               if isinstance(m, resnet.Bottleneck))
