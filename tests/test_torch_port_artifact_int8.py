"""The serving artifact of configuration C (int8 static, the fused int8
bottleneck K3 at layer1 and layer2) on the CPU, and the fixed-batch round
trips of A and C (``dir_tpu_torch/serve.py``).

C's blocks keep their K3 operands from a forward on the real weights; the
exported program holds them as constants instead of tracing their making.
Backbone and weights are ``test_torch_port_artifact.py``'s
(``torch_port_artifact_helpers.py``).
"""

import os
import sys

import pytest

from dir_tpu_torch import serve
from dir_tpu_torch.models.resnet import Bottleneck
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_artifact_helpers import (OPS, assert_equal,  # noqa: E402
                                         fixed_batch_round_trip, image, live,
                                         weights)
from torch_port_helpers import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _four_threads():
    with torch_threads(4):
        yield


@pytest.fixture(scope="module")
def state_dict():
    return weights()[1]


@pytest.fixture(scope="module")
def exported_c(state_dict):
    model, ml, mr = live(state_dict, "C")
    program = serve.export_program(model, ml, mr)
    return model, (ml, mr), program, serve.load_infer(
        serve.serialize(program))


def test_int8_artifact_names_k3_and_keeps_its_operands(exported_c):
    """The graph names K3's op at layer1_1, layer1_2 and layer2_1, and K3's
    operands enter it as constants (the program never quantizes a fused
    block's weights): every fused block's kept image is among them."""
    model, _, program, _ = exported_c
    assert serve.op_counts(program) == OPS["C"]
    images = [m._k3_cache.value.image for m in model.modules()
              if isinstance(m, Bottleneck) and m._k3_cache.value is not None]
    assert len(images) == 3
    constants = list(program.constants.values())
    for img in images:
        assert any(c.shape == img.shape and c.dtype == img.dtype
                   and bool((c == img).all()) for c in constants)


def test_int8_artifact_equals_the_live_model_at_any_batch(exported_c):
    """Measured max abs err 0 at batch 1 and 3 (the same ops on the same
    tensors and the same static scales)."""
    model, (ml, mr), _, infer = exported_c
    live_infer = serve.make_infer(model, ml, mr)
    runs = q8.fused_bottleneck_int8_infer.plain_runs
    for b, seed in ((1, 1), (3, 2)):
        img = image(b, seed)
        assert_equal(infer(img), live_infer(img))
    assert q8.fused_bottleneck_int8_infer.plain_runs - runs == 4 * 3


def test_fixed_batch_artifact_round_trip_c(exported_c, tmp_path):
    model, (ml, mr), _, _ = exported_c
    fixed_batch_round_trip(model, ml, mr, str(tmp_path / "c.pt2"))


def test_fixed_batch_artifact_round_trip_a(state_dict, tmp_path):
    model, ml, mr = live(state_dict, "A")
    fixed_batch_round_trip(model, ml, mr, str(tmp_path / "a.pt2"))
