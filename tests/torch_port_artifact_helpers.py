"""Shared set-up of the serving-artifact tests
(``test_torch_port_artifact*.py``): the configurations, the op counts of
their exported graphs, seeded weights of both packages, the live port
model, and configuration B's symbolic-batch artifact, exported once a
session (``exported_b``): an export of even the tiny DIR costs 10-30 s
here and a load 10-25 s."""

import os
import sys
from typing import Callable, NamedTuple

import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models.dir import DIR as JDIR

from dir_tpu_torch import serve
from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree  # noqa: E402
from torch_port_train_helpers import jax_variables, port_manos  # noqa: E402

# The smallest backbone at which each op appears: K1 needs layer1_1 and
# layer1_2, K2 and the int8 layer2 route a stride-1 layer2 block.
LAYERS = (3, 2, 1, 1)
CONFIGS = {
    "A": dict(fused_bottleneck_eval=True),
    "B": dict(fused_bottleneck_eval=True, **serve.CONFIG_B),
    "C": dict(serve.CONFIG_C),
}
# op nodes of each exported graph at LAYERS
OPS = {
    "A": {"fused_bottleneck": 2, "fused_bottleneck_int8": 0,
          "fused_stem_bottleneck": 0, "bone_splat": 0},
    "B": {"fused_bottleneck": 3, "fused_bottleneck_int8": 0,
          "fused_stem_bottleneck": 0, "bone_splat": 4},
    "C": {"fused_bottleneck": 0, "fused_bottleneck_int8": 3,
          "fused_stem_bottleneck": 0, "bone_splat": 0},
}


def image(b, seed):
    return np.random.RandomState(seed).randn(b, 256, 256, 3).astype(
        np.float32)


def weights():
    """Seeded random JAX variables of the tiny DIR (the init's shapes only)
    and the port's state_dict of the same weights."""
    variables = jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS)),
                              np.zeros((1, 256, 256, 3), np.float32))
    sd = jax_to_state_dict(numpy_tree(variables["params"]),
                           numpy_tree(variables["batch_stats"]), LAYERS)
    return variables, sd


def live(sd, name):
    """The port's model in configuration ``name`` on ``sd`` (C calibrated
    on two seeded images) and the MANO pair."""
    model = DIR(ModelConfig(backbone_layers=LAYERS, **CONFIGS[name]))
    model.load_state_dict(sd, strict=True)
    model.eval()
    ml, mr = port_manos()
    if name == "C":
        serve.calibrate_static_scales(model, image(2, 7), ml, mr)
    return model, ml, mr


def assert_equal(got: dict, want: dict):
    """Every output of an artifact equal to the live model's."""
    flat_g, spec_g = torch.utils._pytree.tree_flatten(got)
    flat_w, spec_w = torch.utils._pytree.tree_flatten(want)
    assert spec_g == spec_w
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


def check_fixed_batch(infer, model, ml, mr):
    """A loaded artifact exported at a fixed batch of 2: equal to the live
    model at batch 2; another batch is refused."""
    img = image(2, 3)
    assert_equal(infer(img), serve.make_infer(model, ml, mr)(img))
    try:
        infer(image(3, 3))
    except Exception:  # noqa: BLE001 — the program's shape guard
        return
    raise AssertionError("a fixed-batch artifact took another batch")


def fixed_batch_round_trip(model, ml, mr, path):
    """Export at a fixed batch of 2 through a file and check it
    (:func:`check_fixed_batch`)."""
    blob = serve.export_infer(model, ml, mr, batch_size=2)
    assert blob.startswith(serve._MAGIC)
    serve.save(path, blob)
    del blob
    check_fixed_batch(serve.load(path), model, ml, mr)


class Exported(NamedTuple):
    name: str
    model: torch.nn.Module      # the live model
    manos: tuple
    program: object             # the torch.export program
    infer: Callable             # the artifact loaded back
    path: str                   # ... from this file


def export_round_trip(sd, name: str, path: str) -> Exported:
    """Configuration ``name`` on ``sd`` exported with a symbolic batch,
    written to ``path`` and loaded back from it."""
    model, ml, mr = live(sd, name)
    program = serve.export_program(model, ml, mr)
    serve.save(path, serve.serialize(program))
    return Exported(name, model, (ml, mr), program, serve.load(path), path)


@pytest.fixture(scope="session")
def seeded_weights():
    """:func:`weights`, made once a session."""
    return weights()


@pytest.fixture(scope="session")
def exported_b(seeded_weights, tmp_path_factory):
    """Configuration B's symbolic-batch artifact, made once a session: the
    op counts, the round trip, the comparison with ``dir_tpu``'s artifact
    and the HTTP server all use it."""
    path = str(tmp_path_factory.mktemp("artifact_b") / "b.pt2")
    yield export_round_trip(seeded_weights[1], "B", path)
    os.remove(path)
