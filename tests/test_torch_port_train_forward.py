"""The port's train-mode forward against dir_tpu's.

On the shared set-up of ``torch_port_train_helpers`` (tiny backbone at
64x64, batch 2): a train-mode forward's outputs and the BN running stats it
leaves, against ``model.apply(..., train=True, mutable=["batch_stats"])``,
at fp32, for both decoders: the factored splat conv (the default) and the
materialized bone splat through K5's route (``use_pallas_splat``: Pallas in
interpret mode on the JAX side, the plain version on the CPU here).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models.dir import DIR as JDIR

from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_model import _tpu_interpret_mode  # noqa: E402
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                torch_threads)
from torch_port_train_helpers import (LAYERS, jax_manos,  # noqa: E402
                                      jax_variables, make_batch, port_manos,
                                      port_model)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


DECODERS = {"factored": {},
            "k5_route": dict(fused_splat_conv=False, use_pallas_splat=True)}

# Measured max abs error of the port's train-mode forward against dir_tpu's
# at fp32 on this input, over all three stages and both decoders. Train-mode
# BN normalizes with the batch's own statistics, at layer4 over 8 values a
# channel, so fp32 rounding grows more than in eval (the fp64 gradient test
# of test_torch_port_train.py holds the same forward to 1e-14); the largest
# errors are the init regressor's, about 4e-6 of values up to 3.6. Each
# bound is about ten times the measurement.
FORWARD_TOL = {
    "xyz": 2e-5,      # measured 1.6e-6 (meters, values ~0.15)
    "uv": 1.5e-4,     # measured 1.2e-5, values up to 2.4
    "other": 1.5e-4,  # offset, MANO parameters, projection: measured 1.4e-5
    "head": 3e-4,     # seg/dense logits: measured 3.2e-5, values up to 2.2
    "stats": 6e-5,    # BN running stats, of each tensor's max: 6.4e-6
}


@pytest.fixture(scope="module")
def fp32_variables():
    batch = make_batch(np.random.RandomState(2))
    variables = jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS)),
                              batch["img"])
    return variables, batch


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_train_forward_and_bn_stats_match_jax(fp32_variables, decoder):
    variables, batch = fp32_variables
    cfg = DECODERS[decoder]
    ml, mr = jax_manos()
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS, **cfg))
    with _tpu_interpret_mode():
        ref, updates = jmodel.apply(variables, jnp.asarray(batch["img"]), ml,
                                    mr, train=True, mutable=["batch_stats"])
    want_stats = jax_to_state_dict({}, numpy_tree(updates["batch_stats"]),
                                   LAYERS)

    model = port_model(variables, **cfg).train()
    tl, tr = port_manos()
    before = (bs.bone_splat.launches, bs.bone_splat.plain_runs)
    out = model(torch.from_numpy(batch["img"]), tl, tr)
    # K5's route: 2 hands x 2 stages, the plain version on the CPU
    runs = 4 if cfg else 0
    assert (bs.bone_splat.launches, bs.bone_splat.plain_runs) == (
        before[0], before[1] + runs)

    worst = dict.fromkeys(FORWARD_TOL, 0.0)
    for r, o in zip(ref["stages"], out["stages"]):
        assert sorted(o) == sorted(r)
        for key, r_val in r.items():
            kind = ("xyz" if "xyz" in key else "uv" if "uv" in key
                    else "other")
            worst[kind] = max(worst[kind], max_err(o[key].detach(), r_val))
    for key in ("seg", "dense"):
        worst["head"] = max(worst["head"],
                            max_err(out[key].detach(), ref[key]))
    stats = model.state_dict()
    assert len(want_stats) > 100
    for k, w in want_stats.items():
        worst["stats"] = max(worst["stats"], float(
            (stats[k] - w).abs().max() / w.abs().max()))
    for kind, err in worst.items():
        assert err <= FORWARD_TOL[kind], (kind, err)
