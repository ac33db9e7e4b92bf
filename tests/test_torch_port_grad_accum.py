"""The port's gradient accumulation (``make_train_step(grad_accum=2)``)
against its own manual accumulation and against dir_tpu's accumulating
train step.

On the shared set-up of ``torch_port_train_helpers`` (tiny backbone at
64x64, batch 2 a micro-batch): bit for bit against the port's plain
backward, summed and halved, at fp32; against the JAX package's
``make_train_step(grad_accum=2)`` at fp64.
"""

import os
import sys

import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models.dir import DIR as JDIR

from dir_tpu_torch.config import TrainConfig
from dir_tpu_torch.models.losses import dir_losses, total_loss
from dir_tpu_torch.train import state as tstate

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads, x64  # noqa: E402
from torch_port_train_helpers import (LAYERS, assert_state_close,  # noqa: E402
                                      fp64_setup, jax_train, jax_variables,
                                      make_batch, port_manos, port_model,
                                      port_train)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def fp32_variables():
    batch = make_batch(np.random.RandomState(2))
    return jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS)),
                         batch["img"])


def test_grad_accum_is_manual_accumulation(fp32_variables):
    """grad_accum=2 on two stacked micro-batches: the gradients the port's
    plain backward leaves for each micro-batch (BN statistics chained),
    summed and halved, then one AdamW step; bit for bit, with the loss dict
    the micro-batches' mean."""
    variables = fp32_variables
    rng = np.random.RandomState(3)
    micro = [make_batch(rng) for _ in range(2)]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    state, losses = port_train(port_model(variables), [stacked],
                                     grad_accum=2)
    assert state.step == 1

    model = port_model(variables).train()
    tl, tr = port_manos()
    opt = tstate.make_optimizer(model, TrainConfig(), 1)
    opt.zero_grad(set_to_none=True)
    totals = []
    for m in micro:
        t = {k: torch.from_numpy(v) for k, v in m.items()}
        loss = total_loss(dir_losses(model(t["img"], tl, tr), t, model.cfg,
                                     tl.faces, tr.faces, fused_stages=True))
        loss.backward()
        totals.append(float(loss.detach()))
    for p in model.parameters():
        p.grad.div_(2)
    opt.step()
    got = state.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k
    np.testing.assert_allclose(losses[0], np.mean(totals), rtol=1e-6)


# Measured at fp64 with the edge scores at 1 (see fp64_setup): parameters to
# 4.8e-8 lr (the edge scores, whose gradient is fp32-limited), BN statistics
# to 6.2e-15 of their max; bounds as the trajectory's first step (STEP_TOL[0]
# of test_torch_port_trajectory.py).
def test_grad_accum_matches_jax():
    jmodel, jvars, manos, batches = fp64_setup()
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    with x64():
        states, jlosses = jax_train(jvars, [stacked], jmodel, manos,
                                    steps_per_epoch=1, grad_accum=2)
    state, losses = port_train(port_model(jvars, "float64"), [stacked],
                                  grad_accum=2)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-12)
    assert_state_close(state.model, states[0].params, states[0].batch_stats,
                       5e-4, 1e-6, 1e-13)
