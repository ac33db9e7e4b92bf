"""The port's train step against dir_tpu's over two optimizer steps, and
the optimizer-state bridge.

On the shared set-up of ``torch_port_train_helpers`` at fp64 end to end: a
2-step AdamW trajectory against the JAX package's own jitted train step,
one epoch a step, so that the cosine schedule changes the lr between the
steps; the JAX state after step 1 carried into the port by
``weights.jax_opt_state_to_torch`` continues where JAX's does.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from dir_tpu_torch.config import TrainConfig
from dir_tpu_torch.models.losses import total_loss
from dir_tpu_torch.train import state as tstate
from dir_tpu_torch.train import steps as tsteps
from dir_tpu_torch.weights import jax_opt_state_to_torch

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads, x64  # noqa: E402
from torch_port_train_helpers import (assert_state_close,  # noqa: E402
                                      jax_train, port_manos, port_model)
from torch_port_train_helpers import fp64_setup as _fp64_setup  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def fp64_setup():
    return _fp64_setup()


@pytest.fixture(scope="module")
def jax_trajectory(fp64_setup):
    """Two steps of the JAX train step, one epoch a step (the cosine lr
    changes between them)."""
    jmodel, jvars, manos, batches = fp64_setup
    with x64():
        return jax_train(jvars, batches, jmodel, manos, steps_per_epoch=1)


# Measured at fp64. Step 1, from edge scores at 1: the loss to 1.8e-16
# relative; parameters to 5.1e-8 lr of JAX's (the edge scores, whose
# gradient is fp32-limited; the others closer), BN statistics to 7.7e-15 of
# their max. Step 2 runs from edge scores that no longer agree within a row,
# so the fp32 edge softmax rounds differently in the two packages: the loss
# to 1.7e-8 relative, parameters to 3.6e-3 lr (Adam's normalized update
# magnifies the gradients' last-bit differences where they are near 0), BN
# statistics to 7.4e-8. A semantic difference (weight decay, bias
# correction, the lr schedule) moves every element by about 1e-3 lr or more
# already in step 1. Bounds: about ten times each measurement.
STEP_TOL = [(1e-12, 1e-6, 1e-13), (2e-7, 3e-2, 1e-6)]   # loss, params, BN


def test_two_step_trajectory_matches_jax(fp64_setup, jax_trajectory):
    _, jvars, _, batches = fp64_setup
    states, jlosses = jax_trajectory
    model = port_model(jvars, "float64")
    tl, tr = port_manos(torch.float64)
    opt = tstate.make_optimizer(model, TrainConfig(), 1)
    assert opt.lr_schedule(0) == 5e-4 and opt.lr_schedule(1) < 5e-4
    state = tstate.create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, model.cfg, tl, tr,
                                  device="cpu")
    for i, batch in enumerate(batches):
        state, loss_dict = step(state, batch)
        assert state.step == i + 1
        assert all(v.dtype == torch.float64 and not v.requires_grad
                   for v in loss_dict.values())
        loss_tol, param_tol, stats_tol = STEP_TOL[i]
        np.testing.assert_allclose(float(total_loss(loss_dict)), jlosses[i],
                                   rtol=loss_tol)
        assert opt.param_groups[0]["lr"] == opt.lr_schedule(i)
        assert_state_close(model, states[i].params, states[i].batch_stats,
                           opt.lr_schedule(i), param_tol, stats_tol)


def test_optimizer_state_bridge_continues_a_jax_state(fp64_setup,
                                                      jax_trajectory):
    """JAX's state after step 1 (params, BN stats, AdamW moments) carried
    into the port; the port's step 2 lands where JAX's did."""
    _, _, _, batches = fp64_setup
    states, jlosses = jax_trajectory
    first = states[0]
    model = port_model({"params": first.params,
                        "batch_stats": first.batch_stats}, "float64")


    tl, tr = port_manos(torch.float64)
    opt = tstate.make_optimizer(model, TrainConfig(), 1)
    opt_state = jax.tree.map(np.asarray, first.opt_state)
    count = jax_opt_state_to_torch(opt_state, model, opt)
    assert count == int(first.step) == 1
    assert len(opt.state) == len(list(model.parameters()))
    # the same state as nested dicts, as a checkpoint without a template
    # restores it, carries across the same
    as_dicts = {str(i): (part._asdict() if hasattr(part, "_asdict") else {})
                for i, part in enumerate(opt_state)}
    other = tstate.make_optimizer(model, TrainConfig(), 1)
    assert jax_opt_state_to_torch(as_dicts, model, other) == count
    for p in model.parameters():
        for k, v in opt.state[p].items():
            assert torch.equal(other.state[p][k], v), k
    state = tstate.TrainState(step=count, model=model, optimizer=opt)
    step = tsteps.make_train_step(model, opt, model.cfg, tl, tr,
                                  device="cpu")
    state, loss_dict = step(state, batches[1])
    # step 2's bounds (STEP_TOL); measured as the trajectory's step 2
    loss_tol, param_tol, stats_tol = STEP_TOL[1]
    np.testing.assert_allclose(float(total_loss(loss_dict)), jlosses[1],
                               rtol=loss_tol)
    assert_state_close(model, states[1].params, states[1].batch_stats,
                       opt.lr_schedule(1), param_tol, stats_tol)
    with pytest.raises(ValueError):
        jax_opt_state_to_torch({"nothing": 1}, model, opt)
