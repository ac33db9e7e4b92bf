"""The port's train step (dir_tpu_torch/train/) against dir_tpu's: the
gradients, the schedules, ``decode_wire8``, ``opt_steps_per_epoch`` and the
entry point's device rule.

On the shared set-up of ``torch_port_train_helpers`` (tiny backbone at
64x64, batch 2), at fp64 end to end (JAX with x64 for the test alone, the
port's model in fp64, MANO in fp64 on both sides): per-parameter gradients of
``total_loss(dir_losses(..., fused_stages=True))`` against
``jax.value_and_grad``.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.config import TrainConfig as JTrainConfig
from dir_tpu.models.losses import dir_losses as jdir_losses
from dir_tpu.models.losses import total_loss as jtotal_loss
from dir_tpu.train import state as jstate
from dir_tpu.train import steps as jsteps
from dir_tpu.train.trainer import opt_steps_per_epoch as jsteps_per_epoch

from dir_tpu_torch.config import ModelConfig, TrainConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.models.losses import dir_losses, total_loss
from dir_tpu_torch.train import state as tstate
from dir_tpu_torch.train import steps as tsteps
from dir_tpu_torch.train.trainer import opt_steps_per_epoch
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (numpy_tree, torch_threads,  # noqa: E402
                                x64)
from torch_port_train_helpers import (LAYERS, as_dtype,  # noqa: E402
                                      jax_f64, make_batch, port_manos,
                                      port_model)
from torch_port_train_helpers import fp64_setup as _fp64_setup  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def fp64_setup():
    return _fp64_setup()


# Measured at fp64 on this input. Edge scores at 1: the total loss to
# 1.8e-16 relative; gradients to 6.0e-13 of each tensor's max |value|, the
# edge scores' own to 6.1e-8 (their softmax backward runs in fp32 in both
# packages). Random edge scores: the fp32 edge softmax rounds differently in
# the two packages (the last bit of exp), which moves the refine stages'
# outputs by about 1e-9 and the loss by 8.7e-10 relative; gradients then
# agree to 6.9e-8 of the max, the edge scores' own to 3.1e-7. Tensors whose
# gradient is zero in exact arithmetic (conv biases feeding a train-mode BN)
# are left out when both sides are below 1e-12. Bounds (loss, gradients,
# edge-score gradients): about ten times each measurement.
GRAD_TOL = {"init": (1e-12, 1e-10, 1e-6), "random": (1e-8, 1e-6, 3e-6)}


@pytest.fixture(scope="module")
def jax_gradients(fp64_setup):
    """{edges: (loss, gradients in the port's layout)} of the JAX package on
    the first batch, for unit and for random edge scores (one compile)."""
    jmodel, jvars, (ml, mr), batches = fp64_setup
    jcfg = JModelConfig(backbone_layers=LAYERS, dtype="float64")
    with x64():
        jb = jax_f64({k: jnp.asarray(v) for k, v in batches[0].items()})

        def loss_fn(p):
            out, _ = jmodel.apply(
                {"params": p, "batch_stats": jvars["batch_stats"]},
                jb["img"], ml, mr, train=True, mutable=["batch_stats"])
            return jtotal_loss(jdir_losses(out, jb, jcfg, ml.faces, mr.faces,
                                           fused_stages=True))

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
        out = {}
        for edges, key in (("init", "params"),
                           ("random", "random_edge_params")):
            loss, grads = grad_fn(jvars[key])
            out[edges] = (float(loss), jax_to_state_dict(numpy_tree(grads),
                                                         {}, LAYERS))
    return out


@pytest.mark.parametrize("edges", ["init", "random"])
def test_gradients_match_jax_fp64(fp64_setup, jax_gradients, edges):
    _, jvars, _, batches = fp64_setup
    batch = batches[0]
    variables = {"params": jvars["params" if edges == "init"
                                 else "random_edge_params"],
                 "batch_stats": jvars["batch_stats"]}
    jloss, want = jax_gradients[edges]

    model = port_model(variables, "float64").train()
    tl, tr = port_manos(torch.float64)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["img"], tl, tr)
    loss = total_loss(dir_losses(out, tb, model.cfg, tl.faces, tr.faces,
                                 fused_stages=True))
    loss.backward()
    loss_tol, grad_tol, edge_tol = GRAD_TOL[edges]
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=loss_tol)
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(want)
    worst = {True: (0.0, None), False: (0.0, None)}
    compared = 0
    for k, w in want.items():
        g = named[k].grad
        assert g is not None, k
        w = w.double()
        scale = float(w.abs().max())
        if scale < 1e-12 and float(g.abs().max()) < 1e-12:
            continue
        compared += 1
        edge = k.endswith((".e_0", ".e_1"))
        worst[edge] = max(worst[edge],
                          (float((g - w).abs().max()) / scale, k),
                          key=lambda t: t[0])
    assert compared > 0.8 * len(want)
    assert worst[False][0] <= grad_tol, worst[False]
    assert worst[True][0] <= edge_tol, worst[True]


@pytest.mark.parametrize("scheduler", ["cosine", "step"])
def test_lr_schedule_matches_jax(scheduler):
    """At every epoch boundary and the step before it, 3 steps an epoch."""
    kw = dict(lr_scheduler=scheduler, total_epochs=6, step_milestones=(2, 4))
    sched = tstate.lr_schedule(TrainConfig(**kw), 3)
    steps = [s for e in range(8) for s in (3 * e - 1, 3 * e) if s >= 0]
    with x64():
        jsched = jstate.lr_schedule(JTrainConfig(**kw), 3)
        want = [float(jsched(jnp.asarray(s))) for s in steps]
    got = [sched(s) for s in steps]
    # measured: equal at fp64 (the same operations in the same order)
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] == 5e-4 and len(set(got)) > 2
    with pytest.raises(ValueError):
        tstate.lr_schedule(TrainConfig(lr_scheduler="nope"), 3)


def test_decode_wire8_matches_jax_exactly():
    rng = np.random.RandomState(4)
    wire = {"img": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
            "dense": rng.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8),
            "seg": rng.randint(0, 3, (2, 8, 8)).astype(np.uint8),
            "center_left": rng.randn(2, 1, 3).astype(np.float32)}
    got = tsteps.decode_wire8({k: torch.from_numpy(v)
                               for k, v in wire.items()})
    want = jax.device_get(jsteps.decode_wire8(
        {k: jnp.asarray(v) for k, v in wire.items()}))
    assert got["img"].dtype == got["dense"].dtype == torch.float32
    assert got["seg"].dtype == torch.int64
    for k in wire:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # a float batch passes unchanged
    floats = {k: torch.from_numpy(v) for k, v in
              as_dtype(make_batch(rng, 1, 8), np.float32).items()}
    same = tsteps.decode_wire8(floats)
    assert all(same[k] is floats[k] for k in floats)


@pytest.mark.parametrize("n,b,accum", [(1000, 64, 1), (1000, 64, 4),
                                       (10, 64, 1), (128, 64, 3)])


def test_opt_steps_per_epoch_matches_jax(n, b, accum):
    assert opt_steps_per_epoch(n, b, accum) == jsteps_per_epoch(n, b, accum)


def test_make_train_step_refuses_a_cpu_only_box():
    """Without a card and without device="cpu", the step is not built."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    model = DIR(ModelConfig(backbone_layers=LAYERS))
    tl, tr = port_manos()
    opt = tstate.make_optimizer(model, TrainConfig(), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_train_step(model, opt, model.cfg, tl, tr)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsteps.make_eval_step(model, tl, tr)
