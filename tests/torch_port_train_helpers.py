"""Shared set-up of the port's train-step parity tests
(tests/test_torch_port_train*.py, tests/test_torch_port_trajectory.py): a
seeded JAX DIR with the tiny ``(1, 1, 1, 1)`` backbone at 64x64, batch 2,
its random params and BN stats carried into the port by ``weights.py``,
synthetic batches, and both packages' train steps."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.config import TrainConfig as JTrainConfig
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.models.losses import total_loss as jtotal_loss
from dir_tpu.train import state as jstate
from dir_tpu.train import steps as jsteps

from dir_tpu_torch.config import ModelConfig, TrainConfig
from dir_tpu_torch.mano.assets import ManoModel
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.models.losses import total_loss
from dir_tpu_torch.serve import flagship_mano
from dir_tpu_torch.train import state as tstate
from dir_tpu_torch.train import steps as tsteps
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree, rand_variables, x64  # noqa: E402

LAYERS = (1, 1, 1, 1)
B, S = 2, 64


def make_batch(rng, b=B, s=S) -> dict:
    """A synthetic float training batch (numpy, fp32; seg int32)."""
    return {
        "img": rng.randn(b, s, s, 3).astype(np.float32),
        "joint_2d_left": rng.uniform(-1, 1, (b, 21, 3)).astype(np.float32),
        "joint_2d_right": rng.uniform(-1, 1, (b, 21, 3)).astype(np.float32),
        "mesh_2d_left": rng.uniform(-1, 1, (b, 778, 3)).astype(np.float32),
        "mesh_2d_right": rng.uniform(-1, 1, (b, 778, 3)).astype(np.float32),
        "joint_3d_left": (rng.randn(b, 21, 3) * 0.05).astype(np.float32),
        "joint_3d_right": (rng.randn(b, 21, 3) * 0.05).astype(np.float32),
        "mesh_3d_left": (rng.randn(b, 778, 3) * 0.05).astype(np.float32),
        "mesh_3d_right": (rng.randn(b, 778, 3) * 0.05).astype(np.float32),
        "center_left": (rng.randn(b, 1, 3) * 0.05).astype(np.float32),
        "center_right": (rng.randn(b, 1, 3) * 0.05).astype(np.float32),
        "seg": rng.randint(0, 3, size=(b, s, s)).astype(np.int32),
        "dense": rng.rand(b, s, s, 3).astype(np.float32),
    }


def as_dtype(batch: dict, dtype) -> dict:
    return {k: v.astype(dtype) if v.dtype.kind == "f" else v
            for k, v in batch.items()}


def jax_f64(tree):
    return jax.tree.map(
        lambda x: (jnp.asarray(x, jnp.float64)
                   if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating)
                   else jnp.asarray(x)), tree)


def jax_manos():
    mano_r = jsynthetic("right", seed=0)
    return jfix(jsynthetic("left", seed=0), mano_r), mano_r


def jax_variables(jmodel, img) -> dict:
    """Seeded random params and BN stats of ``jmodel`` (the init's shapes
    only; the init itself never runs)."""
    ml, mr = jax_manos()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(img, jnp.float32), ml, mr)
    return rand_variables(np.random.RandomState(0), shapes)


def port_manos(dtype=torch.float32):
    return tuple(ManoModel(*(t.to(dtype) if t.is_floating_point() else t
                             for t in m))
                 for m in flagship_mano("/nonexistent"))


def port_model(variables, dtype="float32", **cfg) -> DIR:
    """The port's DIR on ``variables``, in ``dtype`` end to end."""
    model = DIR(ModelConfig(backbone_layers=LAYERS, dtype=dtype, **cfg))
    model.to(getattr(torch, dtype)).load_state_dict(jax_to_state_dict(
        numpy_tree(variables["params"]),
        numpy_tree(variables["batch_stats"]), LAYERS), strict=True)
    return model


def assert_state_close(model, params, stats, lr, param_tol, stats_tol):
    """The port's parameters within ``param_tol * lr`` of the JAX package's,
    element by element (an AdamW step moves an element by at most about
    lr), and its BN running statistics within ``stats_tol`` of each
    tensor's max |value|."""
    want = jax_to_state_dict(numpy_tree(params), numpy_tree(stats), LAYERS)
    got = model.state_dict()
    named = dict(model.named_parameters())
    worst = {"params": (0.0, None), "stats": (0.0, None)}
    for k, w in want.items():
        d = float((got[k].double() - w.double()).abs().max())
        if k in named:
            worst["params"] = max(worst["params"], (d / lr, k),
                                  key=lambda t: t[0])
        else:
            worst["stats"] = max(worst["stats"],
                                 (d / float(w.abs().max()), k),
                                 key=lambda t: t[0])
    assert worst["params"][0] <= param_tol, worst
    assert worst["stats"][0] <= stats_tol, worst


def unit_edge_scores(tree):
    """``tree`` with every graph conv's edge scores (``e0``, ``e1``) at 1,
    their initial value in the reference and in both packages."""
    if not isinstance(tree, dict):
        return tree
    return {k: (jnp.ones_like(v) if k in ("e0", "e1")
                else unit_edge_scores(v)) for k, v in tree.items()}


def fp64_setup():
    """The JAX model, fp64 variables and MANO pair, and two fp64 batches.

    The graph convs' edge scores are at their initial value, 1. Both
    packages compute the edge softmax in fp32 by design, and XLA's and
    PyTorch's fp32 ``exp`` differ in the last bit; with equal scores in a
    row the softmax is exact in both (exp(0) = 1, the masked entries 0, one
    correctly rounded division), so the rest of the forward is fp64 on both
    sides. :func:`test_gradients_match_jax_fp64` also runs random scores."""
    rng = np.random.RandomState(1)
    batches = [as_dtype(make_batch(rng), np.float64) for _ in range(2)]
    jmodel32 = JDIR(JModelConfig(backbone_layers=LAYERS))
    variables = jax_variables(jmodel32, batches[0]["img"])
    with x64():
        jmodel = JDIR(JModelConfig(backbone_layers=LAYERS, dtype="float64"))
        jvars = jax_f64(variables)
        jvars = {"params": unit_edge_scores(jvars["params"]),
                 "batch_stats": jvars["batch_stats"],
                 "random_edge_params": jvars["params"]}
        ml, mr = (jax_f64(m) for m in jax_manos())
    return jmodel, jvars, (ml, mr), batches


def jax_train(jvars, batches, jmodel, manos, steps_per_epoch, **kw):
    """The JAX package's jitted train step over ``batches``: the states and
    the total loss of every step."""
    ml, mr = manos
    jcfg = JModelConfig(backbone_layers=LAYERS, dtype="float64")
    tx = jstate.make_optimizer(JTrainConfig(), steps_per_epoch)
    st = jstate.create_train_state(
        {"params": jvars["params"], "batch_stats": jvars["batch_stats"]}, tx)
    step = jsteps.make_train_step(jmodel, tx, jcfg, ml, mr, donate=False,
                                  **kw)
    states, losses = [], []
    for batch in batches:
        st, loss_dict = step(st, jax_f64({k: jnp.asarray(v)
                                          for k, v in batch.items()}))
        states.append(jax.device_get(st))
        losses.append(float(jtotal_loss(loss_dict)))
    return states, losses


def port_train(model, batches, steps_per_epoch=1, **kw):
    """The port's train step on the CPU over ``batches``: the final state
    and the total loss of every step."""
    tl, tr = port_manos(next(model.parameters()).dtype)
    opt = tstate.make_optimizer(model, TrainConfig(), steps_per_epoch)
    state = tstate.create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, model.cfg, tl, tr,
                                  device="cpu", **kw)
    losses = []
    for batch in batches:
        state, loss_dict = step(state, batch)
        losses.append(float(total_loss(loss_dict)))
    return state, losses
