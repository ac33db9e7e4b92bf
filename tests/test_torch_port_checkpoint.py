"""The port's train step on its own: ``unroll``, its exclusion with
``grad_accum``, and checkpoints (dir_tpu_torch/train/checkpoint.py).

No JAX: a seeded port model (``serve.random_init_``) with the tiny
``(1, 1, 1, 1)`` backbone at 64x64, batch 2, fp32 on the CPU. One
uninterrupted two-step run, checkpointed after its first step, is the
reference: a resume from that checkpoint must land on it bit for bit, and
so must ``unroll``'s stacked steps.
"""

import os
import sys

import numpy as np
import pytest
import torch

from dir_tpu_torch.config import ModelConfig, TrainConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.models.losses import total_loss
from dir_tpu_torch.serve import random_init_
from dir_tpu_torch.train import checkpoint as ck
from dir_tpu_torch.train import state as tstate
from dir_tpu_torch.train import steps as tsteps
from dir_tpu_torch.weights import dir_mapping

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads  # noqa: E402
from torch_port_train_helpers import (LAYERS, make_batch,  # noqa: E402
                                      port_manos)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _model(seed=0) -> DIR:
    return random_init_(DIR(ModelConfig(backbone_layers=LAYERS)), seed)


def _step(model, **kw):
    tl, tr = port_manos()
    opt = tstate.make_optimizer(model, TrainConfig(), 1)
    return opt, tsteps.make_train_step(model, opt, model.cfg, tl, tr,
                                       device="cpu", **kw)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Two batches and the uninterrupted two-step run: ``latest`` and
    ``best`` checkpoints and meta.json written after step 1; the weights
    after step 1, the state and the last loss after step 2."""
    rng = np.random.RandomState(5)
    batches = [make_batch(rng) for _ in range(2)]
    ckpt_dir = str(tmp_path_factory.mktemp("ckpt"))
    model = _model()
    opt, step = _step(model)
    state, _ = step(tstate.create_train_state(model, opt), batches[0])
    ck.save_checkpoint(ckpt_dir, state)
    ck.save_checkpoint(ckpt_dir, state, name="best")
    ck.save_meta(ckpt_dir, {"epoch": 1, "best": 12.5})
    first = {k: v.clone() for k, v in ck.model_state_dict(model).items()}
    state, loss_dict = step(state, batches[1])
    return batches, ckpt_dir, first, state, float(total_loss(loss_dict))


def test_unroll_runs_consecutive_steps(reference):
    """unroll=2 on the stacked batches equals two calls of the plain step,
    bit for bit, and returns the last step's losses."""
    batches, _, _, ref, ref_loss = reference
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    model = _model()
    opt, step = _step(model, unroll=2)
    state, loss_dict = step(tstate.create_train_state(model, opt), stacked)
    assert state.step == 2
    assert float(total_loss(loss_dict)) == ref_loss
    want = ref.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_unroll_and_grad_accum_exclude_each_other():
    model = DIR(ModelConfig(backbone_layers=LAYERS))
    with pytest.raises(ValueError, match="mutually exclusive"):
        _step(model, unroll=2, grad_accum=2)


def test_checkpoint_round_trip_and_resume(reference):
    """Restore the step-1 checkpoint into a model of other weights and take
    the second step: bit for bit the uninterrupted run. ``latest`` and
    ``best`` are separate files; meta.json keeps the JAX package's keys;
    the model part is in the weight bridge's layout."""
    batches, ckpt_dir, first, full, _ = reference
    assert sorted(os.listdir(ckpt_dir)) == ["best.pt", "latest.pt",
                                            "meta.json"]
    assert ck.load_meta(ckpt_dir) == {"epoch": 1, "best": 12.5}
    assert ck.load_meta(os.path.join(ckpt_dir, "none")) == {}
    weights = ck.load_checkpoint_weights(ckpt_dir, "best")


    assert set(weights) <= {e.torch_key for e in dir_mapping(LAYERS)}
    assert sorted(weights) == sorted(first)
    assert all(torch.equal(weights[k], v) for k, v in first.items())

    model = _model(seed=1)              # other weights, overwritten
    opt, step = _step(model)
    state = ck.restore_checkpoint(ckpt_dir,
                                  tstate.create_train_state(model, opt))
    assert state.step == 1
    for k, v in first.items():
        assert torch.equal(model.state_dict()[k], v), k
    state, _ = step(state, batches[1])
    assert state.step == 2
    for k, v in ck.model_state_dict(full.model).items():
        assert torch.equal(model.state_dict()[k], v), k


def test_eval_step_is_the_eval_forward(reference):
    """make_eval_step runs the eval-mode forward of a train state's model
    (or of the model itself) without recording gradients."""
    batches, _, _, full, _ = reference
    tl, tr = port_manos()
    eval_step = tsteps.make_eval_step(full.model, tl, tr, device="cpu")
    img = batches[0]["img"]
    out = eval_step(full, img)
    assert not full.model.training
    with torch.inference_mode():
        want = full.model(torch.from_numpy(img), tl, tr)
    for so, sw in zip(out["stages"], want["stages"]):
        for k in sw:
            assert torch.equal(so[k], sw[k]), k
    assert torch.equal(eval_step(full.model, img)["seg"], want["seg"])
