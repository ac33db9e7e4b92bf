"""Train and eval steps (counterpart of ``dir_tpu/train/steps.py``).

One optimizer step: decode the uint8 wire format, a train-mode forward
(the BatchNorms update their running statistics), the full DIR loss with
the stages fused, the backward, and the AdamW update at the epoch-quantized
lr. The trunk runs in the model's dtype on fp32 master parameters; MANO,
the heads and the losses run in fp32, so the step turns TF32 off while it
runs. It also runs under deterministic algorithms
(``device.deterministic``), so that the same step on the same state
repeats bit for bit on the card, as the JAX package's does. On the
materialized splat branch with ``use_pallas_splat`` the forward launches
kernel K5 (four times a step) and its backward runs K5's
plain version, as the JAX package's ``custom_vjp`` does; the fused
bottleneck kernels are inference-only and never run here.

Under a data mesh (``parallel/mesh.py``) the step takes this rank's block of
the global batch (:func:`~dir_tpu_torch.parallel.mesh.shard_batch`) and
computes what the one-device step computes on the whole batch, as
``dir_tpu``'s sharded step does: the BatchNorms' statistics and the
segmentation losses span the global batch, and after the backward (the
last micro-batch's under ``grad_accum``) one all-reduce averages the
gradients, so every rank takes the same AdamW step. The gradients are
all-reduced explicitly, the counterpart of the all-reduce XLA inserts, and
not through ``DistributedDataParallel``: its bucketed reduction would need
``find_unused_parameters`` for the modules B's flags leave idle, its
buffer broadcast would overwrite the global running statistics, and its
wrapper renames the ``state_dict``.
"""

from __future__ import annotations

from typing import Callable

import torch

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.device import (deterministic, float_constant, no_tf32,
                                  resolve_device)
from dir_tpu_torch.mano.assets import ManoModel
from dir_tpu_torch.models.losses import dir_losses, total_loss
from dir_tpu_torch.parallel.mesh import Mesh, average_gradients, replicate
from dir_tpu_torch.train.state import TrainState
from dir_tpu_torch.utils.profiling import span

# ImageNet normalization of the data pipeline (RGB order), as
# dir_tpu/data/augment.py has it.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode_wire8(batch: dict) -> dict:
    """Decode the lossless uint8 wire format on the batch's device.

    A uint8 BGR ``img`` becomes the normalized RGB float32 image (flip,
    /255, minus the ImageNet mean, over its std, in fp32 in that order, as
    the host pipeline's final normalize); a uint8 ``dense`` becomes
    ``dense / 255``; a uint8 ``seg`` becomes int64. Float batches pass
    unchanged, so every step takes both formats."""
    b = dict(batch)
    img = b["img"]
    if img.dtype == torch.uint8:
        rgb = img.flip(-1).to(torch.float32) / 255.0
        b["img"] = ((rgb - float_constant(IMAGENET_MEAN, img.device))
                    / float_constant(IMAGENET_STD, img.device))
    if "dense" in b and b["dense"].dtype == torch.uint8:
        b["dense"] = b["dense"].to(torch.float32) / 255.0
    if "seg" in b and b["seg"].dtype == torch.uint8:
        b["seg"] = b["seg"].to(torch.int64)
    return b


def _to_device(batch: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev, non_blocking=True)
            for k, v in batch.items()}


def make_train_step(model, optimizer: torch.optim.Optimizer,
                    cfg: ModelConfig, mano_left: ManoModel,
                    mano_right: ManoModel, *, unroll: int = 1,
                    grad_accum: int = 1, device=None,
                    mesh: Mesh | None = None) -> Callable:
    """Build the train step: ``step(state, batch) -> (state, loss_dict)``.

    ``batch``: ``{"img": (B, H, W, 3)}`` plus every target key
    :func:`~dir_tpu_torch.models.losses.dir_losses` reads, as tensors or
    numpy arrays, in the float or the uint8 wire format; it is moved to
    the step's device. ``loss_dict`` holds detached 0-d tensors.

    unroll > 1: every leaf carries a leading ``unroll`` axis of stacked
    consecutive batches; they run as that many optimizer steps and the
    last step's loss dict is returned.

    grad_accum > 1: every leaf carries a leading ``grad_accum`` axis of
    micro-batches. Each micro forward normalizes with its own batch
    statistics and chains the running statistics; the gradients are summed
    in the fp32 master parameters and divided by ``grad_accum``, then one
    optimizer step is taken; the loss dict is the micro-batches' mean.
    Mutually exclusive with ``unroll``.

    The model and the MANO pair run on ``device``: CUDA unless the caller
    names another; with no card and none named this raises. The model is
    moved there (the optimizer keeps its parameters) and put in train mode
    by each step. ``optimizer.lr_schedule`` (from
    :func:`~dir_tpu_torch.train.state.make_optimizer`) sets the lr of each
    step from ``state.step``; without it the groups' lr stays.

    ``mesh``: the data mesh; the step then runs on its device, every leaf
    of ``batch`` is this rank's block of the global batch (of the second
    axis with ``unroll`` or ``grad_accum``), the model starts from rank 0's
    parameters, and the loss dict is the global batch's.
    """
    if unroll > 1 and grad_accum > 1:
        raise ValueError("unroll and grad_accum are mutually exclusive")
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    replicate(model, mesh)
    mano_left, mano_right = mano_left.to(dev), mano_right.to(dev)
    schedule = getattr(optimizer, "lr_schedule", None)

    def zero_grad():
        with span("train.optimizer"):
            optimizer.zero_grad(set_to_none=True)

    def loss_for(batch: dict):
        with span("train.forward"):
            batch = decode_wire8(batch)
            out = model(batch["img"], mano_left, mano_right)
        with span("train.loss"):
            loss_dict = dir_losses(out, batch, cfg, mano_left.faces,
                                   mano_right.faces, fused_stages=True,
                                   mesh=mesh)
            return total_loss(loss_dict), loss_dict

    def backward(loss: torch.Tensor):
        with span("train.backward"):
            loss.backward()

    def update(state: TrainState, grad_div: int = 1) -> TrainState:
        with span("train.optimizer"):
            if grad_div > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(grad_div)
            average_gradients(model.parameters(), mesh)
            if schedule is not None:
                lr = schedule(state.step)
                for group in optimizer.param_groups:
                    group["lr"] = lr
            optimizer.step()
            state.step += 1
            return state

    def global_dict(loss_dict: dict) -> dict:
        """The detached loss dict; under a mesh, the global batch's."""
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        return loss_dict if mesh is None else mesh.mean_dict(loss_dict)

    def one_step(state: TrainState, batch: dict):
        zero_grad()
        loss, loss_dict = loss_for(batch)
        backward(loss)
        return update(state), global_dict(loss_dict)

    def accum_step(state: TrainState, batches: dict):
        zero_grad()
        sums = None
        for i in range(grad_accum):
            loss, loss_dict = loss_for({k: v[i] for k, v in batches.items()})
            backward(loss)
            loss_dict = {k: v.detach() for k, v in loss_dict.items()}
            sums = loss_dict if sums is None else {
                k: sums[k] + v for k, v in loss_dict.items()}
        return update(state, grad_accum), global_dict(
            {k: v / grad_accum for k, v in sums.items()})

    def step(state: TrainState, batch: dict):
        with span("train.step", unit=state.step):
            with span("train.upload"):
                batch = _to_device(batch, dev)
            model.train()
            with no_tf32(), deterministic():
                if grad_accum > 1:
                    return accum_step(state, batch)
                if unroll == 1:
                    return one_step(state, batch)
                for i in range(unroll):
                    state, loss_dict = one_step(
                        state, {k: v[i] for k, v in batch.items()})
                return state, loss_dict

    return step


def make_eval_step(model, mano_left: ManoModel, mano_right: ManoModel, *,
                   device=None, mesh: Mesh | None = None) -> Callable:
    """Build the inference step: ``step(state, img) -> outputs``, the
    eval-mode forward of ``state.model`` (a :class:`TrainState`, or the
    model itself) on a (B, H, W, 3) float image batch, under
    ``torch.inference_mode()`` on ``device`` (CUDA unless the caller names
    another). ``mesh``: ``img`` is this rank's block, the step runs on the
    mesh's device from rank 0's parameters, and the outputs are the
    block's."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    model.to(dev)
    replicate(model, mesh)
    mano_left, mano_right = mano_left.to(dev), mano_right.to(dev)

    def step(state, img) -> dict:
        net = getattr(state, "model", state)
        net.eval()
        with torch.inference_mode(), no_tf32():
            return net(torch.as_tensor(img).to(dev, torch.float32),
                       mano_left, mano_right)

    return step
