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

On one CUDA device with no collectives and one batch a call, the step runs
as one CUDA graph (``torch.cuda.CUDAGraph``) once its batch signature has
repeated: the graph is a recording of the same chain of kernels, replayed
with one launch where the host would otherwise launch each kernel.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple

import torch

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.device import (deterministic, float_constant, no_tf32,
                                  resolve_device)
from dir_tpu_torch.mano.assets import ManoModel
from dir_tpu_torch.models.losses import dir_losses, total_loss
from dir_tpu_torch.ops.bone_splat import bone_splat
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


def graphable(dev: torch.device, mesh: Mesh | None, unroll: int,
              grad_accum: int) -> bool:
    """Whether :func:`make_train_step` runs its step as a CUDA graph: a
    CUDA device, no collectives (no mesh, or a mesh of one rank), and one
    optimizer step of one batch a call."""
    return (dev.type == "cuda" and (mesh is None or not mesh.parallel)
            and unroll == 1 and grad_accum == 1)


def _signature(batch: dict) -> tuple:
    """A batch's keys, shapes, dtypes and origin (host or device)."""
    return tuple((k, tuple(v.shape), v.dtype, v.device.type)
                 for k, v in batch.items())


def _capturable_(optimizer: torch.optim.Optimizer) -> None:
    """Make the optimizer's groups capturable: each group's lr a 0-d fp32
    tensor on its parameters' device, and each step counter there too,
    made by fills rather than copies from host memory."""
    for group in optimizer.param_groups:
        group["capturable"] = True
        dev = group["params"][0].device
        lr = group["lr"]
        if not (isinstance(lr, torch.Tensor) and lr.device == dev
                and lr.dtype == torch.float32 and lr.dim() == 0):
            group["lr"] = torch.full((), float(lr), dtype=torch.float32,
                                     device=dev)
        for p in group["params"]:
            st = optimizer.state.get(p, {}).get("step")
            if st is not None and st.device != p.device:
                optimizer.state[p]["step"] = torch.full(
                    (), float(st), dtype=st.dtype, device=p.device)


@contextlib.contextmanager
def _syncs_raise():
    """A host synchronisation raises (a capture records none)."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)


class _Captured(NamedTuple):
    """A captured step: its batch signature, the graph, the inputs it reads,
    the loss dict's keys and the losses it stacks, the K5 launches of a
    replay, the gradients it writes, where the caller keeps each tensor it
    reads or writes (:meth:`_GraphedStep.slots`), the parameters with
    their data pointers, and the model's parameters and buffers, which a
    replay marks as written."""
    signature: tuple
    graph: torch.cuda.CUDAGraph
    inputs: dict
    keys: tuple
    losses: torch.Tensor
    launches: int
    grads: list
    slots: list
    params: list
    pointers: list
    written: list


class _GraphedStep:
    """The one-device step as a CUDA graph (see :func:`make_train_step`).

    ``eager(state, batch)`` is the step as it runs without a graph;
    ``body(batch)`` is its chain of kernels from the decode through the
    update on a device batch, returning the detached loss dict, for the
    capture; ``set_lr(step)`` writes the schedule's lr. A replay waits for
    its own end (an event after it) before the call returns, so no work of
    a call is left on the device when it returns."""

    def __init__(self, model, optimizer, eager, body, set_lr):
        self.model, self.optimizer = model, optimizer
        self.eager, self.body, self.set_lr = eager, body, set_lr
        self.captured: _Captured | None = None
        self.done = None           # the event a replay waits on
        self.last = None           # the previous call's signature, if eager
        self.grads_stale = False   # an eager step replaced the gradients

    def slots(self) -> list:
        """Each module, parameter, buffer, lr and optimizer state of the
        step as ``(holder, key, value)``, from the model and the optimizer
        down: ``holder[key]`` is ``value`` until the caller replaces it."""
        opt = self.optimizer
        out = [(vars(opt), "state", opt.state),
               (vars(opt), "param_groups", opt.param_groups)]
        for m in self.model.modules():
            for d in (m._modules, m._parameters, m._buffers):
                out += [(d, k, v) for k, v in d.items()]
        for group in opt.param_groups:
            out += [(group, "lr", group["lr"]),
                    (group, "params", group["params"])]
            for p in group["params"]:
                st = opt.state.get(p)
                out.append((opt.state, p, st))
                out += [(st, k, v) for k, v in (st or {}).items()]
        return out

    def intact(self, c: _Captured) -> bool:
        """Whether every tensor the graph reads or writes is still where the
        caller keeps it, and each parameter on the same memory (``.data``
        and ``Module.to`` move a parameter in place); a walk of the slots
        kept at the capture, not of the model."""
        return (all(d.get(k) is v for d, k, v in c.slots)
                and [p.data_ptr() for p in c.params] == c.pointers)

    def __call__(self, state: TrainState, batch: dict):
        host = {k: torch.as_tensor(v) for k, v in batch.items()}
        sig = _signature(host)
        c = self.captured
        if c is not None and not self.intact(c):
            c = self.captured = None
        if c is not None and c.signature == sig:
            self.last = None
            with span("train.upload"):
                self.upload(c, state, host)
            return self.replay(c, state)
        if self.last == sig:
            self.last = None
            return self.capture(state, host, sig)
        self.last = sig
        self.grads_stale = c is not None
        _capturable_(self.optimizer)
        with warnings.catch_warnings():
            # the warm-up steps capturable AdamW outside a capture on purpose
            warnings.filterwarnings(
                "ignore", message="This instance was constructed with "
                "capturable=True")
            return self.eager(state, host)

    def upload(self, c: _Captured, state: TrainState, host: dict) -> None:
        for k, v in host.items():
            c.inputs[k].copy_(v, non_blocking=True)
        self.set_lr(state.step)

    def capture(self, state: TrainState, host: dict, sig: tuple):
        _capturable_(self.optimizer)   # a state loaded since the warm-up
        with span("train.upload"):
            dev = self.optimizer.param_groups[0]["params"][0].device
            inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                      for k, v in host.items()}
            for k, v in host.items():
                inputs[k].copy_(v, non_blocking=True)
            self.set_lr(state.step)
        with span("train.capture"):
            graph = torch.cuda.CUDAGraph()
            self.done = torch.cuda.Event()
            before = bone_splat.launches
            with torch.cuda.graph(graph), _syncs_raise():
                loss_dict = self.body(inputs)
                losses = torch.stack(list(loss_dict.values()))
            # the capture launched nothing; each replay launches these
            launches, bone_splat.launches = bone_splat.launches - before, \
                before
            params = list(self.model.parameters())
            self.captured = c = _Captured(
                sig, graph, inputs, tuple(loss_dict), losses, launches,
                [(p, p.grad) for p in params if p.grad is not None],
                self.slots(), params, [p.data_ptr() for p in params],
                params + list(self.model.buffers()))
        self.grads_stale = False
        return self.replay(c, state)

    def replay(self, c: _Captured, state: TrainState):
        with span("train.replay"):
            c.graph.replay()
            losses = c.losses.clone()
            self.done.record()
            # the replay wrote these where autograd does not see it: their
            # versions move, as an in-place op's would, while it runs
            torch.autograd.graph.increment_version(c.written)
            # the call returns once its replay has run on the device
            self.done.synchronize()
        bone_splat.launches += c.launches
        if self.grads_stale:
            for p, g in c.grads:
                p.grad = g
            self.grads_stale = False
        state.step += 1
        return state, dict(zip(c.keys, losses.unbind()))


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

    CUDA graph (:func:`graphable`: a CUDA device, no mesh or a mesh of one
    rank, ``unroll == grad_accum == 1``): the first call with a batch
    signature (keys, shapes, dtypes, host or device origin) runs eager and
    warms up; the next consecutive call with it captures the whole step,
    from the decode through the AdamW update, as one graph and replays it;
    each later call with it copies the batch into the graph's inputs, writes
    the lr and replays. A call with another signature runs eager; one that
    repeats replaces the graph (the step holds one). The optimizer's groups
    are made capturable first: each lr becomes a 0-d fp32 tensor on the
    device, written before each replay (``lr_schedule``, or left as it is),
    and AdamW's arithmetic is the same in the eager and the replayed steps.
    Its other hyperparameters are fixed at the capture. The graph is
    dropped, and the call runs eager, whenever a parameter, a buffer, an lr
    or a tensor of the optimizer's state was replaced, or a parameter moved
    to new memory, since the capture (``optimizer.load_state_dict``
    replaces the moments; ``model.load_state_dict`` copies in place and
    keeps the graph). The
    capture raises on a host synchronisation. A replayed call returns once
    its replay has run (it waits on an event recorded after it): its losses
    and update are done, and none of its work is left on the device. Each
    replay adds the K5 launches it runs to ``bone_splat.launches`` and
    moves the version of each parameter and buffer of the model, as an
    in-place update does. Spans:
    a replayed step records ``train.upload`` (the copy and the lr) and
    ``train.replay`` (the replay and its wait), a capturing one
    ``train.upload``, ``train.capture`` and ``train.replay``, an eager one
    its phases.
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

    def set_lr(step: int) -> None:
        """The schedule's lr at ``step`` into each group: written into a
        capturable group's lr tensor, set as a float otherwise."""
        if schedule is None:
            return
        lr = schedule(step)
        for group in optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr

    def update(state: TrainState, grad_div: int = 1) -> TrainState:
        with span("train.optimizer"):
            if grad_div > 1:
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(grad_div)
            average_gradients(model.parameters(), mesh)
            set_lr(state.step)
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

    def graph_body(batch: dict) -> dict:
        """``one_step`` on a device batch, less the host's part of the
        update (the lr, the step count): what the graph records."""
        zero_grad()
        loss, loss_dict = loss_for(batch)
        backward(loss)
        with span("train.optimizer"):
            optimizer.step()
        return global_dict(loss_dict)

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

    def eager(state: TrainState, batch: dict):
        with span("train.upload"):
            batch = _to_device(batch, dev)
        if grad_accum > 1:
            return accum_step(state, batch)
        if unroll == 1:
            return one_step(state, batch)
        for i in range(unroll):
            state, loss_dict = one_step(
                state, {k: v[i] for k, v in batch.items()})
        return state, loss_dict

    run = (_GraphedStep(model, optimizer, eager, graph_body, set_lr)
           if graphable(dev, mesh, unroll, grad_accum) else eager)

    def step(state: TrainState, batch: dict):
        with span("train.step", unit=state.step):
            model.train()
            with no_tf32(), deterministic():
                return run(state, batch)

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
