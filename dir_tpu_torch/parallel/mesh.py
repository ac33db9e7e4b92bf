"""Data-parallel mesh on ``torch.distributed`` (counterpart of
``dir_tpu/parallel/mesh.py``).

``dir_tpu`` shards a global batch over a 1-D ``data`` mesh and replicates
the state; XLA then computes exactly what one device computes on the whole
batch. Here each rank is one process on one device: every rank receives the
same global batch, :func:`shard_batch` takes its contiguous block (the block
``P("data")`` gives device *r*), :func:`replicate` starts every rank from
rank 0's parameters, and the few collectives below carry what the
one-device computation reduces over the batch: BatchNorm's moments
(``parallel/batch_norm.py``), the segmentation losses' sums, the int8
activation maxima, the gradients and the metric accumulators.

A world of 1, with or without a process group, makes every helper the
identity, so a program with a mesh of one rank computes what it computes
without one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from dir_tpu_torch.device import resolve_device

# torchrun's environment, which a process started by it (or by the apps'
# own launcher) carries.
_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def launched() -> bool:
    """Whether this process is one rank of a launched group (torchrun's
    environment is set)."""
    return all(k in os.environ for k in _ENV_KEYS)


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None,
                     timeout: Optional[float] = None) -> None:
    """Join the process group of a data-parallel run.

    With no coordinator it reads torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), as
    ``jax.distributed.initialize`` detects its cluster; else
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` name it.

    ``device``: the ranks' device type, CUDA unless the caller names
    another. ``backend`` defaults to ``nccl`` for CUDA ranks and ``gloo``
    for CPU ranks and is never switched behind the caller's back: NCCL
    without a card, NCCL for CPU ranks, or more NCCL ranks on this host
    than it has cards (NCCL refuses two ranks on one card) raise. gloo
    carries CUDA tensors too (through the host), and only when it is named
    may ranks share a card. ``timeout``: seconds a collective may wait.
    """
    if coordinator_address is None:
        missing = [k for k in _ENV_KEYS if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_distributed: no coordinator given and {missing} not "
                "in the environment; start the ranks with torchrun or the "
                "apps' --devices, or pass coordinator_address, "
                "num_processes and process_id")
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init_method = f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
        local_world = world
    dev_type = torch.device("cuda" if device is None else device).type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if backend == "nccl":
        if dev_type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors only; {dev_type} "
                             "ranks need backend='gloo'")
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card and none is "
                               "available")
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise RuntimeError(
                f"{local_world} NCCL ranks on this host and {cards} CUDA "
                "card(s): NCCL refuses two ranks on one card; start at most "
                "one rank a card, or name backend='gloo' to share cards")
        torch.cuda.set_device(_local_rank())
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data mesh: its ``rank`` among ``world``,
    its ``device``, and the process group (None in a world of 1 made
    without one)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def parallel(self) -> bool:
        """Whether collectives run (a world of more than one rank)."""
        return self.world > 1

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of ``t`` over the ranks (a new tensor)."""
        if not self.parallel:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (a new tensor)."""
        if not self.parallel:
            return t
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def sum_differentiable(self, t: torch.Tensor) -> torch.Tensor:
        """:meth:`sum` that autograd sees: its backward sums the incoming
        gradients over the ranks, so each rank's inputs receive the
        gradient of the sum of every rank's objective."""
        if not self.parallel:
            return t
        return _SumOverRanks.apply(t, self)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) stacked along dim 0
        in rank order. Made as the sum of a zero buffer holding this rank's
        rows, which is exact and needs only an all-reduce, which every
        backend carries for CUDA and CPU tensors."""
        if not self.parallel:
            return t
        n = t.shape[0]
        buf = t.new_zeros((self.world * n,) + tuple(t.shape[1:]))
        buf[self.rank * n:(self.rank + 1) * n] = t
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf

    def mean_dict(self, values: dict) -> dict:
        """A dict of 0-d tensors averaged over the ranks, in one
        all-reduce."""
        if not self.parallel:
            return values
        stacked = self.sum(torch.stack(list(values.values()))) / self.world
        return dict(zip(values, stacked.unbind()))

    def broadcast_(self, t: torch.Tensor) -> None:
        """Overwrite ``t`` in place with rank 0's."""
        if self.parallel:
            dist.broadcast(t, src=0, group=self.group)

    def barrier(self) -> None:
        if self.parallel:
            dist.barrier(group=self.group)


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks; the gradient of a sum over the ranks of
    every rank's objective is again the sum over the ranks."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.sum(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.sum(grad), None


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The data mesh of this process.

    Inside a process group (:func:`init_distributed`) it spans the group:
    ``n_devices`` 0 or None takes it whole, another value must equal its
    size. The rank's device is ``cuda:LOCAL_RANK`` (ranks sharing cards
    under gloo take them in turn) unless ``device`` names a type or a
    device. Without a group it is a world of 1 on ``device`` (CUDA unless
    named; no card and none named raises); more devices then need more
    processes, and asking for them raises."""
    if not dist.is_initialized():
        if n_devices not in (None, 0, 1):
            raise RuntimeError(
                f"a mesh of {n_devices} devices needs {n_devices} processes:"
                " start them with the apps' --devices or torchrun, and call "
                "init_distributed in each")
        return Mesh(rank=0, world=1, device=resolve_device(device))
    world = dist.get_world_size()
    if n_devices not in (None, 0) and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}) in a group of {world} "
                         "ranks")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = resolve_device(torch.device(
            "cuda", _local_rank() % max(torch.cuda.device_count(), 1)))
    return Mesh(rank=dist.get_rank(), world=world, device=dev,
                group=dist.group.WORLD)


def shard_batch(batch, mesh: Mesh, leading_steps: bool = False):
    """This rank's contiguous block of the global ``batch`` (a dict of
    arrays or tensors, or one of them), on the mesh's device: the rows
    ``[r * B / world, (r + 1) * B / world)`` of the batch axis, the first
    or, with ``leading_steps`` (stacked steps or micro-batches), the
    second. Rank order is batch order. A batch that does not divide by the
    world raises."""
    axis = 1 if leading_steps else 0

    def block(x):
        x = torch.as_tensor(x)
        n = x.shape[axis]
        if n % mesh.world:
            raise ValueError(f"a batch of {n} does not divide over "
                             f"{mesh.world} ranks")
        per = n // mesh.world
        x = x.narrow(axis, mesh.rank * per, per)
        return x.to(mesh.device, non_blocking=True)

    if isinstance(batch, dict):
        return {k: block(v) for k, v in batch.items()}
    return block(batch)


def replicate(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Start every rank from rank 0's parameters and buffers (the
    counterpart of ``replicated_sharding``), and hand ``mesh`` to each
    submodule that reduces over the batch (a class attribute ``mesh``
    marks them: the port's BatchNorms and int8 activation maxima)."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            mesh.broadcast_(t)
    for m in module.modules():
        if hasattr(type(m), "mesh"):
            m.mesh = mesh


def average_gradients(params, mesh: Optional[Mesh]) -> None:
    """Replace each parameter's gradient by its mean over the ranks, in one
    all-reduce per dtype. A parameter that has no gradient on a rank (it
    took no part in the step) must have none on every rank, and keeps
    none, as the one-device step leaves it; ranks that disagree raise."""
    if mesh is None or not mesh.parallel:
        return
    params = list(params)
    buckets = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault(p.grad.dtype, []).append(p)
    has = torch.tensor([p.grad is not None for p in params],
                       dtype=torch.float32, device=mesh.device)
    counts = mesh.sum(has)
    if not bool(((counts == 0) | (counts == mesh.world)).all()):
        raise RuntimeError("the ranks disagree on which parameters took part "
                           "in the step")
    for ps in buckets.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        flat = mesh.sum(flat).div_(mesh.world)
        offset = 0
        for p in ps:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n

