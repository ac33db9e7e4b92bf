"""Start the ranks of a data-parallel run from an app's ``main``.

``apps/train.py --devices N`` and ``apps/eval.py --devices N`` run as one
process that starts N ranks (``spawn``), each calling the same ``main``
with the same arguments under torchrun's environment, so that a rank and a
process started by ``torchrun`` take the same path. The parent waits for
them, stops the others when one fails, and returns rank 0's result.
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import socket
import time

import torch


def rank_count(devices: int, device=None) -> int:
    """The ranks ``--devices`` asks for: ``devices``, or with 0 one a
    local card on CUDA (one on the CPU)."""
    if devices:
        return devices
    if torch.device("cuda" if device is None else device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(module: str, argv, rank: int, world: int, port: int,
               results) -> None:
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    out = importlib.import_module(module).main(argv)
    if rank == 0:
        results.put(out)


def run_ranks(module: str, argv, world: int):
    """Run ``module.main(argv)`` in ``world`` spawned ranks on this host
    and return rank 0's result; a rank that fails stops the others and
    raises here."""
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(module, argv, rank, world, port, results))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(
                    f"rank {failed[0]} of {world} exited with code "
                    f"{procs[failed[0]].exitcode}")
            time.sleep(0.2)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank {failed[0]} of {world} exited with "
                               f"code {procs[failed[0]].exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    return results.get()
