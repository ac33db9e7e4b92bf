"""Profiling and timing harness (counterpart of
``dir_tpu/utils/profiling.py``): a ``torch.profiler`` trace, and a timer
that waits for the device, by CUDA events on the card."""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where a card is
    present, CUDA activity; the Chrome trace is written into ``log_dir``
    (view it with TensorBoard's profiler plugin or Perfetto). Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def _on_cuda(out) -> bool:
    leaves = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else (out,))
    return any(_on_cuda(t) if isinstance(t, (dict, list, tuple))
               else isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 3) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` calls. Where the
    output lies on the card the time is taken by CUDA events around the
    calls on the current stream; else on the host clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if out is not None and _on_cuda(out):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def throughput(fn: Callable, *args, batch: int, iters: int = 10,
               warmup: int = 3) -> float:
    """Items per second of ``fn`` over a fixed batch."""
    return batch / time_fn(fn, *args, iters=iters, warmup=warmup)
