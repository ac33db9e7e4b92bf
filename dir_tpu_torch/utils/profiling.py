"""Profiling and timing harness (counterpart of
``dir_tpu/utils/profiling.py``): a ``torch.profiler`` trace, the program's
spans, and a timer that waits for the device, by CUDA events on the card.

Spans mark where the program's host time goes: the train step's phases,
the serving call, the model's modules. ``span(name)`` records only while a
``torch.profiler`` session is active (the rule ``record_function`` itself
follows), so a benchmark's traced slice or :func:`trace` turns them on and
every other run pays one flag check a span. While on, a span opens
``record_function("dir.<name>")``, so that it lies on the profiler's clock
beside the device's kernels and copies in the Chrome trace, and appends
``(name, parent, unit, start_ns, end_ns)`` (``time.perf_counter_ns``) to a
bounded in-memory record that :func:`spans` reads and :func:`drain` reads
and clears. A root span's ``unit`` numbers its step or call; its children
inherit it. A span is inert while ``torch.export`` or a fake-tensor trace
runs, so an exported program holds no profiler ops. :func:`host_ms` sums
each span's host time from a profiler's own events.

The spans, their units, and who reads them:

- ``train.step`` (unit: ``state.step``), with the phases ``train.upload``,
  ``train.forward``, ``train.loss``, ``train.backward`` and
  ``train.optimizer`` (``zero_grad`` before the forward, the update after
  the backward): ``train/steps.py``;
- ``serve.infer`` (unit: the callable's call count), with ``serve.upload``
  and ``serve.forward``: ``serve.make_infer``;
- ``model.backbone``, ``model.init_regressor``, ``model.stage1``,
  ``model.stage2`` and ``model.heads``: ``models/dir.py``, inside whichever
  span calls the model.

The benchmark's readers (``portbench/program_spans.py``) read the record;
``profile_serve`` prints :func:`host_ms` of its traced request or step.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from dir_tpu_torch.device import _tracing

# The prefix of every span's name in the profiler's trace.
PREFIX = "dir."
# The most spans the record holds; further spans are counted as dropped.
MAX_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span: ``parent`` is the index in the record of the span
    it opened inside (None for a root), ``end_ns`` None while it is open."""
    name: str
    parent: Optional[int]
    unit: Optional[int]
    start_ns: int
    end_ns: Optional[int]


_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_record: list = []
_dropped = 0


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def recording() -> bool:
    """Whether a span records now: a ``torch.profiler`` session is active,
    and no ``torch.export`` or fake-tensor trace is running."""
    return (_autograd_profiler._is_profiler_enabled
            and not torch.compiler.is_exporting() and not _tracing())


class _Span:
    __slots__ = ("name", "unit", "_range", "_entry")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        global _dropped
        stack = _stack()
        parent = None
        if stack:
            parent, unit = stack[-1]
            if self.unit is None:
                self.unit = unit
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._entry = [self.name, parent, self.unit, time.perf_counter_ns(),
                       None]
        with _lock:
            if len(_record) < MAX_SPANS:
                _record.append(self._entry)
                index = len(_record) - 1
            else:
                _dropped += 1
                index = None
        stack.append((index, self.unit))
        return self

    def __exit__(self, *exc):
        self._entry[4] = time.perf_counter_ns()
        _stack().pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, unit: Optional[int] = None):
    """A context manager marking ``name`` (``dir.<name>`` in the profiler's
    trace) around the enclosed host work; ``unit`` numbers a root span's
    step or call, and a child without one takes its parent's. With no
    profiler active it returns one shared no-op context."""
    return _Span(name, unit) if recording() else _NOOP


def spans() -> list:
    """The record, as :class:`Span` tuples in the order they opened."""
    with _lock:
        return [Span(*e) for e in _record]


def dropped() -> int:
    """Spans left out since the last :func:`drain` because the record was
    full; a reader refuses a record that dropped any."""
    return _dropped


def drain() -> list:
    """:func:`spans`, then clear the record and the dropped count; call it
    with no span open (an open span's children would name a parent that
    the record no longer holds)."""
    global _record, _dropped
    if _stack():
        raise RuntimeError("profiling.drain() inside an open span")
    with _lock:
        out = [Span(*e) for e in _record]
        _record, _dropped = [], 0
    return out


def host_ms(prof) -> dict:
    """Host milliseconds inside each span in a ``torch.profiler`` trace,
    summed by name (without the ``dir.`` prefix), from the profiler's own
    events: an operator's reading of the spans in one traced call."""
    out: dict = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(PREFIX)):
            name = e.name[len(PREFIX):]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def device_events(prof) -> list:
    """The device's work in a ``torch.profiler`` trace: its CUDA events,
    less the ranges that host spans (the program's, any
    ``record_function``) draw on the device's timeline."""
    dev_t = torch.autograd.DeviceType
    events = prof.events()
    host = {e.name for e in events if e.device_type == dev_t.CPU}
    return [e for e in events if e.device_type == dev_t.CUDA
            and e.name not in host and not e.name.startswith(PREFIX)]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where a card is
    present, CUDA activity, the program's spans among it; the Chrome trace
    is written into ``log_dir`` (view it with TensorBoard's profiler plugin
    or Perfetto). Yields the profiler."""
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
