"""The program's own spans in the profiled slice, for the readers of the
per-layer metrics that split a unit's time by the program's phases.

The program (``dir_tpu_torch/utils/profiling.py``) records its spans while
a profiler is active, as ``(name, parent, unit, start_ns, end_ns)`` on the
host's ``time.perf_counter_ns`` clock; the slice's ``harness.Trace`` holds
the benchmark's spans and the device's events on the profiler's clock.
Each program root span (``train.step``, ``serve.infer``) runs inside the
benchmark span that called it (``portbench.step``, ``portbench.infer``):
the two are matched by order, and every span is moved onto the
profiler's clock by the median over the pairs of the difference of the
two starts (the clocks differ by a constant; a pair's own difference also
holds whatever delayed the root's start). The largest mismatch of that
mapping (how far a pair's difference strays from the median, and how far
a root's end falls from its benchmark span's end) is printed on standard
error.

A reader returns None where the program keeps no such record (an older
program), the record dropped spans, or the roots and the benchmark's spans
differ in number: a truncated or foreign record is never read as a
number.
"""

from __future__ import annotations

import bisect
import statistics

from portbench import harness

# The train step's phases, as the program names them.
TRAIN_PHASES = ("train.upload", "train.forward", "train.loss",
                "train.backward", "train.optimizer")
# The benchmark's span around each program root span.
BENCH_SPAN = {"train.step": "step", "serve.infer": "infer"}

_last: list = [None, None, None]  # trace, record length, result: the latest


def record():
    """The program's span record, or None where it has none or it
    dropped spans."""
    try:
        from dir_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    if profiling.dropped():
        harness.say(f"program spans: {profiling.dropped()} dropped; the "
                    "record is not read")
        return None
    return profiling.spans()


def aligned(trace, spans: list, root: str):
    """The spans under each program root ``root`` (the root among them) as
    ``(name, start_us, end_us)`` on the trace's clock, one list a root in
    order; None when the roots and the benchmark's spans around them
    differ in number."""
    bench = sorted((s, e) for n, s, e in trace.spans
                   if n == BENCH_SPAN[root])
    top = {}                       # index -> index of its root
    for i, sp in enumerate(spans):
        top[i] = i if sp.parent is None else top.get(sp.parent)
    roots = [i for i, sp in enumerate(spans)
             if sp.parent is None and sp.name == root
             and sp.end_ns is not None]
    if not roots or len(roots) != len(bench):
        harness.say(f"program spans: {len(roots)} {root} against "
                    f"{len(bench)} portbench.{BENCH_SPAN[root]}; not read")
        return None
    offsets = [b[0] - spans[r].start_ns * 1e-3
               for r, b in zip(roots, bench)]
    mid = statistics.median(offsets)
    end_miss = max(abs(spans[r].end_ns * 1e-3 + mid - b[1])
                   for r, b in zip(roots, bench))
    harness.say(f"program spans: {len(roots)} {root} aligned on "
                f"portbench.{BENCH_SPAN[root]}; largest start mismatch "
                f"{max(abs(o - mid) for o in offsets):.3f} us, end "
                f"mismatch {end_miss:.3f} us")
    where = {r: k for k, r in enumerate(roots)}
    out = [[] for _ in roots]
    for i, sp in enumerate(spans):
        k = where.get(top[i])
        if k is not None and sp.end_ns is not None:
            out[k].append((sp.name, sp.start_ns * 1e-3 + mid,
                           sp.end_ns * 1e-3 + mid))
    return out


def idle_stretches(trace) -> list:
    """The slice's stretches with no device work, ``(start_us, end_us)``
    in order."""
    edges = [trace.start] + [x for iv in trace.busy for x in iv] + [
        trace.end]
    out = []
    for s, e in zip(edges[0::2], edges[1::2]):
        s, e = max(s, trace.start), min(e, trace.end)
        if e > s:
            out.append((s, e))
    return out


def overlap(stretches: list, starts: list, s: float, e: float) -> float:
    """Microseconds of ``stretches`` (disjoint, in order; ``starts`` their
    starts) inside ``[s, e]``."""
    total = 0.0
    i = max(bisect.bisect_right(starts, s) - 1, 0)
    while i < len(stretches) and stretches[i][0] < e:
        total += max(0.0, min(e, stretches[i][1]) - max(s, stretches[i][0]))
        i += 1
    return total


def split_idle(trace, units: list, phases) -> tuple[dict, float]:
    """The slice's idle microseconds by the phase the host was in (module
    spans fall inside their phase), and the total idle microseconds."""
    stretches = idle_stretches(trace)
    starts = [s for s, _ in stretches]
    by = dict.fromkeys(phases, 0.0)
    for unit in units:
        for name, s, e in unit:
            if name in by:
                by[name] += overlap(stretches, starts, s, e)
    return by, sum(e - s for s, e in stretches)


def idle_ms_by_phase(found, root: str = "train.step",
                     phases=TRAIN_PHASES):
    """Each phase's device idle time a unit, in ms, and the idle time
    outside any phase (``"outside any phase"``): its share of the slice's
    idle time times the idle time of a unit outside the slice
    (``unit_wall_s`` less the device's busy time a unit, as
    ``device_idle_pct`` reads them); None where it cannot be read."""
    trace = found.get("trace")
    if not trace or not trace.device or not trace.units:
        return None
    spans = record()
    n = None if spans is None else len(spans)
    if _last[0] is trace and _last[1] == n:
        return _last[2]
    units = None if spans is None else aligned(trace, spans, root)
    result = None
    if units is not None:
        by, total = split_idle(trace, units, phases)
        if total > 0:
            untraced = found["unit_wall_s"] - trace.busy_us * 1e-6 / \
                trace.units
            scale = untraced * 1e3 / total
            by["outside any phase"] = total - sum(by.values())
            result = {k: v * scale for k, v in by.items()}
            harness.say(
                "device idle by program phase (share of the slice's idle; "
                "ms a unit outside the slice): " + ", ".join(
                    f"{k} {v / total:.4f} ({result[k]:.3f})"
                    for k, v in by.items())
                + f"; sum {sum(result.values()):.3f} ms = device_idle_pct "
                f"/ 100 x unit_wall_s {untraced * 1e3:.3f} ms")
    _last[:] = [trace, n, result]
    return result


def span_ms(found, root: str, name: str):
    """The host time inside the program's spans ``name`` a unit of the
    slice, in ms (the profiler's own cost included); None where it cannot
    be read."""
    trace = found.get("trace")
    if not trace or not trace.units:
        return None
    spans = record()
    units = None if spans is None else aligned(trace, spans, root)
    if units is None:
        return None
    total = sum(e - s for unit in units for n, s, e in unit if n == name)
    return total * 1e-3 / trace.units
