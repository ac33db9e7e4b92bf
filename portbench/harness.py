"""The pieces every driver shares: the run's context, its spans, the
profiled slice and its reduction to device busy time, launches, copies
and idle gaps, the per-layer readers found by metric name, and the last
line of the run.

Spans are the benchmark's own: ``torch.profiler.record_function`` ranges
named ``portbench.<layer>`` around its calls into the program, so that in
the profiled slice a device idle gap can be named by the host span it fell
in.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import torch

from portbench import build

# Top-level module names the run must not have loaded (compared whole:
# the program's package name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "dir_tpu")
PEAKS = "portbench/rooflines/peaks.json"


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of
    its start (clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it: a card set below
    its 700 W runs slower under load."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def span(name: str):
    """A host span ``portbench.<name>`` that the profiler records."""
    return torch.profiler.record_function(f"portbench.{name}")


class Run:
    """One run of one cell: its entries, its seed and its device."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool,
                 device="cuda", cell=None):
        self.workload = workload
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.entry, self.cfg, self.traffic = cell or build.cell(workload)
        self.setup_s = None

    def window_opens(self) -> float:
        """Mark the end of set-up; returns the window's start (host
        clock)."""
        self.sync()
        self.setup_s = process_age_s()
        return time.perf_counter()

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@contextlib.contextmanager
def profiled(run: Run):
    """Profile the enclosed slice (a traced run's); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    run.sync()
    with profile(activities=acts) as prof:
        with span("slice"):
            yield prof
        run.sync()


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """The profiled slice, reduced: device events (kernels, copies, sets)
    as ``(name, start_us, end_us)``, the host spans of the benchmark, the
    slice's wall time and the device's busy time (the union of the device
    intervals)."""

    def __init__(self, prof, units: int):
        dev_t = torch.autograd.DeviceType
        events = prof.events()
        # a host range (record_function) also shows on the device's
        # timeline under its own name: that is no device work
        host = {e.name for e in events if e.device_type == dev_t.CPU}
        self.device = [(e.name, e.time_range.start, e.time_range.end)
                       for e in events if e.device_type == dev_t.CUDA
                       and e.name not in host]
        self.spans = [(e.name[len("portbench."):], e.time_range.start,
                       e.time_range.end) for e in events
                      if e.device_type == dev_t.CPU
                      and e.name.startswith("portbench.")]
        sl = [s for s in self.spans if s[0] == "slice"]
        self.start, self.end = (sl[0][1], sl[0][2]) if sl else (0.0, 0.0)
        self.wall_us = self.end - self.start
        self.busy = _union((s, e) for _, s, e in self.device)
        self.busy_us = sum(e - s for s, e in self.busy)
        self.units = units

    def kernels(self, part: str) -> list:
        return [(n, s, e) for n, s, e in self.device if part in n]

    def copies(self, kind: str) -> list:
        return [(n, s, e) for n, s, e in self.device
                if n.startswith("Memcpy") and kind in n]

    def device_ops(self, top: int = 10) -> list:
        by: dict = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return sorted(([n[:120], v] for n, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_by_span(self) -> dict:
        """The slice's idle seconds summed by the span they fell in."""
        out: dict = {}
        for name, sec in self.idle_gaps(top=None):
            out[name] = out.get(name, 0.0) + sec
        return out

    def idle_gaps(self, top: int | None = 10) -> list:
        """The longest stretches of the slice with no device work, each
        named by the innermost benchmark span the host was in when it
        began."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [
            self.end]
        gaps = []
        for s, e in zip(edges[0::2], edges[1::2]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            inside = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = min(inside, key=lambda sp: sp[2] - sp[1])[0] if inside \
                else "outside the benchmark's spans"
            gaps.append([name, (e - s) * 1e-6])
        return sorted(gaps, key=lambda g: -g[1])[:top]


def load_reader(metric: str):
    """The ``read`` of ``portbench/metrics/<metric>.py``, or, where there
    is no such file, of the file named by the metric's stem (the part
    before the first dot): ``launches.py`` reads ``launches.eval`` and
    ``launches.train``."""
    folder = os.path.join(build.ROOT, "portbench", "metrics")
    path = os.path.join(folder, f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(folder, f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(run: Run, found: dict) -> dict:
    """The cell's per-layer metrics, each from its own reader; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in build.benchmark()["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and run.workload not in cells:
            continue
        value = load_reader(m["name"])(found)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def peaks() -> dict:
    return build.read_json(PEAKS)


def limits(workload: str) -> dict:
    return build.read_json(f"portbench/limits/{workload}.json")["limits"]


def judge(workload: str, numbers: dict) -> tuple[bool, dict]:
    """Each number that has a limit against it; every one must be at or
    under its limit, and one that is missing or not finite fails. The
    readings that have no limit are printed, not compared."""
    lim = limits(workload)
    checks = {k: {"value": float(numbers.get(k, math.inf)), "limit": v}
              for k, v in lim.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    rest = {k: v for k, v in numbers.items() if k not in lim}
    if rest:
        say("readings not compared: " + ", ".join(
            f"{k} {v!r}" for k, v in rest.items()))
    return ok, checks


def result_line(run: Run, *, correct: bool, attempted: int, failed: int,
                metrics: dict, checks: dict, memory_peak: int,
                trace: Trace | None = None) -> dict:
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if trace is not None:
        say("device idle by host span (s): " + json.dumps(
            trace.idle_by_span()))
        device["busy_s"] = trace.busy_us * 1e-6
        device["window_s"] = trace.wall_us * 1e-6
        line["breakdown"] = {"device_ops": trace.device_ops(),
                             "idle_gaps": trace.idle_gaps()}
    line["checks"] = checks
    return line


def finish(run: Run, line: dict) -> int:
    """Print the compared numbers beside their limits on standard error,
    then the result as the last line of standard output; refuses when a
    forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        say(f"refused: the run loaded {', '.join(bad)}")
        return 3
    for k, c in line["checks"].items():
        say(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
