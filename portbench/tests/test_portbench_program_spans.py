"""The readers of the program's spans (``portbench/program_spans.py``) on a
synthetic slice: two train steps whose device busy stretches and program
phases are known, the program's clock 1 ms off the profiler's. The idle
time goes to the phase the host was in, the phases and the rest add up to
``device_idle_pct``'s idle time a step, and a record that does not fit the
slice is not read."""

import pytest

from dir_tpu_torch.utils import profiling
from portbench import harness, program_spans
from portbench.tests import tiny

OFFSET_US = 1000.0                 # the program's clock minus the trace's
PHASES = [("train.upload", 0, 40), ("train.optimizer", 40, 50),
          ("train.forward", 50, 190), ("train.loss", 190, 250),
          ("train.backward", 250, 390), ("train.optimizer", 390, 450)]
STEPS = (10.0, 500.0)              # portbench.step starts; each 470 us long
BUSY = [(0, 30), (100, 180), (270, 390), (455, 520), (540, 560),
        (600, 700), (760, 900), (940, 990)]
IDLE_METRICS = [f"idle_{p}_ms.train" for p in
                ("upload", "forward", "loss", "backward", "optimizer")]


def synthetic_trace(steps=STEPS, busy=BUSY):
    t = object.__new__(harness.Trace)
    t.device = [("kernel", s, e) for s, e in busy]
    t.spans = [("slice", 0.0, 1000.0)] + [("step", s, s + 470.0)
                                          for s in steps]
    t.start, t.end = 0.0, 1000.0
    t.wall_us = 1000.0
    t.busy = [[s, e] for s, e in busy]
    t.busy_us = sum(e - s for s, e in busy)
    t.units = len(steps)
    return t


def synthetic_record(steps=STEPS) -> list:
    """Each step's root (ending 5 us before its benchmark span), its
    phases, and a module span inside the forward, on the program's
    clock."""
    out = []

    def add(name, parent, unit, s, e):
        out.append(profiling.Span(name, parent, unit,
                                  int((s + OFFSET_US) * 1e3),
                                  int((e + OFFSET_US) * 1e3)))
        return len(out) - 1

    for unit, s0 in enumerate(steps):
        root = add("train.step", None, unit, s0, s0 + 465)
        for name, a, b in PHASES:
            i = add(name, root, unit, s0 + a, s0 + b)
            if name == "train.forward":
                add("model.backbone", i, unit, s0 + a + 10, s0 + a + 90)
    return out


def brute_idle_by_phase(steps=STEPS, busy=BUSY) -> tuple[dict, float]:
    """Idle microseconds by phase, counted microsecond by microsecond."""
    by = {p: 0.0 for p in program_spans.TRAIN_PHASES}
    total = 0.0
    for t in range(1000):
        mid = t + 0.5
        if any(s <= mid < e for s, e in busy):
            continue
        total += 1
        for s0 in steps:
            for name, a, b in PHASES:
                if s0 + a <= mid < s0 + b:
                    by[name] += 1
    return by, total


@pytest.fixture
def found(monkeypatch):
    record = synthetic_record()
    monkeypatch.setattr(program_spans, "record", lambda: record)
    return {"trace": synthetic_trace(), "units": 2, "unit_wall_s": 8e-4}


def test_idle_goes_to_the_phase_the_host_was_in(found):
    units = program_spans.aligned(found["trace"], program_spans.record(),
                                  "train.step")
    assert [u[0][1:] for u in units] == [(10.0, 475.0), (500.0, 965.0)]
    by, total = program_spans.split_idle(found["trace"], units,
                                         program_spans.TRAIN_PHASES)
    want, want_total = brute_idle_by_phase()
    assert total == pytest.approx(want_total)
    assert by == pytest.approx(want)
    assert all(v > 0 for v in by.values())


def test_a_late_root_keeps_the_common_offset():
    """A root that opened late inside its benchmark span (the host held
    up between the two) is placed by the clocks' common offset, the
    median over the pairs, not by its own pair's difference."""
    steps = (10.0, 500.0, 990.0)
    trace = synthetic_trace(steps)
    trace.spans[2] = ("step", 200.0, 970.0)     # opened 300 us early
    units = program_spans.aligned(trace, synthetic_record(steps),
                                  "train.step")
    assert [u[0][1:] for u in units] == [
        pytest.approx((s, s + 465.0)) for s in steps]


def test_phases_and_the_rest_meet_device_idle(found):
    """Each phase's share of the slice's idle time times a step's idle
    time outside the slice, and with the rest that
    ``device_idle_pct`` / 100 x ``unit_wall_s``."""
    got = {m: harness.load_reader(m)(found) for m in IDLE_METRICS}
    by = program_spans.idle_ms_by_phase(found)
    want, total = brute_idle_by_phase()
    idle_pct = harness.load_reader("device_idle_pct.train")(found)
    step_idle_ms = idle_pct / 100 * found["unit_wall_s"] * 1e3
    assert step_idle_ms == pytest.approx(0.8 - found["trace"].busy_us
                                         * 1e-3 / 2)
    for m, phase in zip(IDLE_METRICS, program_spans.TRAIN_PHASES):
        assert got[m] == pytest.approx(want[phase] / total * step_idle_ms)
    assert sum(by.values()) == pytest.approx(step_idle_ms)
    assert by["outside any phase"] == pytest.approx(
        (total - sum(want.values())) / total * step_idle_ms)


def test_not_read_when_the_record_does_not_fit(found, monkeypatch):
    """Fewer roots than benchmark spans, a record that dropped spans, a
    program with no record, no device events: no number."""
    readers = IDLE_METRICS + ["dispatch_ms.eval"]
    one = synthetic_record(STEPS[:1])
    monkeypatch.setattr(program_spans, "record", lambda: one)
    assert all(harness.load_reader(m)(found) is None for m in readers)

    monkeypatch.undo()
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    assert program_spans.record() is None
    monkeypatch.delattr(profiling, "spans")
    assert program_spans.record() is None

    monkeypatch.undo()
    rec = synthetic_record()
    monkeypatch.setattr(program_spans, "record", lambda: rec)
    found["trace"].device = []
    assert all(harness.load_reader(m)(found) is None for m in IDLE_METRICS)


def test_dispatch_is_the_host_time_in_the_forward(monkeypatch):
    """``dispatch_ms.eval``: ``serve.forward``'s host time a call."""
    steps = (10.0, 500.0)
    trace = synthetic_trace(steps)
    trace.spans = [("slice", 0.0, 1000.0)] + [("infer", s, s + 470.0)
                                              for s in steps]
    rec = []
    for unit, s0 in enumerate(steps):
        rec.append(profiling.Span("serve.infer", None, unit,
                                  int(s0 * 1e3), int((s0 + 460) * 1e3)))
        root = len(rec) - 1
        rec.append(profiling.Span("serve.upload", root, unit,
                                  int(s0 * 1e3), int((s0 + 60) * 1e3)))
        rec.append(profiling.Span("serve.forward", root, unit,
                                  int((s0 + 60) * 1e3),
                                  int((s0 + 60 + 300 + unit * 100) * 1e3)))
    monkeypatch.setattr(program_spans, "record", lambda: rec)
    got = harness.load_reader("dispatch_ms.eval")({"trace": trace})
    assert got == pytest.approx((300 + 400) / 2 * 1e-3)


def test_a_tiny_eval_run_reads_its_dispatch():
    """A tiny traced CPU run of the eval cell: the program's spans are
    found and aligned on the benchmark's, and ``dispatch_ms.eval`` is
    reported (the device metrics are not: there is no device)."""
    profiling.drain()
    line = tiny.tiny_run("a_eval_b1024", trace=True, seconds=4.0)
    assert line["metrics"]["dispatch_ms.eval"]["value"] > 0
    assert not any(m in line["metrics"] for m in IDLE_METRICS)
