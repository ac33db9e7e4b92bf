"""The port's spans (``dir_tpu_torch/utils/profiling.py``) on the CPU: a
train step and a serving call record their phases and the model's modules
under ``torch.profiler`` and nothing without it, an exported program is
the same with a profiler active, the record refuses to grow past its
bound, ``host_ms`` reads the spans from the profiler's events, and
``MicroBatcher`` returns each request's queue wait."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dir_tpu_torch import serve
from dir_tpu_torch.apps import serve_http
from dir_tpu_torch.config import TrainConfig
from dir_tpu_torch.train.state import create_train_state, make_optimizer
from dir_tpu_torch.train.steps import make_train_step
from dir_tpu_torch.utils import profiling

LAYERS = (1, 1, 1, 1)
B, S = 2, 64
MODEL = ["model.backbone", "model.init_regressor", "model.stage1",
         "model.stage2", "model.heads"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.drain()
    yield
    profiling.drain()


@pytest.fixture(scope="module")
def tiny():
    """The tiny-backbone model of configuration B on the CPU at fp32."""
    model, cfg, ml, mr = serve.build_flagship(
        device="cpu", dtype="float32", backbone_layers=LAYERS,
        **serve.CONFIG_B)
    return model, cfg, ml, mr


def batch(rng, b=B) -> dict:
    """A float training batch of ``b`` images."""
    f = np.float32
    out = {"img": rng.randn(b, S, S, 3).astype(f),
           "seg": rng.randint(0, 3, size=(b, S, S)).astype(np.int32),
           "dense": rng.rand(b, S, S, 3).astype(f)}
    for side in ("left", "right"):
        out[f"joint_2d_{side}"] = rng.uniform(-1, 1, (b, 21, 3)).astype(f)
        out[f"mesh_2d_{side}"] = rng.uniform(-1, 1, (b, 778, 3)).astype(f)
        out[f"joint_3d_{side}"] = (rng.randn(b, 21, 3) * 0.05).astype(f)
        out[f"mesh_3d_{side}"] = (rng.randn(b, 778, 3) * 0.05).astype(f)
        out[f"center_{side}"] = (rng.randn(b, 1, 3) * 0.05).astype(f)
    return out


def train_step(tiny, **kw):
    model, cfg, ml, mr = tiny
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    return create_train_state(model, opt), make_train_step(
        model, opt, cfg, ml, mr, device="cpu", **kw)


def children(record, parent: int) -> list:
    return [i for i, s in enumerate(record) if s.parent == parent]


def names(record, idx) -> list:
    return [record[i].name for i in idx]


def check_model_spans(record, parent: int, unit) -> None:
    """One span of each of the model's modules, in order, under
    ``parent``, with its unit."""
    kids = children(record, parent)
    assert names(record, kids) == MODEL
    assert all(record[i].unit == unit for i in kids)
    assert all(not children(record, i) for i in kids)


def check_closed_and_nested(record) -> None:
    for s in record:
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.parent is not None:
            p = record[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


@pytest.mark.parametrize("kw, micro", [({}, 1), ({"grad_accum": 2}, 2),
                                       ({"unroll": 2}, 2)],
                         ids=["one", "grad_accum", "unroll"])
def test_train_step_records_its_phases(tiny, kw, micro):
    """``train.step`` with its unit, then its phases in order (the
    optimizer's ``zero_grad`` before the forward, its update after the
    backward; each micro-step's own forward, loss and backward), the
    model's five modules inside each forward, every span closed inside its
    parent."""
    state, step = train_step(tiny, **kw)
    state.step = 7
    rng = np.random.RandomState(0)
    data = batch(rng) if micro == 1 else {
        k: np.stack([v, v]) for k, v in batch(rng).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, data)
    record = profiling.spans()
    assert profiling.dropped() == 0
    check_closed_and_nested(record)
    roots = [i for i, s in enumerate(record) if s.parent is None]
    assert names(record, roots) == ["train.step"]
    assert record[0].unit == 7 and all(s.unit == 7 for s in record)
    if kw.get("unroll"):
        one = ["train.optimizer", "train.forward", "train.loss",
               "train.backward", "train.optimizer"]
        phases = ["train.upload"] + one * micro
    else:
        phases = (["train.upload", "train.optimizer"]
                  + ["train.forward", "train.loss", "train.backward"] * micro
                  + ["train.optimizer"])
    kids = children(record, 0)
    assert names(record, kids) == phases
    forwards = [i for i in kids if record[i].name == "train.forward"]
    assert len(forwards) == micro
    for i in forwards:
        check_model_spans(record, i, 7)
    assert state.step == 7 + (micro if kw.get("unroll") else 1)
    # each span is also a range on the profiler's clock
    ranges = sorted(e.name for e in prof.events()
                    if e.name.startswith(profiling.PREFIX))
    assert ranges == sorted(profiling.PREFIX + s.name for s in record)


def test_nothing_recorded_without_a_profiler(tiny):
    """With no profiler active a train step and an infer call leave the
    record empty, and ``span()`` returns the one shared no-op."""
    state, step = train_step(tiny)
    step(state, batch(np.random.RandomState(1)))
    model, _, ml, mr = tiny
    serve.make_infer(model, ml, mr)(
        np.random.RandomState(2).randn(B, S, S, 3).astype(np.float32))
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.span("x") is profiling.span("y", unit=3)
    assert profiling.span("x") is profiling._NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("x") is not profiling._NOOP
    assert not profiling.recording()


def test_infer_records_serve_and_model_spans(tiny):
    """``serve.infer`` numbered by the callable's calls, its upload and
    forward, and the model's five modules inside the forward."""
    model, _, ml, mr = tiny
    infer = serve.make_infer(model, ml, mr)
    img = np.random.RandomState(3).randn(B, S, S, 3).astype(np.float32)
    infer(img)                                   # call 0, not profiled
    with profile(activities=[ProfilerActivity.CPU]):
        infer(img)
        infer(img)
    record = profiling.spans()
    check_closed_and_nested(record)
    roots = [i for i, s in enumerate(record) if s.parent is None]
    assert names(record, roots) == ["serve.infer"] * 2
    assert [record[i].unit for i in roots] == [1, 2]
    for r in roots:
        kids = children(record, r)
        assert names(record, kids) == ["serve.upload", "serve.forward"]
        assert all(record[i].unit == record[r].unit for i in kids)
        check_model_spans(record, kids[1], record[r].unit)


def test_export_under_a_profiler_is_unchanged(tiny):
    """The program exported while a profiler records has the same graph
    ops as one exported without: no span enters the trace."""
    model, _, ml, mr = tiny
    plain = serve.export_program(model, ml, mr, batch_size=B, img_size=S)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = serve.export_program(model, ml, mr, batch_size=B,
                                      img_size=S)

    def targets(program):
        return [str(n.target) for n in program.graph.nodes
                if n.op == "call_function"]

    assert serve.op_counts(traced) == serve.op_counts(plain)
    assert targets(traced) == targets(plain)
    assert not any("record_function" in t for t in targets(traced))
    # only the seeded forward before the trace, on real tensors, recorded
    assert [s.name for s in profiling.spans()] == MODEL


def test_overflow_sets_dropped(monkeypatch):
    """Past ``MAX_SPANS`` spans are counted as dropped, not recorded; a
    drain clears both."""
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a", unit=1):
            for _ in range(5):
                with profiling.span("b"):
                    pass
    record = profiling.spans()
    assert [s.name for s in record] == ["a", "b", "b"]
    assert [s.parent for s in record] == [None, 0, 0]
    assert [s.unit for s in record] == [1, 1, 1]
    assert profiling.dropped() == 3
    assert len(profiling.drain()) == 3
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_span_open_across_a_drain():
    """A drain inside an open span is refused and leaves the record whole:
    the span's children would name a parent the record no longer held."""
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", unit=5):
            with pytest.raises(RuntimeError, match="open span"):
                profiling.drain()
            with profiling.span("inner"):
                pass
    record = profiling.spans()
    assert [(s.name, s.parent, s.unit) for s in record] == [
        ("outer", None, 5), ("inner", 0, 5)]
    assert all(s.end_ns is not None for s in record)


def test_host_ms_reads_the_spans(tiny):
    """``host_ms`` sums each span's host time from the profiler's own
    events: the infer call's, its forward's and the model's modules',
    each inside the span that holds it."""
    model, _, ml, mr = tiny
    infer = serve.make_infer(model, ml, mr)
    img = np.random.RandomState(4).randn(B, S, S, 3).astype(np.float32)
    infer(img)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infer(img)
    got = profiling.host_ms(prof)
    assert sorted(got) == sorted(["serve.infer", "serve.upload",
                                  "serve.forward"] + MODEL)
    assert all(v > 0 for v in got.values())
    assert got["serve.infer"] >= got["serve.forward"] + got["serve.upload"]
    assert got["serve.forward"] >= sum(got[m] for m in MODEL)


def _fake_infer(img):
    n = img.shape[0]
    final = {k: torch.zeros(n, 3) for k in (
        "pd_mesh_xyz_left", "pd_mesh_xyz_right", "pd_joint_xyz_left",
        "pd_joint_xyz_right", "pd_offset")}
    return {"stages": [final]}


def test_microbatcher_queue_wait():
    """Requests coalesced into one dispatch each return their wait, from
    their arrival to the dispatch's start: positive, within the call's
    own time, and at least the window for a request the window held; a
    request retried alone after its group failed returns the wait to its
    own dispatch."""
    stats = {"requests": 0, "images": 0, "dispatches": 0, "lat_sum": 0.0}
    batcher = serve_http.MicroBatcher(_fake_infer, threading.Lock(), stats,
                                      False, max_batch=3, window_ms=300.0)
    got = {}

    def call(i, shape):
        t = time.perf_counter()
        got[i] = (batcher.submit_timed(np.zeros(shape, np.float32))[1],
                  time.perf_counter() - t)

    try:
        threads = [threading.Thread(target=call, args=(i, (1, 4, 4, 3)))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        call("alone", (1, 4, 4, 3))                 # the window runs out
        threads = [threading.Thread(target=call, args=(i, shape))
                   for i, shape in (("ok", (1, 4, 4, 3)),
                                    ("odd", (1, 5, 5, 3)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.stop()
    assert not any(t.is_alive() for t in threads)
    # the pair's shapes do not concatenate: each is retried alone
    assert stats["images"] == 6 and stats["requests"] == 0
    for i in (0, 1, 2, "alone", "ok", "odd"):
        wait, call_s = got[i]
        assert 0.0 < wait < call_s
    assert got["alone"][0] >= 0.3
