"""The train step as one CUDA graph (``train/steps.py:make_train_step``).

On the CPU: ``_normalize``'s bound as a Python scalar against the host
copy it replaced, in value and gradient; which steps are graphed
(``graphable``), and that a CPU step, a one-rank mesh, ``unroll`` and
``grad_accum`` run eager on every call with their phases; the graph's
bookkeeping (warm-up, capture, replay, another signature, a replaced
optimizer state) with a stand-in for the graph, and a replay's mark on
the versions of what it writes; the benchmark's
``replayed_pct.train`` on a synthetic slice. On the card (``gpu``):
eager, captured and replayed steps bit-equal to eager ones, no host
synchronisation in a replay, a recapture after ``optimizer.load_state_dict``,
loss dicts that later steps leave alone, and an eval forward after
replayed steps that folds the replayed weights (``ops/conv_epilogue.py``).
"""

import contextlib
import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dir_tpu_torch import serve
from dir_tpu_torch.config import TrainConfig
from dir_tpu_torch.models import losses
from dir_tpu_torch.models.resnet import Bottleneck
from dir_tpu_torch.ops import conv_epilogue
from dir_tpu_torch.parallel.mesh import Mesh
from dir_tpu_torch.train import steps as tsteps
from dir_tpu_torch.train.state import create_train_state, make_optimizer
from dir_tpu_torch.utils import profiling

LAYERS = (1, 1, 1, 1)
EAGER = ["train.upload", "train.optimizer", "train.forward", "train.loss",
         "train.backward", "train.optimizer"]
REPLAY = ["train.upload", "train.replay"]
CAPTURE = ["train.upload", "train.capture", "train.replay"]


@pytest.fixture(scope="module", autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _empty_record():
    profiling.drain()
    yield
    profiling.drain()


def wire_batch(rng, b: int, s: int) -> dict:
    """A host batch of ``b`` in the uint8 wire format at ``s`` x ``s``."""
    f = np.float32
    out = {"img": rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8),
           "seg": rng.randint(0, 3, (b, s, s)).astype(np.uint8),
           "dense": rng.randint(0, 256, (b, s, s, 3)).astype(np.uint8)}
    for side in ("left", "right"):
        out[f"joint_2d_{side}"] = rng.uniform(-1, 1, (b, 21, 3)).astype(f)
        out[f"mesh_2d_{side}"] = rng.uniform(-1, 1, (b, 778, 3)).astype(f)
        out[f"joint_3d_{side}"] = (rng.randn(b, 21, 3) * 0.05).astype(f)
        out[f"mesh_3d_{side}"] = (rng.randn(b, 778, 3) * 0.05).astype(f)
        out[f"center_{side}"] = (rng.randn(b, 1, 3) * 0.05).astype(f)
    return out


def traced(step, state, batch):
    """One call of ``step`` under a CPU profiler: the new state, the loss
    dict and the names of the spans directly under its ``train.step``."""
    profiling.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        state, loss = step(state, batch)
    record = profiling.drain()
    roots = [i for i, s in enumerate(record) if s.parent is None]
    assert [record[i].name for i in roots] == ["train.step"]
    return state, loss, [s.name for s in record if s.parent == roots[0]]


# -- CPU -------------------------------------------------------------------

def _old_normalize(v, eps=1e-12):
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.maximum(sq, sq.new_tensor(eps * eps)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_normalize_bound_matches_the_host_copy(dtype):
    """``clamp_min`` with a Python bound gives what ``maximum`` with the
    bound copied to the device gave: values and gradients equal, a zero
    row and a row under the bound included (0 and a finite gradient)."""
    g = torch.Generator().manual_seed(0)
    v = torch.randn(6, 5, 3, generator=g, dtype=dtype)
    v[1, 2] = 0.0
    v[4, 0] = 1e-14
    w = torch.randn(6, 5, 3, generator=g, dtype=dtype)
    outs = []
    for fn in (losses._normalize, _old_normalize):
        x = v.clone().requires_grad_(True)
        y = fn(x)
        (grad,) = torch.autograd.grad((y * w).sum(), x)
        outs.append((y.detach(), grad))
    (y, grad), (y_old, grad_old) = outs
    assert torch.equal(y, y_old) and torch.equal(grad, grad_old)
    assert torch.equal(y[1, 2], torch.zeros(3, dtype=dtype))
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize("dev, mesh, unroll, accum, want", [
    ("cuda", None, 1, 1, True),
    ("cuda:0", Mesh(0, 1, torch.device("cuda")), 1, 1, True),
    ("cpu", None, 1, 1, False),
    ("cuda", Mesh(0, 2, torch.device("cuda")), 1, 1, False),
    ("cuda", None, 2, 1, False),
    ("cuda", None, 1, 2, False),
], ids=["cuda", "one_rank_mesh", "cpu", "mesh", "unroll", "grad_accum"])
def test_which_steps_are_graphed(dev, mesh, unroll, accum, want):
    assert tsteps.graphable(torch.device(dev), mesh, unroll, accum) is want


@pytest.fixture(scope="module")
def tiny():
    """The tiny-backbone model of configuration B on the CPU at fp32."""
    return serve.build_flagship(device="cpu", dtype="float32",
                                backbone_layers=LAYERS, **serve.CONFIG_B)


def _no_graph(*args, **kwargs):
    raise AssertionError("a CUDA graph was made")


@pytest.mark.parametrize("kw, micro", [
    ({}, 1), ({"mesh": Mesh(0, 1, torch.device("cpu"))}, 1),
    ({"unroll": 2}, 2), ({"grad_accum": 2}, 2)],
    ids=["cpu", "one_rank_mesh", "unroll", "grad_accum"])
def test_eager_steps_never_capture(tiny, monkeypatch, kw, micro):
    """Three calls with one signature: each runs eager, records the phases
    it records without graphs, and no graph is made."""
    monkeypatch.setattr(tsteps, "_GraphedStep", _no_graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _no_graph)
    monkeypatch.setattr(torch.cuda, "graph", _no_graph)
    model, cfg, ml, mr = tiny
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    state = create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, cfg, ml, mr, device="cpu",
                                  **kw)
    rng = np.random.RandomState(0)
    if kw.get("unroll"):
        want = ["train.upload"] + EAGER[1:] * micro
    else:
        want = (EAGER[:2] + EAGER[2:5] * micro + EAGER[5:])
    for _ in range(3):
        data = wire_batch(rng, 2, 64)
        if micro > 1:
            data = {k: np.stack([v, v]) for k, v in data.items()}
        state, loss, phases = traced(step, state, data)
        assert phases == want
        assert all(np.isfinite(float(v)) for v in loss.values())
    assert all(not isinstance(g["lr"], torch.Tensor)
               and not g.get("capturable") for g in opt.param_groups)


class FakeGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: the 'capture'
    runs the step once, a replay runs nothing."""

    def replay(self):
        pass


class FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU; counts its waits."""
    waits = 0

    def record(self):
        pass

    def synchronize(self):
        FakeEvent.waits += 1


def _lr_tensors_(optimizer):
    """``_capturable_`` on the CPU, where AdamW takes no ``capturable``:
    each group's lr a 0-d fp32 tensor."""
    for group in optimizer.param_groups:
        if not isinstance(group["lr"], torch.Tensor):
            group["lr"] = torch.tensor(float(group["lr"]))


def _stand_in(monkeypatch):
    """``make_train_step`` on the CPU as on one CUDA device, with the
    stand-ins for the graph and its event."""
    monkeypatch.setattr(tsteps, "graphable", lambda *a: True)
    monkeypatch.setattr(tsteps, "_capturable_", _lr_tensors_)
    monkeypatch.setattr(tsteps, "_syncs_raise", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(FakeEvent, "waits", 0)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g: contextlib.nullcontext())


def test_graph_bookkeeping_with_a_stand_in(tiny, monkeypatch):
    """The path of each call as ``make_train_step`` picks it on one CUDA
    device, run on the CPU with a stand-in for the graph: the first call
    with a signature eager, the second capture and replay, then replays;
    another signature eager once and, repeated, a new capture in the old
    one's place; a replaced optimizer state drops the graph (eager, then a
    recapture), and so does a parameter moved to new memory;
    ``model.load_state_dict`` keeps it. Each replay returns its
    own copy of the losses, advances the step and waits for its end."""
    _stand_in(monkeypatch)
    model, cfg, ml, mr = tiny
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    state = create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, cfg, ml, mr, device="cpu")
    rng = np.random.RandomState(1)
    a, b = wire_batch(rng, 2, 64), wire_batch(rng, 1, 64)
    paths, held = [], []

    def call(batch):
        nonlocal state
        before = state.step
        state, loss, phases = traced(step, state, batch)
        assert state.step == before + 1
        paths.append({tuple(EAGER): "eager", tuple(REPLAY): "replay",
                      tuple(CAPTURE): "capture"}[tuple(phases)])
        held.append(loss)

    for batch in (a, a, a, b, a, b, b, b):
        call(batch)
    assert paths == ["eager", "capture", "replay", "eager", "replay",
                     "eager", "capture", "replay"]
    assert FakeEvent.waits == paths.count("capture") + paths.count("replay")
    assert held[-1] is not held[-2]
    assert held[-1]["seg"].data_ptr() != held[-2]["seg"].data_ptr()

    model.load_state_dict(model.state_dict())      # copies in place
    call(b)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    for _ in range(3):
        call(b)
    assert paths[-4:] == ["replay", "eager", "capture", "replay"]

    p = next(model.parameters())
    p.data = p.data.clone()                        # the same tensor, moved
    for _ in range(3):
        call(b)
    assert paths[-3:] == ["eager", "capture", "replay"]


def test_a_replay_marks_what_it_writes(tiny, monkeypatch):
    """A replay writes the parameters and the BN buffers where autograd
    does not see it; it moves the version of every parameter and buffer of
    the model, as an in-place op would, so operands kept from them before
    it (``ops/conv_epilogue.py:Kept``) are made anew. The stand-in's
    replay runs nothing: only the mark moves a version."""
    _stand_in(monkeypatch)
    model, cfg, ml, mr = copy.deepcopy(tiny)
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    state = create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, cfg, ml, mr, device="cpu")
    batch = wire_batch(np.random.RandomState(2), 2, 64)
    for want in (EAGER, CAPTURE):
        state, _, phases = traced(step, state, batch)
        assert phases == want
    block = next(m for m in model.modules() if isinstance(m, Bottleneck))
    pairs = [(block.conv1, block.bn1)]
    kept = conv_epilogue.Kept()
    first = kept.get(pairs, object)
    assert kept.get(pairs, object) is first
    tensors = [*model.parameters(), *model.buffers()]
    versions = [t._version for t in tensors]
    state, _, phases = traced(step, state, batch)
    assert phases == REPLAY
    assert all(t._version > v for t, v in zip(tensors, versions))
    assert kept.get(pairs, object) is not first


def test_checkpoint_of_a_graphed_optimizer_restores_on_the_cpu(
        tiny, tmp_path):
    """An optimizer made capturable with a tensor lr, as the graph path
    leaves it, is written as an eager step keeps it (a float lr,
    ``capturable`` off), so that it restores into a CPU optimizer, whose
    AdamW takes no capturable groups, and steps there."""
    from dir_tpu_torch.train import checkpoint as ckpt

    model = tiny[0]
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    for group in opt.param_groups:
        group["capturable"] = True
        group["lr"] = torch.tensor(3e-4)
    ckpt.save_checkpoint(str(tmp_path), create_train_state(model, opt))
    fresh = make_optimizer(model, TrainConfig(), steps_per_epoch=100)
    ckpt.restore_checkpoint(str(tmp_path), create_train_state(model, fresh))
    (group,) = fresh.param_groups
    assert group["lr"] == pytest.approx(3e-4) and not group["capturable"]
    assert isinstance(group["lr"], float)
    p = next(model.parameters())
    p.grad = torch.ones_like(p)
    fresh.step()
    p.grad = None


def test_replayed_pct_reads_the_share_of_replayed_steps(monkeypatch):
    """``replayed_pct.train`` on a synthetic slice of two steps (as
    ``portbench/tests/test_portbench_program_spans.py`` builds one): 0
    with no ``train.replay``, 50 with one of the two replayed, None on a
    record that does not fit the slice or where there is none."""
    from portbench import harness, program_spans
    from portbench.tests.test_portbench_program_spans import (
        STEPS, synthetic_record, synthetic_trace)

    read = harness.load_reader("replayed_pct.train")
    found = {"trace": synthetic_trace(), "units": 2, "unit_wall_s": 8e-4}
    eager = synthetic_record()
    monkeypatch.setattr(program_spans, "record", lambda: eager)
    assert read(found) == 0.0

    replayed = list(eager)
    root = max(i for i, s in enumerate(replayed) if s.name == "train.step")
    start = replayed[root].start_ns
    replayed.append(profiling.Span("train.replay", root, 1, start + 1000,
                                   start + 400_000))
    monkeypatch.setattr(program_spans, "record", lambda: replayed)
    assert read(found) == 50.0

    one = synthetic_record(STEPS[:1])
    monkeypatch.setattr(program_spans, "record", lambda: one)
    assert read(found) is None
    monkeypatch.setattr(program_spans, "record", lambda: None)
    assert read(found) is None
    assert read({"trace": None}) is None


# -- the card --------------------------------------------------------------

def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CARD_BATCH, CARD_SIZE = 8, 128


@pytest.fixture(scope="module")
def card():
    """A cut-depth bf16 flagship with B's decoder flags on the card, its
    conditioned start as a state_dict, the MANO pair and four host
    batches in the wire format."""
    dev = _cuda_or_skip()
    model, cfg, ml, mr = serve.build_flagship(
        device=dev, dtype="bfloat16", seed=0, backbone_layers=LAYERS,
        **serve.CONFIG_B)
    serve.condition_random_(model, ml, mr, seed=0)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.RandomState(2)
    batches = [wire_batch(rng, CARD_BATCH, CARD_SIZE) for _ in range(4)]
    return model, cfg, ml, mr, start, batches


def _fresh(card):
    """The model at the conditioned start, a new AdamW and its state."""
    model, cfg, ml, mr, start, _ = card
    model.load_state_dict(start, strict=True)
    model.zero_grad(set_to_none=True)
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    return model, opt, create_train_state(model, opt)


def _snapshot(model, opt) -> dict:
    out = {f"model.{k}": v.clone() for k, v in model.state_dict().items()}
    for n, p in model.named_parameters():
        for k in ("exp_avg", "exp_avg_sq"):
            if p in opt.state:
                out[f"{k}.{n}"] = opt.state[p][k].clone()
    return out


def _steps(card, n: int):
    """A new step function on a fresh start, driven through the first
    ``n`` batches; returns the model, optimizer, state, step function and
    the spans under each call's ``train.step``."""
    model, cfg, ml, mr, _, batches = card
    model, opt, state = _fresh(card)
    step = tsteps.make_train_step(model, opt, cfg, ml, mr)
    paths = []
    for batch in batches[:n]:
        state, _, phases = traced(step, state, batch)
        paths.append(phases)
    return model, opt, state, step, paths


@pytest.mark.gpu
def test_replayed_steps_bit_equal_to_eager_steps(card):
    """Four steps through one step function (eager, capture and replay,
    replay, replay) against four from the same start on the same batches,
    each through a newly built step function (so each eager): losses,
    parameters, BatchNorm statistics and AdamW's moments equal to the
    bit."""
    _, cfg, ml, mr, _, batches = card
    runs = []
    for fresh_each in (False, True):
        model, opt, state = _fresh(card)
        step = tsteps.make_train_step(model, opt, cfg, ml, mr)
        paths, got = [], []
        for batch in batches:
            if fresh_each:
                step = tsteps.make_train_step(model, opt, cfg, ml, mr)
            state, loss, phases = traced(step, state, batch)
            paths.append(phases)
            got.append({k: float(v) for k, v in loss.items()})
        torch.cuda.synchronize()
        runs.append((paths, got, _snapshot(model, opt)))
    (paths, graphed, after), (paths_e, eager, after_e) = runs
    assert paths == [EAGER, CAPTURE, REPLAY, REPLAY]
    assert paths_e == [EAGER] * 4
    assert all(np.isfinite(v) for d in graphed for v in d.values())
    assert graphed == eager
    assert [k for k in after if not torch.equal(after[k], after_e[k])] == []


@pytest.mark.gpu
def test_a_replay_makes_no_host_sync(card):
    """A replayed step (the copy of a host batch, the lr, the replay, the
    losses' copy) raises nothing under ``set_sync_debug_mode("error")``,
    and returns with none of its work left on the device."""
    _, _, state, step, paths = _steps(card, 2)
    assert paths == [EAGER, CAPTURE]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, loss = step(state, card[5][2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.cuda.current_stream().query()
    assert state.step == 3
    assert np.isfinite(float(losses.total_loss(loss)))


@pytest.mark.gpu
def test_later_steps_leave_a_loss_dict_alone(card):
    """The loss dicts of the capturing and of a replayed step keep their
    values through later replays."""
    _, _, state, step, _ = _steps(card, 1)
    held = []
    for batch in card[5][1:]:
        state, loss = step(state, batch)
        held.append((loss, {k: v.clone() for k, v in loss.items()}))
    state, _ = step(state, card[5][0])
    torch.cuda.synchronize()
    for loss, copied in held:
        assert all(torch.equal(loss[k], copied[k]) for k in loss)
    assert len({float(loss["seg"]) for loss, _ in held}) == len(held)


@pytest.mark.gpu
def test_a_replaced_optimizer_state_recaptures(card):
    """``model.load_state_dict`` copies in place and the next call
    replays; after ``optimizer.load_state_dict`` (new moments) the next
    call runs eager, the one after captures again, then replays; a state
    loaded between a warm-up and a capture is made capturable again."""
    model, opt, state, step, paths = _steps(card, 3)
    assert paths == [EAGER, CAPTURE, REPLAY]
    batch = card[5][3]
    model.load_state_dict({k: v.clone() for k, v in
                           model.state_dict().items()})
    state, _, phases = traced(step, state, batch)
    assert phases == REPLAY
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    for want in (EAGER, CAPTURE, REPLAY):
        state, loss, phases = traced(step, state, batch)
        assert phases == want
    assert state.step == 7
    assert np.isfinite(float(losses.total_loss(loss)))

    # a state loaded between the warm-up and the capture, as a checkpoint
    # holds it (a float lr, capturable off): the capture makes it
    # capturable again
    from dir_tpu_torch.train.checkpoint import optimizer_state_dict

    model, opt, state, step, paths = _steps(card, 1)
    opt.load_state_dict(optimizer_state_dict(opt))
    state, loss, phases = traced(step, state, card[5][1])
    assert phases == CAPTURE
    assert all(g["capturable"] and isinstance(g["lr"], torch.Tensor)
               for g in opt.param_groups)
    assert np.isfinite(float(losses.total_loss(loss)))


@pytest.mark.gpu
def test_eval_after_replayed_steps_folds_the_new_weights(card):
    """An eval forward between train steps keeps its folded operands
    (``ops/conv_epilogue.py``); the replays after it update the weights in
    place and mark their versions, so the next eval folds the new weights:
    it equals that of a copy of the model, which folds its weights
    afresh."""
    model, opt, state, step, paths = _steps(card, 3)
    assert paths == [EAGER, CAPTURE, REPLAY]
    _, cfg, ml, mr, _, batches = card
    evaluate = tsteps.make_eval_step(model, ml, mr)
    img = np.random.RandomState(3).randn(
        2, CARD_SIZE, CARD_SIZE, 3).astype(np.float32)
    before = evaluate(model, img)["stages"][-1]
    for batch in batches[:2]:
        state, _, phases = traced(step, state, batch)
        assert phases == REPLAY
    got = evaluate(model, img)["stages"][-1]
    copied = copy.deepcopy(model)
    want = tsteps.make_eval_step(copied, ml, mr)(copied, img)["stages"][-1]
    key = "pd_joint_xyz_left"
    assert not torch.equal(got[key], before[key])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
