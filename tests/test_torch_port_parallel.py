"""The port's data parallelism (``dir_tpu_torch/parallel/``) against
``dir_tpu`` on the same global batch.

Two gloo CPU ranks (``torch_port_parallel_worker.py``, one process a rank,
two threads each, bounded waits) compute on their blocks what one process
computes on the global batch, which is what ``dir_tpu``'s mesh computes
(``tests/test_train_e2e.py::test_dp_step_equals_single_device``):

* every BatchNorm form the train forward runs (2d, 1d, ``bn_tokens``, the
  Residual's pair input) against PyTorch's own BatchNorm on the whole
  batch: outputs, input and parameter gradients, running statistics;
* the weighted cross-entropy and Lovász-softmax against the one-process
  losses, value and gradient, with a class present on one rank only;
* the train step on the tiny ``(1, 1, 1, 1)`` DIR at 64x64, global batch 4,
  fp64, against ``dir_tpu``'s step (its ``loss_for`` under
  ``jax.value_and_grad`` and its AdamW), for the default decoder and the
  materialized splat (B's flags; K5's plain version on the CPU), and with
  ``unroll=2`` and ``grad_accum=2``: loss dict, gradients, BN statistics,
  parameters, and both ranks' parameters bit-identical;
* the sharded metric accumulators of a padded batch against ``dir_tpu``'s.

Then the mesh's blocks against ``P("data")``'s placement, its refusals, and
a world of 1 as the identity. The Trainer and the apps over two ranks are
in test_torch_port_parallel_apps.py.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.config import TrainConfig as JTrainConfig
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.models.losses import dir_losses as jdir_losses
from dir_tpu.models.losses import total_loss as jtotal_loss
from dir_tpu.parallel.mesh import make_mesh as jmake_mesh
from dir_tpu.train import evaluate as jevaluate
from dir_tpu.train import state as jstate
from dir_tpu.train import steps as jsteps

from dir_tpu_torch.config import ModelConfig, TrainConfig
from dir_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d, Residual,
                                         bn_tokens)
from dir_tpu_torch.models.losses import lovasz_softmax, weighted_cross_entropy
from dir_tpu_torch.parallel import mesh as pmesh
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree, torch_threads, x64  # noqa: E402
from torch_port_parallel_worker import (start_ranks,  # noqa: E402
                                        step_errors, wait_ranks)
from torch_port_train_helpers import (LAYERS, as_dtype, jax_f64,  # noqa: E402
                                      jax_manos, jax_variables, make_batch,
                                      port_manos, port_model,
                                      unit_edge_scores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
GLOBAL_B = 4
IMG = 64
# one epoch a step: the cosine schedule moves the lr between the steps
STEPS_PER_EPOCH = 1
DECODERS = {"default": ({}, {}),
            "splat": ({"fused_splat_conv": False},
                      {"fused_splat_conv": False, "use_pallas_splat": True})}

# Measured errors (fp64) and the bounds, about ten times each.
BN_TOL = 1e-13        # two ranks vs one process: measured 8.2e-15
SEG_TOL = 1e-13       # two ranks vs one process: measured 0
# After each call, the worst loss term (relative), gradient leaf (relative L2
# norm; the graph convs' edge scores apart, their gradient is fp32-limited
# in both packages), BN statistic (of each tensor's max) and parameter (in
# lr). Two ranks against one process (rank 0's check), measured: 7.9e-15,
# 1.2e-11, edge 1.2e-7, 9.5e-13, 7.1e-7 lr.
MESH_TOL = {"loss": 1e-13, "grad": 1e-10, "edge_grad": 1e-6,
            "stats": 1e-11, "param": 1e-5}
# One process against dir_tpu, per step. Step 1, measured: 1.2e-15,
# 1.1e-11, edge 2.5e-8, 5.2e-15, 4.8e-8 lr. Step 2 starts from edge scores
# that no longer agree within a row, where the two packages' fp32 softmax
# rounds apart (torch_port_train_helpers.fp64_setup), measured: 4.5e-8,
# 4.1e-6, edge 2.4e-7, 5.7e-8, 3.7e-3 lr; its parameters are held to
# dir_tpu's own element bound of 2 lr after AdamW
# (tests/test_train_e2e.py:test_dp_step_equals_single_device), which Adam's
# normalized step reaches where rounding moves a near-zero gradient. The
# two ranks' loss dicts are held against dir_tpu's with the loss bound.
PORT_TOL = [{"loss": 1e-14, "grad": 1e-10, "edge_grad": 3e-7,
             "stats": 5e-14, "param": 5e-7},
            {"loss": 5e-7, "grad": 5e-5, "edge_grad": 3e-6, "stats": 6e-7,
             "param": 2.0}]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


# -- the mesh itself -------------------------------------------------------

@pytest.mark.parametrize("world,leading", [(1, False), (2, False),
                                           (4, False), (2, True)])
def test_shard_batch_blocks_are_p_data_blocks(world, leading):
    """Each rank's block equals what ``P("data")`` (``P(None, "data")``
    with leading steps) places on device ``rank`` of dir_tpu's mesh."""
    rng = np.random.RandomState(0)
    shape = (3, 8, 5, 2) if leading else (8, 5, 2)
    x = rng.randn(*shape).astype(np.float32)
    spec = P(None, "data") if leading else P("data")
    jmesh = jmake_mesh(world)
    places = NamedSharding(jmesh, spec).devices_indices_map(shape)
    for rank, d in enumerate(jmesh.devices.flat):
        mesh = pmesh.Mesh(rank=rank, world=world, device=torch.device("cpu"))
        got = pmesh.shard_batch({"x": x}, mesh, leading_steps=leading)["x"]
        np.testing.assert_array_equal(got.numpy(), x[places[d]])
        if world == 1:
            np.testing.assert_array_equal(got.numpy(), x)


def test_mesh_refusals(monkeypatch):
    mesh = pmesh.Mesh(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(np.zeros((3, 2)), mesh)
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        pmesh.make_mesh(2, device="cpu")
    assert pmesh.make_mesh(device="cpu").world == 1
    args = ("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        pmesh.init_distributed(*args)                 # NCCL by default
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pmesh.init_distributed(*args, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="refuses two ranks on one card"):
        pmesh.init_distributed(*args, backend="nccl")


def test_parallel_package_and_rank_worker_load_no_jax():
    """Importing ``dir_tpu_torch.parallel`` (every module of it) and the
    rank worker of these tests loads no module of JAX or ``dir_tpu``: the
    card's machine has no JAX, and its gpu tests start the worker's ranks.
    (tests/test_torch_port_model.py checks every file's import
    statements.)"""
    code = ("import sys; sys.path.insert(0, 'tests')\n"
            "import dir_tpu_torch.parallel, dir_tpu_torch.parallel.launch\n"
            "import dir_tpu_torch.parallel.batch_norm\n"
            "import torch_port_parallel_worker\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dir_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_world_of_one_is_the_identity():
    """A mesh of one rank changes nothing: the train step with it is bit for
    bit the step without it (fp32)."""
    from dir_tpu_torch.train import state as tstate
    from dir_tpu_torch.train import steps as tsteps

    rng = np.random.RandomState(2)
    batches = [make_batch(rng)]
    variables = jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS)),
                              batches[0]["img"])
    tl, tr = port_manos()
    runs = []
    for mesh in (None, pmesh.make_mesh(1, device="cpu")):
        model = port_model(variables)
        opt = tstate.make_optimizer(model, TrainConfig(), 1)
        state = tstate.create_train_state(model, opt)
        step = tsteps.make_train_step(model, opt, model.cfg, tl, tr,
                                      device="cpu", mesh=mesh)
        losses = []
        for b in batches:
            b = b if mesh is None else pmesh.shard_batch(b, mesh)
            state, ld = step(state, b)
            losses.append({k: v.clone() for k, v in ld.items()})
        runs.append((losses, model.state_dict()))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# -- the two-rank session ---------------------------------------------------

def _bn_cases(rng):
    """(name, module, inputs, upstream gradient) of each BN form, fp64, with
    |mean| > std inputs and running statistics away from the batch's."""
    c = 6
    cases = []
    for kind, shapes in (("2d", [(GLOBAL_B, c, 5, 7)]),
                         ("1d", [(GLOBAL_B, c, 9)]),
                         ("tokens", [(GLOBAL_B, 9, c)]),
                         ("pair", [(GLOBAL_B, 2, 5, 5),
                                   (GLOBAL_B, 4, 5, 5)])):
        module = {"2d": lambda: BatchNorm2d(c), "1d": lambda: BatchNorm1d(c),
                  "tokens": lambda: BatchNorm1d(c),
                  "pair": lambda: Residual(c, c, dtype=torch.float64)
                  }[kind]().double()
        with torch.no_grad():
            for name, t in module.state_dict().items():
                if "running_mean" in name:
                    t.copy_(torch.from_numpy(rng.randn(*t.shape)))
                elif "running_var" in name or name.endswith("weight"):
                    t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
                elif t.is_floating_point():
                    t.copy_(torch.from_numpy(rng.uniform(-.5, .5, t.shape)))
        xs = [rng.randn(*s) * 2 + 3 for s in shapes]
        out_shape = (GLOBAL_B, c, 5, 5) if kind == "pair" else shapes[0]
        cases.append((kind, module, xs, rng.randn(*out_shape)))
    return cases


def _seg_cases(rng):
    """Logits (B, H, W, 3) and labels: random classes, and a case where
    class 2 is present only in rank 0's block."""
    logits = rng.randn(GLOBAL_B, 6, 6, 3)
    mixed = rng.randint(0, 3, (GLOBAL_B, 6, 6))
    one_rank = rng.randint(0, 2, (GLOBAL_B, 6, 6))
    one_rank[0, :2, :3] = 2
    return {"mixed": (logits, mixed), "one_rank_class": (logits, one_rank)}


def _train_batches():
    rng = np.random.RandomState(1)
    return [as_dtype(make_batch(rng, b=GLOBAL_B), np.float64)
            for _ in range(2)]


def _train_variables(jflags):
    """Seeded random fp64 variables of the tiny DIR with the graph convs'
    edge scores at 1 (see ``torch_port_train_helpers.fp64_setup``: with
    equal scores the fp32 edge softmax is exact in both packages)."""
    batches = _train_batches()
    variables = jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS,
                                                **jflags)),
                              batches[0]["img"])
    with x64():
        v = jax_f64(variables)
        return {"params": unit_edge_scores(v["params"]),
                "batch_stats": v["batch_stats"]}


def _state_dict(params, stats) -> dict:
    return {k: v.double() for k, v in jax_to_state_dict(
        numpy_tree(params), numpy_tree(stats), LAYERS).items()}


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """One two-rank session runs every unit task while this process runs
    dir_tpu's steps and the one-process port (:func:`_jax_reference`);
    returns the inputs, the references and each rank's results."""
    rng = np.random.RandomState(7)
    bn = _bn_cases(rng)
    seg = _seg_cases(rng)
    batches = _train_batches()
    tasks = []
    for kind, module, xs, g in bn:
        tasks.append((f"bn_{kind}", "bn", {
            "kind": kind, "channels": 6, "inputs": xs, "grad": g,
            "state": {k: v.clone() for k, v in module.state_dict().items()}}))
    for name, (logits, labels) in seg.items():
        tasks.append((f"seg_{name}", "seg", {
            "logits": logits, "labels": labels,
            "class_weights": ModelConfig().seg_class_weights}))
    variables, weights = {}, {}
    for decoder, (jflags, flags) in DECODERS.items():
        variables[decoder] = _train_variables(jflags)
        # fp32 random values made fp64: shipped as fp32, exactly
        weights[decoder] = {k: v.float() if v.is_floating_point() else v
                            for k, v in _state_dict(
                                variables[decoder]["params"],
                                variables[decoder]["batch_stats"]).items()}
        modes = (["steps", "unroll", "grad_accum"] if decoder == "default"
                 else ["steps"])
        tasks.append((f"train_{decoder}", "train", {
            "flags": flags, "state_dict_of": decoder, "modes": modes,
            "steps_per_epoch": STEPS_PER_EPOCH, "batches": batches}))
    metrics = _metrics_inputs(np.random.RandomState(11))
    tasks.append(("metrics", "metrics", metrics))
    work = tmp_path_factory.mktemp("dp")
    try:
        started = start_ranks(tasks, WORLD, str(work), threads=2,
                              state_dicts=weights)
        # dir_tpu's steps and the one-process port meanwhile
        references = {}
        for decoder, (jflags, flags) in DECODERS.items():
            modes = [("steps", flags)] + ([("grad_accum", flags)]
                                          if decoder == "default" else [])
            references[decoder] = _jax_reference(
                _jax_step_fns(jflags), variables[decoder], batches, modes)
        results = wait_ranks(started)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"bn": bn, "seg": seg, "batches": batches, "metrics": metrics,
            "references": references, "ranks": results}


@pytest.mark.parametrize("kind", ["2d", "1d", "tokens", "pair"])
def test_global_batch_norm_matches_one_process(session, kind):
    _, module, xs, g = next(c for c in session["bn"] if c[0] == kind)
    ranks = [r[f"bn_{kind}"] for r in session["ranks"]]
    module.train()
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    if kind == "tokens":
        out = bn_tokens(tx[0], module)
    elif kind == "pair":
        out = module(tx[0], tx[1])
    else:
        out = module(tx[0])
    torch.sum(out * torch.from_numpy(g)).backward()
    errs = {
        "out": float((torch.cat([r["out"] for r in ranks]) - out.detach())
                     .abs().max()),
        "input_grad": max(float((torch.cat([r["input_grads"][i]
                                            for r in ranks]) - x.grad)
                                .abs().max()) for i, x in enumerate(tx)),
        # each rank holds its block's part of a parameter's gradient
        "param_grad": max(float((sum(r["param_grads"][k] for r in ranks)
                                 - p.grad).abs().max())
                          for k, p in module.named_parameters()),
        "state": max(float((r["state"][k].double() - v.double()).abs().max())
                     for r in ranks for k, v in module.state_dict().items()),
    }
    assert max(errs.values()) <= BN_TOL, errs
    for r in ranks:
        assert int(r["state"][[k for k in r["state"] if k.endswith(
            "num_batches_tracked")][0]]) == 1


@pytest.mark.parametrize("case", ["mixed", "one_rank_class"])
def test_seg_losses_match_global(session, case):
    """The ranks' shares average to the global loss, and each share's
    gradient over the world is the global loss's gradient on the block.
    With class 2 on rank 0 only, a per-rank "present" would differ."""
    logits, labels = session["seg"][case]
    ranks = [r[f"seg_{case}"] for r in session["ranks"]]
    cw = ModelConfig().seg_class_weights
    for name, fn in (("ce", lambda x: weighted_cross_entropy(
            x, torch.from_numpy(labels), cw)),
            ("lovasz", lambda x: lovasz_softmax(x, torch.from_numpy(labels)))):
        x = torch.from_numpy(logits).requires_grad_()
        want = fn(x)
        want.backward()
        got = [r[name] for r in ranks]
        mean_err = max(abs(float(r["mean"] - want)) for r in got)
        share_err = abs(float(sum(r["share"] for r in got) / WORLD - want))
        grad_err = float((torch.cat([r["grad"] for r in got]) / WORLD
                          - x.grad).abs().max())
        assert max(mean_err, share_err, grad_err) <= SEG_TOL, (
            name, mean_err, share_err, grad_err)
    if case == "one_rank_class":
        # the trap: rank 1's own labels lack class 2
        assert (labels[:GLOBAL_B // WORLD] == 2).any()
        assert not (labels[GLOBAL_B // WORLD:] == 2).any()


# -- dir_tpu's train step on the global batch --------------------------------

def _jax_step_fns(jflags):
    """dir_tpu's step as two jitted pieces: ``loss_for`` of
    dir_tpu/train/steps.py under ``jax.value_and_grad``, and its AdamW
    update; and the optimizer."""
    with x64():
        jcfg = JModelConfig(backbone_layers=LAYERS, dtype="float64",
                            **jflags)
        jmodel = JDIR(jcfg)
        ml, mr = (jax_f64(m) for m in jax_manos())

    def loss_for(params, stats, batch):
        batch = jsteps.decode_wire8(batch)
        out, upd = jmodel.apply(
            {"params": params, "batch_stats": stats}, batch["img"], ml,
            mr, train=True, mutable=["batch_stats"])
        ld = jdir_losses(out, batch, jcfg, ml.faces, mr.faces,
                         fused_stages=True)
        return jtotal_loss(ld), (upd["batch_stats"], ld)

    tx = jstate.make_optimizer(JTrainConfig(), STEPS_PER_EPOCH)

    def apply(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return (jax.jit(jax.value_and_grad(loss_for, has_aux=True)),
            jax.jit(apply), tx)


def _jax_reference(fns, variables, batches, modes):
    """dir_tpu's step on the global batches at fp64, held against the
    port's one-process step on the same batches: per mode and call the
    errors of ``step_errors`` and dir_tpu's loss dict. "steps": one step a
    batch (also what "unroll" is compared with); "grad_accum": one step
    over the batches as micro-batches (gradients averaged, statistics
    chained, the loss dict their mean), whose first gradient is the first
    step's."""
    from torch_port_parallel_worker import model_tensors, port_run

    grad_fn, apply, tx = fns
    args = {"flags": None, "steps_per_epoch": STEPS_PER_EPOCH,
            "state_dict": _state_dict(variables["params"],
                                      variables["batch_stats"])}
    out = {}
    with x64():
        p0, s0 = variables["params"], variables["batch_stats"]
        first = grad_fn(p0, s0, jax_f64(batches[0]))

        def step_of(loss_dicts, grads, stats, params):
            loss = {k: float(np.mean([float(d[k]) for d in loss_dicts]))
                    for k in loss_dicts[0]}
            return loss, {"grads": _state_dict(grads, {}),
                          "stats": _state_dict({}, stats),
                          "params": _state_dict(params, {})}

        model = None
        for mode, flags in modes:
            port = port_run(dict(args, flags=flags, step_kwargs={} if mode
                                 == "steps" else {mode: 2}), model=model)
            model = port[0]
            entries = []
            if mode == "steps":
                params, stats, opt = p0, s0, tx.init(p0)
                for i, batch in enumerate(batches):
                    (_, (stats, ld)), g = (first if i == 0 else grad_fn(
                        params, stats, jax_f64(batch)))
                    params, opt = apply(g, opt, params)
                    entries.append(step_of([ld], g, stats, params))
                calls = batches
            else:
                (_, (s1, ld1)), g1 = first
                (_, (s2, ld2)), g2 = grad_fn(p0, s1, jax_f64(batches[1]))
                g = jax.tree.map(lambda a, b: (a + b) / 2, g1, g2)
                params, _ = apply(g, tx.init(p0), p0)
                entries.append(step_of([ld1, ld2], g, s2, params))
                calls = [{k: np.stack([b[k] for b in batches])
                          for k in batches[0]}]
            out[mode] = []
            for call, (jloss, want) in zip(calls, entries):
                state, loss = port[2](port[1], call)
                lr = state.optimizer.param_groups[0]["lr"]
                out[mode].append((step_errors(
                    loss, model_tensors(port[0]), jloss, want, lr), jloss))
    return out


@pytest.mark.parametrize("decoder,mode", [("default", "steps"),
                                          ("splat", "steps"),
                                          ("default", "unroll"),
                                          ("default", "grad_accum")])
def test_train_step_matches_dir_tpu(session, decoder, mode):
    """Two ranks' train steps against dir_tpu's on the global batch, by way
    of the port's one-process step on it: rank 0 held the mesh's model
    against the one-process model after every call (the worker's
    ``step_errors``), and :func:`_jax_reference` held the one-process port
    against dir_tpu's step; the ranks' global loss dicts are held against
    dir_tpu's directly; both ranks' states are bit-identical after the
    calls. "unroll" is one call of two steps (compared after both, with
    the steps' reference), "grad_accum" one step over two micro-batches."""
    ref = session["references"][decoder]["steps" if mode == "unroll"
                                         else mode]
    if mode == "unroll":
        ref = ref[-1:]
    results = [r[f"train_{decoder}"][mode] for r in session["ranks"]]
    for i, (port_errs, jloss) in enumerate(ref):
        mesh_errs = results[0]["calls"][i]["errors"]
        loss = max(abs(r["calls"][i]["loss"][k] - v) / max(abs(v), 1e-30)
                   for r in results for k, v in jloss.items())
        print(f"{decoder} {mode} call {i}: one process vs dir_tpu "
              f"{port_errs}; two ranks vs one process {mesh_errs}; two "
              f"ranks' loss terms vs dir_tpu {loss}")
        step = i if mode == "steps" else len(ref) - 1 + (mode == "unroll")
        assert loss <= PORT_TOL[step]["loss"]
        for errs, tol in ((port_errs, PORT_TOL[step]), (mesh_errs, MESH_TOL)):
            for k, v in errs.items():
                assert v <= tol[k], (k, errs)
    assert results[0]["digest"] == results[1]["digest"]
    assert all(r["step"] == 2 if mode != "grad_accum" else r["step"] == 1
               for r in results)


def _metrics_inputs(rng):
    """A padded global batch of predictions and ground truth (3 valid rows
    of 4, so rank 1's block holds the padding)."""
    b = GLOBAL_B
    ml, mr = jax_manos()
    a = {
        "pred_verts_left": rng.randn(b, 778, 3) * 0.05,
        "pred_verts_right": rng.randn(b, 778, 3) * 0.05,
        "gt_verts_left": rng.randn(b, 778, 3) * 0.05,
        "gt_verts_right": rng.randn(b, 778, 3) * 0.05,
        "pred_offset": rng.randn(b, 3) * 0.1,
        "pd_joints_left": rng.randn(b, 21, 3) * 0.05,
        "pd_joints_right": rng.randn(b, 21, 3) * 0.05,
        "gt_joints_left": rng.randn(b, 21, 3) * 0.05,
        "gt_joints_right": rng.randn(b, 21, 3) * 0.05,
        "camera": np.tile(np.array([[500.0, 0, 32], [0, 500.0, 32],
                                    [0, 0, 1]]), (b, 1, 1)),
    }
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a["gt_verts_left"][:, :, 2] += 0.6
    a["gt_verts_right"][:, :, 2] += 0.6
    jregs = [np.asarray(jevaluate.extended_j_regressor(m), np.float32)
             for m in (ml, mr)]
    return {"arrays": a, "n_valid": 3, "jregs": jregs}


def test_sharded_metrics_match_dir_tpu(session):
    """The ranks' accumulator sums of a padded batch against dir_tpu's
    ``batch_metrics`` and ``online_batch_metrics`` on the whole batch."""
    m = session["metrics"]
    a = {k: jnp.asarray(v) for k, v in m["arrays"].items()}
    valid = jnp.asarray(np.arange(GLOBAL_B) < m["n_valid"], jnp.float32)
    want = {
        "benchmark": jevaluate.batch_metrics(
            a["pred_verts_left"], a["pred_verts_right"], a["pred_offset"],
            a["gt_verts_left"], a["gt_verts_right"], a["camera"],
            jnp.asarray(m["jregs"][0]), jnp.asarray(m["jregs"][1]), valid),
        "online": jevaluate.online_batch_metrics(
            a["pd_joints_left"], a["pd_joints_right"], a["pred_verts_left"],
            a["pred_verts_right"], a["gt_joints_left"], a["gt_joints_right"],
            a["gt_verts_left"], a["gt_verts_right"], valid)}
    for r in session["ranks"]:
        for kind, w in want.items():
            got = r["metrics"][kind]
            assert sorted(got) == sorted(w)
            assert got["count"] == m["n_valid"]
            for k, v in w.items():
                np.testing.assert_allclose(got[k], float(v), rtol=1e-5,
                                           err_msg=f"{kind} {k}")
