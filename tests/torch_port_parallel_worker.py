"""Rank processes of the port's data-parallel tests
(tests/test_torch_port_parallel.py). Imports no JAX.

:func:`run_ranks` (called by the tests) writes a job file and starts one
process a rank, ``python tests/torch_port_parallel_worker.py <job> <rank>
<world> <port> <out>``: each joins a gloo group of CPU ranks on a local
port with a bounded collective timeout, runs the job's tasks on its block
of the global inputs and saves what it computed; the caller waits a bounded
time, kills the ranks' sessions if it runs out, and returns every rank's
results in rank order.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

LAYERS = (1, 1, 1, 1)
# seconds a collective may wait, and the default for a whole session
COLLECTIVE_TIMEOUT = 300
SESSION_TIMEOUT = 900


def start_ranks(tasks: list, world: int, work_dir: str,
                threads: int = 1, state_dicts: dict | None = None,
                device: str = "cpu") -> list:
    """Start ``world`` gloo ranks on ``device`` ("cuda": every rank on this
    host's card(s)) running ``tasks`` (a list of ``(name, kind, args)``);
    returns the processes and their result files, for :func:`wait_ranks`.
    ``state_dicts``: model weights that tasks name by key
    (``args["state_dict_of"]``), written once."""
    os.makedirs(work_dir, exist_ok=True)
    job = os.path.join(work_dir, "job.pt")
    torch.save({"tasks": tasks, "threads": threads, "device": device,
                "state_dicts": state_dicts or {}}, job)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    outs = [os.path.join(work_dir, f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), outs[r]], env=env, start_new_session=True)
        for r in range(world)]
    return procs, outs


def wait_ranks(started, timeout: float = SESSION_TIMEOUT) -> list:
    """Wait for :func:`start_ranks`' processes, at most ``timeout`` seconds
    from now, killing their sessions if they outlive it; returns each
    rank's ``{name: result}`` in rank order."""
    procs, outs = started
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited with {codes}")
    return [torch.load(o, weights_only=False) for o in outs]


def run_ranks(tasks: list, world: int, work_dir: str,
              timeout: float = SESSION_TIMEOUT, **kw) -> list:
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(tasks, world, work_dir, **kw), timeout)


# -- tasks (in the rank processes) ---------------------------------------

def port_manos(dtype):
    from dir_tpu_torch.mano.assets import ManoModel
    from dir_tpu_torch.serve import flagship_mano
    return tuple(ManoModel(*(t.to(dtype) if t.is_floating_point() else t
                             for t in m))
                 for m in flagship_mano("/nonexistent"))


def _module_state(m: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


def bn_task(mesh, args):
    """One BN form on this rank's block: the output, the input's gradient,
    the parameters' gradients (this rank's part) and the module's state
    after the step. The objective is ``sum(out * g)`` with ``g`` the given
    upstream gradient."""
    from dir_tpu_torch.models.layers import (BatchNorm1d, BatchNorm2d,
                                             Residual, bn_tokens)
    from dir_tpu_torch.parallel.mesh import replicate, shard_batch

    kind = args["kind"]
    c = args["channels"]
    module = {"2d": lambda: BatchNorm2d(c), "1d": lambda: BatchNorm1d(c),
              "tokens": lambda: BatchNorm1d(c),
              "pair": lambda: Residual(c, c, dtype=torch.float64)}[kind]()
    module = module.double()
    module.load_state_dict(args["state"])
    module.train()
    replicate(module, mesh)
    fmt = (torch.channels_last if kind == "2d"
           else torch.contiguous_format)
    xs = [shard_batch(torch.from_numpy(x), mesh).contiguous(
        memory_format=fmt).requires_grad_() for x in args["inputs"]]
    g = shard_batch(torch.from_numpy(args["grad"]), mesh)
    if kind == "tokens":
        out = bn_tokens(xs[0], module)
    elif kind == "pair":
        out = module(xs[0], xs[1])
    else:
        out = module(xs[0])
    torch.sum(out * g).backward()
    return {"out": out.detach(), "input_grads": [x.grad for x in xs],
            "param_grads": {k: p.grad.clone()
                            for k, p in module.named_parameters()},
            "state": _module_state(module)}


def seg_task(mesh, args):
    """The weighted cross-entropy's and Lovász-softmax's shares on this
    rank's block, their mean over the ranks, and each share's gradient
    with respect to the block's logits."""
    from dir_tpu_torch.models.losses import (lovasz_softmax,
                                             weighted_cross_entropy)
    from dir_tpu_torch.parallel.mesh import shard_batch

    labels = shard_batch(torch.from_numpy(args["labels"]), mesh)
    out = {}
    for name, fn in (("ce", lambda x: weighted_cross_entropy(
            x, labels, args["class_weights"], mesh)),
            ("lovasz", lambda x: lovasz_softmax(x, labels, mesh))):
        logits = shard_batch(torch.from_numpy(args["logits"]),
                             mesh).requires_grad_()
        share = fn(logits)
        share.backward()
        out[name] = {"share": share.detach(),
                     "mean": mesh.sum(share.detach()) / mesh.world,
                     "grad": logits.grad}
    return out


def port_run(args, mesh=None, model=None):
    """The tiny DIR at fp64 on ``args["state_dict"]`` (``model`` if given,
    reloaded), its optimizer and the port's train step (on ``mesh``, or one
    process on the CPU); returns ``(model, state, step)``."""
    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.train import state as tstate
    from dir_tpu_torch.train import steps as tsteps

    if model is None:
        model = DIR(ModelConfig(backbone_layers=LAYERS, dtype="float64",
                                **args["flags"])).double()
    model.load_state_dict({k: v.double() if v.is_floating_point() else v
                           for k, v in args["state_dict"].items()},
                          strict=True)
    model.zero_grad(set_to_none=True)
    ml, mr = port_manos(torch.float64)
    opt = tstate.make_optimizer(model, TrainConfig(), args["steps_per_epoch"])
    state = tstate.create_train_state(model, opt)
    step = tsteps.make_train_step(model, opt, model.cfg, ml, mr,
                                  device="cpu", mesh=mesh,
                                  **args.get("step_kwargs", {}))
    return model, state, step


def model_tensors(model: torch.nn.Module) -> dict:
    """A model's gradients, floating-point buffers and parameters, as the
    dicts :func:`step_errors` compares."""
    return {"grads": {k: p.grad for k, p in model.named_parameters()},
            "stats": {k: b for k, b in model.named_buffers()
                      if b.is_floating_point()},
            "params": dict(model.named_parameters())}


def step_errors(loss: dict, got: dict, ref_loss: dict, ref: dict,
                lr: float) -> dict:
    """One step's result against a reference's (dicts of
    :func:`model_tensors`' layout; ``ref`` may hold fewer statistics): the
    worst relative loss term, gradient leaf by relative L2 norm (the graph
    convs' edge scores, whose gradient both packages take through an fp32
    softmax, apart as ``edge_grad``; leaves zero in exact arithmetic left
    out), BN statistic of each tensor's max, and parameter in units of
    ``lr``. A parameter without a gradient on one side has none on the
    other."""
    with torch.no_grad():
        return _step_errors(loss, got, ref_loss, ref, lr)


def _step_errors(loss, got, ref_loss, ref, lr) -> dict:
    errs = dict.fromkeys(("loss", "grad", "edge_grad", "stats", "param"),
                         0.0)
    assert sorted(loss) == sorted(ref_loss)
    for k, v in ref_loss.items():
        errs["loss"] = max(errs["loss"], abs(float(loss[k]) - float(v))
                           / max(abs(float(v)), 1e-30))
    for k, w in ref["grads"].items():
        g = got["grads"][k]
        if g is None or w is None:
            nonzero = w if g is None else g
            if nonzero is not None and float(nonzero.norm()) != 0.0:
                raise AssertionError(f"{k}: a gradient on one side only")
            continue
        norm = float(w.norm())
        if norm < 1e-12 and float(g.norm()) < 1e-12:
            continue
        kind = "edge_grad" if k.endswith((".e_0", ".e_1")) else "grad"
        errs[kind] = max(errs[kind], float((g - w).norm()) / norm)
    for k, w in ref["stats"].items():
        errs["stats"] = max(errs["stats"], float(
            (got["stats"][k] - w).abs().max() / w.abs().max()))
    for k, w in ref["params"].items():
        errs["param"] = max(errs["param"],
                            float((got["params"][k] - w).abs().max()) / lr)
    return errs


def digest(model: torch.nn.Module) -> str:
    """A hash of every parameter's and buffer's bytes, in ``state_dict``
    order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().reshape(-1).contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def train_task(mesh, args):
    """The port's train step on the tiny DIR at fp64 over the global
    batches on the mesh, in each of ``args["modes"]``: "steps" (one step a
    batch), "unroll" (one call of ``unroll=2`` over the stacked batches),
    "grad_accum" (one step over them as two micro-batches). Per mode, after
    each call: the global loss dict, and on rank 0 the errors of the mesh's
    model against one process running the same steps on the global batch
    (:func:`step_errors`); the hash of the final state."""
    from dir_tpu_torch.parallel.mesh import shard_batch

    batches = args["batches"]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    lead = mesh.rank == 0
    out = {}
    steps_ref = port_run(args) if lead else None
    steps_losses = []
    model = None
    for mode in args["modes"]:
        kw = {} if mode == "steps" else {mode: 2}
        model, state, step = port_run(dict(args, step_kwargs=kw), mesh,
                                      model)
        if mode == "grad_accum" and lead:
            # the steps' reference model is done with: it runs this one
            ref = port_run(dict(args, step_kwargs=kw), model=steps_ref[0])
        else:
            ref = steps_ref
        calls = batches if mode == "steps" else [stacked]
        entries = []
        for call in calls:
            state, loss = step(state, shard_batch(
                call, mesh, leading_steps=mode != "steps"))
            entry = {"loss": {k: float(v) for k, v in loss.items()}}
            if lead:
                lr = state.optimizer.param_groups[0]["lr"]
                if mode == "unroll":
                    # the one-process steps' model and second loss dict
                    ref_loss = steps_losses[-1]
                else:
                    _, ref_loss = ref[2](ref[1], call)
                    if mode == "steps":
                        steps_losses.append(ref_loss)
                entry["errors"] = step_errors(
                    loss, model_tensors(model), ref_loss,
                    model_tensors(ref[0]), lr)
            entries.append(entry)
        out[mode] = {"calls": entries, "step": state.step,
                     "digest": digest(model)}
    return out


def metrics_task(mesh, args):
    """``batch_metrics`` and ``online_batch_metrics`` on this rank's block
    of a padded global batch, summed over the ranks."""
    from dir_tpu_torch.mano.assets import ManoModel  # noqa: F401
    from dir_tpu_torch.parallel.mesh import shard_batch
    from dir_tpu_torch.train import evaluate

    a = shard_batch({k: torch.from_numpy(v) for k, v in args["arrays"].items()},
                    mesh)
    b = a["pred_verts_left"].shape[0]
    valid = evaluate.valid_rows(args["n_valid"], b, "cpu", mesh)
    jreg = [torch.from_numpy(j) for j in args["jregs"]]
    bench = evaluate.batch_metrics(
        a["pred_verts_left"], a["pred_verts_right"], a["pred_offset"],
        a["gt_verts_left"], a["gt_verts_right"], a["camera"], jreg[0],
        jreg[1], valid)
    online = evaluate.online_batch_metrics(
        a["pd_joints_left"], a["pd_joints_right"], a["pred_verts_left"],
        a["pred_verts_right"], a["gt_joints_left"], a["gt_joints_right"],
        a["gt_verts_left"], a["gt_verts_right"], valid)
    return {"benchmark": evaluate.global_sums(bench, mesh),
            "online": evaluate.global_sums(online, mesh)}


def trainer_task(mesh, args):
    """The Trainer on this rank's block: one epoch (each step's total loss
    and the in-loop summary), then a Trainer resumed from ``latest`` for a
    second epoch; the files this rank wrote with ``torch.save``, and the
    hash of the final state."""
    import dataclasses

    from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano
    from dir_tpu_torch.train.trainer import Trainer

    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    cfg = args["cfg"]
    written = []
    real_save = torch.save

    def counting_save(obj, f, *a, **kw):
        written.append(str(f))
        return real_save(obj, f, *a, **kw)

    def run(cfg):
        trainer = Trainer(cfg, left, right, mesh=mesh)
        trainer.make_data()
        trainer.make_model(init_state_dict=args["state_dict"])
        losses, summaries = [], []
        step, evaluate_ = trainer.train_step, trainer.evaluate

        def recording_step(state, batch):
            state, loss_dict = step(state, batch)
            losses.append(float(sum(torch.stack(
                list(loss_dict.values())).double().tolist())))
            return state, loss_dict

        def recording_evaluate(*a, **kw):
            summaries.append(evaluate_(*a, **kw))
            return summaries[-1]

        trainer.train_step = recording_step
        trainer.evaluate = recording_evaluate
        start = (trainer.start_epoch, trainer.state.step, trainer.best)
        best = trainer.train()
        return {"losses": losses, "summaries": summaries, "best": best,
                "start": start, "step": trainer.state.step,
                "digest": digest(trainer.model)}

    torch.save = counting_save
    try:
        first = run(cfg)
        resumed = run(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, continue_train=True, total_epochs=2,
            checkpoint=os.path.join(cfg.train.output_dir, "checkpoint"))))
    finally:
        torch.save = real_save
    return {"first": first, "resumed": resumed, "written": written,
            "digest": resumed["digest"]}


def sync_bn_task(mesh, args):
    """The port's global BatchNorm against ``nn.SyncBatchNorm`` on the same
    block of a global fp32 batch, on the mesh's device: the worst
    differences of the outputs, the input's and the parameters' gradients
    and the running statistics, each over the reference's max |value|."""
    from dir_tpu_torch.models.layers import BatchNorm2d
    from dir_tpu_torch.parallel.mesh import replicate, shard_batch

    c = args["channels"]
    ours = BatchNorm2d(c).to(mesh.device)
    theirs = torch.nn.SyncBatchNorm(c, process_group=mesh.group).to(
        mesh.device)
    runs = []
    replicate(ours, mesh)
    for module in (ours, theirs):
        module.load_state_dict(args["state"])
        module.train()
        x = shard_batch(torch.from_numpy(args["x"]), mesh).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        out = module(x)
        torch.sum(out * shard_batch(torch.from_numpy(args["grad"]),
                                    mesh)).backward()
        runs.append({"out": out.detach(), "input_grad": x.grad,
                     "weight_grad": module.weight.grad,
                     "bias_grad": module.bias.grad,
                     "running_mean": module.running_mean,
                     "running_var": module.running_var})
    return {k: float((runs[0][k] - v).abs().max() / v.abs().max())
            for k, v in runs[1].items()}


TASKS = {"bn": bn_task, "seg": seg_task, "train": train_task,
         "metrics": metrics_task, "trainer": trainer_task,
         "sync_bn": sync_bn_task}


def main(job_path: str, rank: int, world: int, port: int,
         out_path: str) -> None:
    job = torch.load(job_path, weights_only=False)
    torch.set_num_threads(job["threads"])
    import torch.distributed as dist

    from dir_tpu_torch.parallel import mesh as pmesh

    device = job["device"]
    pmesh.init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           device=device, timeout=COLLECTIVE_TIMEOUT)
    try:
        mesh = pmesh.make_mesh(world, device=device)
        results = {}
        for name, kind, args in job["tasks"]:
            if "state_dict_of" in args:
                args = dict(args, state_dict=job["state_dicts"][
                    args["state_dict_of"]])
            results[name] = TASKS[kind](mesh, args)
        torch.save(results, out_path)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
