"""The Trainer's step (``train/steps.make_train_step``) in a loop: each step
gets a fresh host batch in the uint8 wire format that ``decode_wire8``
decodes, cycled from a seeded pool made at set-up.

Set-up builds one trainer, the model with its AdamW state, and drives it
through its first ``checked_steps`` steps through the same call and feed
as the window, on batches whose rows all differ; the window then goes on
with the same object. The plain reference follows those first steps from
the same weights on the same batches, and the check compares each step's
loss, the first gradient as the optimizer got it (worked out from its
first moment after one step), and the parameters' change after the steps.
The first step's update is also held to the AdamW that the configuration
states, worked out from the optimizer's own moments after that step.

Traffic parameters: ``batch``, ``pool`` (distinct host batches),
``checked_steps``, ``trace_units`` (steps in the profiled slice).
"""

from __future__ import annotations

import contextlib
import statistics
import time
import warnings

import torch

from portbench import build, harness
from portbench.reference import compare, losses as ref_losses


def wire_batches(run: harness.Run, n: int) -> list:
    """``n`` seeded host batches of the wire format: uint8 images, seg and
    dense, float32 targets drawn as ``dir_tpu_torch/bench.py:train_batch``
    draws them; made on the device in a few calls, then moved to the
    host."""
    b, size = run.traffic["batch"], run.cfg["image_size"]
    dev = run.device
    gen = torch.Generator(device=dev).manual_seed(run.seed + 3)

    def rn(*shape, scale=1.0):
        return torch.randn((n, b) + shape, generator=gen, device=dev) * scale

    def ri(high, *shape):
        return torch.randint(0, high, (n, b) + shape, generator=gen,
                             device=dev, dtype=torch.uint8)

    arrays = {"img": ri(256, size, size, 3)}
    for side in ("left", "right"):
        arrays[f"joint_2d_{side}"] = rn(21, 3)
        arrays[f"mesh_2d_{side}"] = rn(778, 3)
        arrays[f"joint_3d_{side}"] = rn(21, 3, scale=0.1)
        arrays[f"mesh_3d_{side}"] = rn(778, 3, scale=0.1)
        arrays[f"center_{side}"] = rn(1, 3, scale=0.1)
    arrays["seg"] = ri(3, size, size)
    arrays["dense"] = ri(256, size, size, 3)
    host = {k: v.cpu().numpy() for k, v in arrays.items()}
    return [{k: v[i] for k, v in host.items()} for i in range(n)]


def step1_gaps(start: dict, params: dict, moments: dict, o: dict) -> dict:
    """Per leaf, how far the first step's change of the parameters lies
    from the AdamW update that the configuration states (``o``: lr, betas,
    eps, weight decay), worked out from the first and second moments the
    optimizer holds after that step: the norm of the difference over the
    larger of the update's norm and the median leaf's. It follows the
    trainer's own state, so sound arithmetic meets it to rounding whatever
    the gradient; a leaf left unmoved reads about 1, one moved twice too."""
    b1, b2 = o["betas"]
    names = list(moments)
    diff, size = [], []
    with torch.no_grad():
        for n in names:
            m, v = moments[n]
            p0 = start[n].float()
            want = -o["lr"] * (o["weight_decay"] * p0 + (m / (1 - b1)) / (
                (v / (1 - b2)).sqrt() + o["eps"]))
            diff.append((params[n].detach().float() - p0 - want).norm())
            size.append(want.norm())
    diff = torch.stack(diff).cpu().tolist()
    size = torch.stack(size).cpu().tolist()
    median = statistics.median(size)
    return {n: d / max(s, median) for n, d, s in zip(names, diff, size)}


def leaf_norms(tensors: dict) -> dict:
    names = list(tensors)
    norms = torch.stack([tensors[k].detach().float().norm() for k in names])
    return dict(zip(names, norms.cpu().tolist()))


class ProgramTrainer:
    """The program's train step on the seeded weights."""

    def __init__(self, run: harness.Run, state: dict, hands: dict,
                 half_batch: bool = False, frozen: bool = False):
        from dir_tpu_torch.config import TrainConfig
        from dir_tpu_torch.train.state import (create_train_state,
                                               make_optimizer)
        from dir_tpu_torch.train.steps import make_train_step

        o = run.cfg["optimizer"]
        self.model, mcfg = build.program_model(run.cfg, state, run.device)
        ml, mr = build.program_mano(hands, run.device)
        self.opt = make_optimizer(self.model, TrainConfig(
            lr=o["lr"], weight_decay=o["weight_decay"]), steps_per_epoch=1000)
        self.state = create_train_state(self.model, self.opt)
        self.fn = make_train_step(self.model, self.opt, mcfg, ml, mr,
                                  device=run.device)
        self.beta1 = o["betas"][0]
        self.half_batch, self.frozen = half_batch, frozen

    def step(self, batch: dict) -> torch.Tensor:
        if self.half_batch:        # a fault: the mean over half the rows
            batch = {k: v[:len(v) // 2] for k, v in batch.items()}
        if self.frozen:            # a fault: the state returned unchanged
            saved = {k: v.clone() for k, v in self.model.state_dict().items()}
        self.state, loss = self.fn(self.state, batch)
        if self.frozen:
            self.model.load_state_dict(saved)
        return sum(loss.values())

    def first_gradient(self) -> dict:
        """The gradient of the first step, from AdamW's first moment."""
        return {n: self.opt.state[p]["exp_avg"] / (1 - self.beta1)
                for n, p in self.model.named_parameters()
                if p in self.opt.state}

    def moments(self) -> dict:
        return {n: (self.opt.state[p]["exp_avg"],
                    self.opt.state[p]["exp_avg_sq"])
                for n, p in self.model.named_parameters()
                if p in self.opt.state}

    def parameters(self) -> dict:
        return dict(self.model.named_parameters())


class ReferenceTrainer:
    """The plain reference's step: forward, loss, backward, AdamW; with a
    lower precision's ``round_``, the control."""

    def __init__(self, run: harness.Run, model, pair: dict):
        o = run.cfg["optimizer"]
        self.run, self.model, self.pair = run, model, pair
        self.opt = ref_losses.AdamW(model.parameters(), o["lr"],
                                    tuple(o["betas"]), o["eps"],
                                    o["weight_decay"])

    def step(self, batch: dict) -> torch.Tensor:
        self.model.train()
        self.model.zero_grad(set_to_none=True)
        t = ref_losses.decode(batch, self.run.device)
        with compare.no_tf32():
            loss = sum(ref_losses.dir_losses(
                self.model(t["img"], self.pair), t, self.run.cfg,
                self.pair).values())
            loss.backward()
        self.opt.step()
        return loss.detach()

    def first_gradient(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        return {n: m / (1 - self.opt.b1) for n, m in zip(names, self.opt.m)}

    def moments(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        return dict(zip(names, zip(self.opt.m, self.opt.v)))

    def parameters(self) -> dict:
        return dict(self.model.named_parameters())


def readings(trainer, batches: list, start: dict, o: dict) -> dict:
    """Drive ``trainer`` through ``batches``: each step's loss, the first
    gradient's norm by leaf, the first step's gaps to AdamW
    (:func:`step1_gaps`, ``o`` the configuration's optimizer), and the
    change of each parameter from ``start`` after the last step."""
    out = {"loss": []}
    for i, b in enumerate(batches):
        out["loss"].append(float(trainer.step(b)))
        if i == 0:
            out["grad"] = leaf_norms(trainer.first_gradient())
            out["step1"] = step1_gaps(start, trainer.parameters(),
                                      trainer.moments(), o)
    params = trainer.parameters()
    out["change"] = leaf_norms({k: params[k].detach() - start[k]
                                for k in params})
    return out


def _gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in want if keep is None or k in keep]
    median = statistics.median(want[k] for k in names)
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], median)
            for k in names}


def numbers(got: dict, want: dict) -> dict:
    """The readings: each step's loss as a share of the reference's; the
    first gradient and the change by the worst leaf and by the median
    leaf's gap (:func:`_gaps`); the program's first update against AdamW
    by its worst leaf (:func:`step1_gaps`). Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the gradient and the change: their gradient is nought to rounding (a
    bias before a train-mode BatchNorm), and Adam moves them by round-off
    alone."""
    out = {f"loss.s{i + 1}": abs(g - w) / abs(w)
           for i, (g, w) in enumerate(zip(got["loss"], want["loss"]))}
    gmed = statistics.median(want["grad"].values())
    moving = {k for k, v in want["grad"].items() if v >= 1e-3 * gmed}
    for what in ("grad", "change"):
        gaps = _gaps(got[what], want[what], moving)
        worst = max(gaps, key=gaps.get)
        harness.say(f"{what}: worst leaf {worst} {got[what].get(worst)!r} "
                    f"against {want[what][worst]!r}")
        out[f"{what}.worst"] = gaps[worst]
        out[f"{what}.median"] = statistics.median(gaps.values())
    worst = max(got["step1"], key=got["step1"].get)
    harness.say(f"adamw.step1: worst leaf {worst}")
    out["adamw.step1"] = got["step1"][worst]
    return {k: (v if v == v else float("inf")) for k, v in out.items()}


def sync_count(fn, dev) -> int:
    """Host synchronisations of one call of ``fn`` under CUDA's sync
    debug mode."""
    count = [0]

    def record(message, *args, **kwargs):
        if "synchroniz" in str(message):
            count[0] += 1

    torch.cuda.synchronize(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    return count[0]


def run_cell(run: harness.Run, trainer_fault=None) -> dict:
    """Run the cell; ``trainer_fault`` (keyword arguments of
    :class:`ProgramTrainer`, or a callable making the trainer from the run,
    the start state, the hands and the reference) breaks the timed path
    for the tests."""
    t = run.traffic
    ref, hands, pair = build.seeded_reference(run.cfg, run.seed, run.device)
    start = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    if callable(trainer_fault):
        prog = trainer_fault(run, start, hands, ref, pair)
    else:
        prog = ProgramTrainer(run, start, hands, **(trainer_fault or {}))
    pool = wire_batches(run, t["pool"])
    k = t["checked_steps"]
    o = run.cfg["optimizer"]
    got = readings(prog, pool[:k], start, o)       # the set-up's steps
    begin = run.window_opens()
    steps, prof, slice_at, slice_end, slice_s = 0, None, None, None, 0.0
    with contextlib.ExitStack() as stack:
        while True:
            if (run.trace and slice_at is None
                    and time.perf_counter() - begin >= 0.3 * run.seconds):
                slice_at, slice_t = steps, time.perf_counter()
                prof = stack.enter_context(harness.profiled(run))
            with harness.span("step"):
                prog.step(pool[(k + steps) % len(pool)])
            steps += 1
            if slice_at is not None and slice_end is None and (
                    steps == slice_at + t["trace_units"]
                    or time.perf_counter() - begin >= run.seconds):
                stack.close()
                slice_end, slice_s = steps, time.perf_counter() - slice_t
            if time.perf_counter() - begin >= run.seconds:
                run.sync()
                if time.perf_counter() - begin >= run.seconds:
                    break
    elapsed = time.perf_counter() - begin
    memory = (torch.cuda.max_memory_allocated(run.device)
              if run.device.type == "cuda" else 0)
    counters = {}
    if run.trace and run.device.type == "cuda":
        counters["host_syncs_per_step"] = sync_count(
            lambda: prog.step(pool[0]), run.device)
    harness.say(f"{steps} steps of {t['batch']} in {elapsed:.3f} s "
                f"({elapsed / max(steps, 1) * 1e3:.3f} ms a step); losses "
                f"{got['loss']}")
    sliced = 0 if slice_at is None else slice_end - slice_at
    trace = None if prof is None else harness.Trace(prof, sliced)
    found = {"trace": trace, "run": run, "units": sliced,
             "flops": "train_step",
             "images": (steps - sliced) * t["batch"],
             "elapsed_s": elapsed - slice_s,
             "unit_wall_s": (elapsed - slice_s) / max(steps - sliced, 1),
             "counters": counters}
    result = {"e2e": {t["reports"]: steps * t["batch"] / elapsed},
              "attempted": steps, "failed": 0, "memory": memory,
              "trace": trace, "found": found}
    del prog
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    # the reference follows the checked steps from the same start
    ref.load_state_dict(start)
    want = readings(ReferenceTrainer(run, ref, pair), pool[:k], start, o)
    ref.load_state_dict(start)
    result["numbers"] = numbers(got, want)
    return result
