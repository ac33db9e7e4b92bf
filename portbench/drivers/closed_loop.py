"""One caller in a closed loop over ``serve.make_infer``'s callable: it
hands over a host float32 batch, waits until the final stage's joints and
meshes are in host memory, and sends the next. An offline evaluator at a
large batch, or one user's requests at batch 1.

Traffic parameters (``portbench/traffic/<mix>.json``): ``batch``; ``pool``,
the number of distinct seeded host batches cycled through; ``pinned``,
batches in page-locked host memory, as a loader that pins them hands them
over (pageable numpy arrays without it); ``metric``,
``"img_per_s"`` (images read back over the whole window) or
``"p95_ms"`` (the 95th percentile of all the window's request times);
``trace_units``, the calls in the profiled slice; ``compare``, how many
calls the check samples from the seed (``compare_from``: among the first
that many calls).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from portbench import build, harness
from portbench.reference import compare

FINAL = compare.POINTS


def images(run: harness.Run, n: int, batch: int | None = None) -> list:
    """``n`` seeded host batches (float32, NHWC) of ``batch`` images (the
    traffic's by default), drawn on the device in one call: page-locked
    tensors where the traffic is ``pinned`` and the device a card, else
    pageable numpy arrays."""
    batch = run.traffic["batch"] if batch is None else batch
    size = run.cfg["image_size"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed + 2)
    x = torch.randn((n, batch, size, size, 3), generator=gen,
                    device=run.device)
    if run.traffic.get("pinned") and run.device.type == "cuda":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return list(host.unbind(0))
    return [b.numpy() for b in x.cpu().unbind(0)]


def setup(run: harness.Run):
    """The seeded reference, and the program's model and callable on the
    same weights and hands."""
    from dir_tpu_torch import serve

    ref, hands, pair = build.seeded_reference(run.cfg, run.seed, run.device)
    model, _ = build.program_model(run.cfg, ref.state_dict(), run.device,
                                   **run.traffic.get("program", {}))
    ml, mr = build.program_mano(hands, run.device)
    return ref, pair, model, serve.make_infer(model, ml, mr)


def sampled(run: harness.Run) -> set:
    t = run.traffic
    rng = np.random.default_rng(run.seed)
    return set(rng.choice(t["compare_from"], t["compare"],
                          replace=False).tolist())


def run_cell(run: harness.Run, infer_fault=None) -> dict:
    """Run the cell; ``infer_fault(infer, ref, pair)`` replaces the
    program's callable (the control, the tests' faults)."""
    t = run.traffic
    began = time.perf_counter()
    ref, pair, model, infer = setup(run)
    built = time.perf_counter()
    if infer_fault is not None:
        infer = infer_fault(infer, ref, pair)
    pool = images(run, t["pool"])
    keep = sampled(run)

    def call(img):
        with harness.span("infer"):
            out = infer(img)
        with harness.span("readback"):
            host = {k: out["stages"][-1][k].cpu() for k in FINAL}
        return out, host

    made = time.perf_counter()
    for i in range(t.get("warmup", 3)):
        call(pool[i % len(pool)])
    start = run.window_opens()
    harness.say(f"set-up {run.setup_s:.3f} s: models {built - began:.3f}, "
                f"inputs {made - built:.3f}, warm-up {start - made:.3f}")
    times, kept = [], {}
    prof, slice_at, slice_end, slice_s, n = None, None, None, 0.0, 0
    with contextlib.ExitStack() as stack:
        while True:
            if (run.trace and slice_at is None
                    and time.perf_counter() - start >= 0.3 * run.seconds):
                slice_at, slice_t = n, time.perf_counter()
                prof = stack.enter_context(harness.profiled(run))
            t0 = time.perf_counter()
            out, host = call(pool[n % len(pool)])
            times.append(time.perf_counter() - t0)
            if n in keep:
                kept[n] = (out, host)
            n += 1
            if slice_at is not None and slice_end is None and (
                    n == slice_at + t["trace_units"]
                    or time.perf_counter() - start >= run.seconds):
                stack.close()
                slice_end, slice_s = n, time.perf_counter() - slice_t
            if time.perf_counter() - start >= run.seconds:
                break
    elapsed = time.perf_counter() - start
    memory = (torch.cuda.max_memory_allocated(run.device)
              if run.device.type == "cuda" else 0)
    e2e = {t["reports"]: n * t["batch"] / elapsed
           if t["metric"] == "img_per_s"
           else float(np.percentile(times, 95)) * 1e3}
    harness.say(f"{n} calls of {t['batch']} in {elapsed:.3f} s; median "
                f"{statistics.median(times) * 1e3:.3f} ms, p95 "
                f"{np.percentile(times, 95) * 1e3:.3f} ms")
    # the check, once the window has closed and the program's state is
    # freed
    got_in = sorted(kept)
    # the profiled slice runs slower; the rates of the per-layer metrics
    # are of the rest of the window
    sliced = 0 if slice_at is None else slice_end - slice_at
    trace = None if prof is None else harness.Trace(prof, sliced)
    found = {"trace": trace, "run": run, "units": sliced,
             "flops": "forward",
             "images": (n - sliced) * t["batch"],
             "elapsed_s": elapsed - slice_s,
             "unit_wall_s": (elapsed - slice_s) / max(n - sliced, 1)}
    result = {"e2e": e2e, "attempted": n, "failed": 0, "memory": memory,
              "trace": trace, "found": found}
    del model, infer, call
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    if not got_in:
        raise RuntimeError("no sampled call completed in the window")
    got = compare.cat_outputs([
        {"stages": [dict({k: v.cpu() for k, v in s.items()},
                         **(kept[i][1] if j == len(kept[i][0]["stages"]) - 1
                            else {}))
                    for j, s in enumerate(kept[i][0]["stages"])],
         "seg": kept[i][0]["seg"].cpu(), "dense": kept[i][0]["dense"].cpu()}
        for i in got_in])
    del kept
    inputs = torch.cat([torch.as_tensor(pool[i % len(pool)])
                        for i in got_in])
    want = compare.reference_outputs(ref, pair, inputs)
    result["numbers"] = compare.serving_numbers(got, want)
    return result
