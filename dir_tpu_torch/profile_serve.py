"""Where one serving request's, or one train step's, time goes on the card.

Builds the bf16 flagship (seeded random weights, fused bottleneck on) in
configuration A (the default: factored splat conv), B (``--config B``:
fused bottleneck at layer2 too, materialized bone splat through its
kernel) or C (``--config C``: int8 static serving with the fused int8
bottleneck, calibrated here on 8 seeded images), warms it up, then traces
one request at each of batch 1, 8 and 64 (``--batches``; 256 is
``tools/profile_eval.py``'s and ``bench.py``'s batch) with
``torch.profiler`` and prints, per batch, one JSON line: the request's
wall time, the device's busy time and idle share over it, the number of
kernel launches, the 15 kernels that take the most device time, and the
host time inside each of the program's spans (``host_ms_by_span``: the
serving call's upload and forward and the model's modules, or the train
step's phases; ``utils/profiling.py``, the profiler's cost included); the
card's name and power limit come first. ``--config T`` traces one AdamW
step of configuration T instead (B's decoder flags, so K5 runs in the
forward; bench.py:bench_train's seeded batch of 64) and adds the step's
peak memory; the traced step is a replay of the step's CUDA graph (its
warm-up calls ran eager, then captured), so its host time by span is
``train.upload`` and ``train.replay``, not the eager phases. Run from the repository root on a machine with a CUDA device:

    python -m dir_tpu_torch.profile_serve [--config {A,B,C,T}] \
        [--batches 1,8,64]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dir_tpu_torch.bench import card
from dir_tpu_torch.serve import (CONFIG_B, CONFIG_C, build_flagship,
                                 calibrate_static_scales, condition_random_,
                                 make_infer)
from dir_tpu_torch.utils.profiling import device_events, host_ms

BATCHES = "1,8,64"
TOP = 15


def busy_us(events) -> float:
    """Union of the device kernels' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def train_batch(b: int, seed: int = 0, device="cuda") -> dict:
    """bench.py:bench_train's seeded synthetic batch, on ``device``."""
    from dir_tpu_torch.bench import train_batch as arrays

    return {k: torch.from_numpy(v).to(device)
            for k, v in arrays(b, seed).items()}


def profile_train_step(batch: int = 64) -> dict:
    """One traced AdamW step of configuration T (weights conditioned as
    chip_smoke.py's) after three warm-up steps on the same batch: eager,
    capture and replay, replay; the traced step replays the graph."""
    from dir_tpu_torch.config import TrainConfig
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    model, cfg, mano_l, mano_r = build_flagship(device="cuda", seed=0,
                                                **CONFIG_B)
    condition_random_(model, mano_l, mano_r, seed=0)
    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, cfg, mano_l, mano_r)
    data = train_batch(batch)
    torch.cuda.reset_peak_memory_stats()
    out = profile_request(lambda img: step(state, dict(data, img=img)),
                          data["img"])
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def profile_request(infer, img) -> dict:
    for _ in range(3):
        infer(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        infer(img)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = device_events(prof)
    busy = busy_us(kernels)
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "batch": img.shape[0],
        "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": name[:90], "calls": n, "ms": us / 1e3}
                        for name, (n, us) in ranked],
        "host_ms_by_span": host_ms(prof),
    }


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("A", "B", "C", "T"),
                        default="A")
    parser.add_argument("--batches", default=BATCHES,
                        help="comma-separated batch sizes of the traced "
                             "requests (A, B, C)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.config == "T":
        print(card(torch.device("cuda")), flush=True)
        print(json.dumps({"config": "T", **profile_train_step()}), flush=True)
        return
    model, _, mano_l, mano_r = build_flagship(
        device="cuda", seed=0,
        **{"A": {}, "B": CONFIG_B, "C": CONFIG_C}[args.config])
    infer = make_infer(model, mano_l, mano_r)
    print(card(torch.device("cuda")), flush=True)
    rng = np.random.RandomState(0)
    if args.config == "C":
        calibrate_static_scales(
            model, rng.randn(8, 256, 256, 3).astype(np.float32), mano_l,
            mano_r)
    for b in (int(x) for x in args.batches.split(",")):
        img = rng.randn(b, 256, 256, 3).astype(np.float32)
        print(json.dumps({"config": args.config,
                          **profile_request(infer, img)}), flush=True)


if __name__ == "__main__":
    main()
