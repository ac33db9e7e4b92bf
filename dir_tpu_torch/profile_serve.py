"""Where one serving request's time goes on the card.

Builds the bf16 flagship (seeded random weights, fused bottleneck on) in
configuration A (the default: factored splat conv), B (``--config B``:
fused bottleneck at layer2 too, materialized bone splat through its
kernel) or C (``--config C``: int8 static serving with the fused int8
bottleneck, calibrated here on 8 seeded images), warms it up, then traces
one request at each of batch 1, 8 and 64 with
``torch.profiler`` and prints, per batch, one JSON line: the request's
wall time, the device's busy time and idle share over it, the number of
kernel launches, and the 15 kernels that take the most device time; the
card's name and power limit come first. Run from the repository root on a
machine with a CUDA device:

    python -m dir_tpu_torch.profile_serve [--config {A,B,C}]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dir_tpu_torch.serve import (CONFIG_B, CONFIG_C, build_flagship,
                                 calibrate_static_scales, make_infer)

BATCHES = (1, 8, 64)
TOP = 15


def _busy_us(events) -> float:
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


def profile_request(infer, img: np.ndarray) -> dict:
    for _ in range(3):
        infer(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        infer(img)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us(kernels)
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
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", choices=("A", "B", "C"), default="A")
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, _, mano_l, mano_r = build_flagship(
        device="cuda", seed=0,
        **{"A": {}, "B": CONFIG_B, "C": CONFIG_C}[args.config])
    infer = make_infer(model, mano_l, mano_r)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.RandomState(0)
    if args.config == "C":
        calibrate_static_scales(
            model, rng.randn(8, 256, 256, 3).astype(np.float32), mano_l,
            mano_r)
    for b in BATCHES:
        img = rng.randn(b, 256, 256, 3).astype(np.float32)
        print(json.dumps({"config": args.config,
                          **profile_request(infer, img)}), flush=True)


if __name__ == "__main__":
    main()
