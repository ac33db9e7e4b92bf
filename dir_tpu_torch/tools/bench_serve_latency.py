"""Serving latency of the port: per-request wall latency of the flagship
inference step at serving batch sizes (b=1 online, 32 micro-batch, 256
offline); counterpart of ``tools/bench_serve_latency.py``.

Complements ``dir_tpu_torch/bench.py``'s throughput headline: a server
cares about the p50 per-dispatch latency at small batch, where the step is
bound by the host's launches rather than by the card. The step is
``serve.make_infer``'s, the live model's forward that the serving artifact
exports, on ``serve.build_flagship``'s bf16 flagship with seeded weights
conditioned by ``serve.condition_random_`` (as ``dir_tpu_torch.bench``
explains). Knobs, as in the JAX tool: ``QUANT``=1/2/3 and
``QUANT_STATIC=1`` (calibrated on 8 seeded images) as in ``bench.py``; the
fused bottleneck (K1) is on only at ``QUANT=0``. ``CONFIG=B`` (this tool
only) serves configuration B (``serve.CONFIG_B``: K1 and K2, the
materialized bone splat through K5) instead of A.

Each dispatch is timed from a host array to a synchronised result, the
upload included: users pay it (the JAX tool times a device-resident
image). Beside it, the upload alone (the host array to a synchronised
device tensor) over as many calls, and its share of the p50.

Batch sizes via ``BATCHES=1,32,256``; iterations via ``ITERS`` (30); runs
on the card, ``BENCH_DEVICE=cpu`` on the CPU (the tests):

    python -m dir_tpu_torch.tools.bench_serve_latency

One line per batch:
    batch  256: p50    xx.xx ms  p99    xx.xx ms  (   xxxx.x img/s at p50)  upload p50  xx.xx ms (x.x%)
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from dir_tpu_torch.bench import (bench_device, conditioned_flagship,
                                 synchronize)

BATCHES = tuple(int(b) for b in
                os.environ.get("BATCHES", "1,32,256").split(","))
ITERS = int(os.environ.get("ITERS", "30"))


def _p50_p99(seconds) -> tuple:
    ms = np.sort(np.asarray(seconds)) * 1e3
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 99))


def main(**overrides) -> list:
    """Print (and return) one line per batch size; ``overrides`` are
    further ``ModelConfig`` fields."""
    from dir_tpu_torch.serve import (CONFIG_B, calibrate_static_scales,
                                     make_infer)

    dev = bench_device()
    q = int(os.environ.get("QUANT", "0"))
    qs = os.environ.get("QUANT_STATIC", "0") == "1"
    flags = dict(dtype="bfloat16", fused_bottleneck_eval=q == 0,
                 quant_backbone_eval=q >= 1, quant_decoder_eval=q >= 2,
                 quant_aux_eval=q >= 3, quant_static=qs)
    if os.environ.get("CONFIG", "A") == "B":
        flags.update(CONFIG_B)
    model, _, mano_l, mano_r = conditioned_flagship(
        dev, **dict(flags, **overrides))
    rng = np.random.RandomState(0)
    if qs:
        calibrate_static_scales(
            model, rng.randn(8, 256, 256, 3).astype(np.float32), mano_l,
            mano_r)
    infer = make_infer(model, mano_l, mano_r)

    def dispatch(img):
        out = infer(img)
        synchronize(dev)
        return out

    def upload(img):
        t = torch.from_numpy(img).to(dev)
        synchronize(dev)
        return t

    lines = []
    for b in BATCHES:
        img = rng.randn(b, 256, 256, 3).astype(np.float32)
        dispatch(img)
        times = {dispatch: [], upload: []}
        for fn, lats in times.items():
            for _ in range(ITERS):
                t0 = time.perf_counter()
                fn(img)
                lats.append(time.perf_counter() - t0)
        p50, p99 = _p50_p99(times[dispatch])
        u50, _ = _p50_p99(times[upload])
        line = (f"batch {b:4d}: p50 {p50:8.2f} ms  p99 {p99:8.2f} ms  "
                f"({b / p50 * 1e3:8.1f} img/s at p50)  upload p50 "
                f"{u50:7.2f} ms ({u50 / p50:.1%})")
        print(line, flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
