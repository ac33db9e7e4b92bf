"""Training-step throughput of the port (counterpart of
``tools/bench_train.py``).

Times the full train step (forward, the ~42-term loss, backward, AdamW,
BatchNorm statistics, under ``device.deterministic()`` as the Trainer runs
it) on ``bench.py``'s seeded synthetic batch at ``BENCH_BATCH`` (64), bf16
trunk, the default decoder, seeded random weights. The batch and the setup
are ``dir_tpu_torch.bench``'s train half (``train_setup``). Knobs, as in
the JAX tool: ``UNROLL`` (1) optimizer steps a call on stacked batches,
``MANO_PREC`` (``high``; accepted and not read: the port's MANO runs in
fp32 with TF32 off), ``STEM``; ``ITERS`` (10) timed calls after one
untimed step. ``DETERMINISTIC=0`` (this tool only) runs the steps without
``device.deterministic()``, to read what the mode costs. The JAX tool's
docstring speaks of a data mesh, but it builds none; nor does this one.
Runs on the card, ``BENCH_DEVICE=cpu`` on the CPU (the tests):

    python -m dir_tpu_torch.tools.bench_train

Prints one line:
    train_step: xx.xx ms (xxx img/s), unroll=1, loss=x.xxx
"""

from __future__ import annotations

import contextlib
import os
import time

from dir_tpu_torch.bench import (bench_device, check_finite, synchronize,
                                 train_setup)

BATCH = int(os.environ.get("BENCH_BATCH", "64"))
ITERS = int(os.environ.get("ITERS", "10"))


def main(**overrides) -> str:
    """Print (and return) the ``train_step:`` line; ``overrides`` are
    further ``ModelConfig`` fields."""
    from dir_tpu_torch.train import steps

    dev = bench_device()
    unroll = int(os.environ.get("UNROLL", "1"))
    det = os.environ.get("DETERMINISTIC", "1") != "0"
    saved = steps.deterministic
    if not det:
        steps.deterministic = contextlib.nullcontext
    try:
        state, step, batch = train_setup(
            dev, BATCH, unroll,
            mano_precision=os.environ.get("MANO_PREC", "high"), **overrides)
        state, loss = step(state, batch)  # the first step: cuDNN's choices
        synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(ITERS):
            state, loss = step(state, batch)
        synchronize(dev)
        dt = (time.perf_counter() - t0) / (ITERS * unroll)
    finally:
        steps.deterministic = saved
    check_finite(loss.values(), "train_step")
    line = (f"train_step: {dt * 1000:.2f} ms ({BATCH / dt:.0f} img/s), "
            f"unroll={unroll}, "
            f"loss={float(sum(float(v) for v in loss.values())):.3f}"
            + ("" if det else ", deterministic=False"))
    print(line, flush=True)
    return line


if __name__ == "__main__":
    main()
