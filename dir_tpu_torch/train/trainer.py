"""The training loop's schedule arithmetic (counterpart of part of
``dir_tpu/train/trainer.py``). The ``Trainer`` itself builds its batches
from the data pipeline, which the port does not have yet."""

from __future__ import annotations


def opt_steps_per_epoch(num_samples: int, batch_size: int,
                        grad_accum: int) -> int:
    """Optimizer steps per epoch, the lr schedule's quantum: with
    ``grad_accum`` N the step count advances once per N loader
    micro-batches, so the micro-batch count is divided by N to keep the
    schedule on the epoch's cadence."""
    return max(1, num_samples // batch_size // max(1, grad_accum))
