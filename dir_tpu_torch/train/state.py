"""Train state, learning-rate schedules and the optimizer (counterpart of
``dir_tpu/train/state.py``).

The optimizer is the reference trainer's: AdamW at lr 5e-4 with cosine
annealing to 0 over the total epochs, or a step schedule, both stepped per
epoch as torch schedulers are; here a per-step schedule quantized to epoch
boundaries, read at the optimizer-step count before it increments.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn as nn

from dir_tpu_torch.config import TrainConfig


@dataclasses.dataclass
class TrainState:
    """``step``: optimizer steps taken. ``model`` holds the parameters and
    the BatchNorm running statistics (its buffers); ``optimizer`` holds
    AdamW's moments. A step updates the model and the optimizer in place
    and returns the state with ``step`` advanced."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int
                ) -> Callable[[int], float]:
    """``step -> lr``, constant within each epoch of ``steps_per_epoch``
    optimizer steps: cosine annealing to 0 over ``cfg.total_epochs``, or
    ``cfg.step_gamma`` per milestone passed."""
    if cfg.lr_scheduler == "cosine":
        def sched(step: int) -> float:
            epoch = step // steps_per_epoch
            frac = min(epoch / cfg.total_epochs, 1.0)
            return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return sched
    if cfg.lr_scheduler == "step":
        def sched(step: int) -> float:
            epoch = step // steps_per_epoch
            passed = sum(epoch >= m for m in cfg.step_milestones)
            return cfg.lr * cfg.step_gamma ** passed

        return sched
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


def make_optimizer(model: nn.Module, cfg: TrainConfig,
                   steps_per_epoch: int) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` over every parameter of ``model`` with
    ``optax.adamw``'s defaults: betas (0.9, 0.999), eps 1e-8 outside the
    sqrt, ``cfg.weight_decay`` on every parameter. Its schedule rides along
    as ``optimizer.lr_schedule``; the train step sets each group's lr from
    it at the step count before the update, so the first update uses
    ``lr_schedule(0)``."""
    sched = lr_schedule(cfg, steps_per_epoch)
    opt = torch.optim.AdamW(model.parameters(), lr=sched(0),
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)
    opt.lr_schedule = sched
    return opt


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer)
