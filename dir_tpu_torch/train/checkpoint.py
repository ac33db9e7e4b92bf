"""Training checkpoints on ``torch.save`` (counterpart of the native
checkpoints of ``dir_tpu/train/checkpoint.py``).

A checkpoint ``<ckpt_dir>/<name>.pt`` (``latest`` or ``best``) holds the
model's ``state_dict`` in the layout of the JAX package's
``export_torch_dir_state`` (the reference torch layout, which
``weights.py`` maps; BatchNorm's step counters are left out, as there),
the optimizer's ``state_dict`` and the step. ``meta.json`` beside it keeps
the loop state the JAX package keeps there (``epoch``, ``best``).
"""

from __future__ import annotations

import json
import os

import torch

from dir_tpu_torch.train.state import TrainState


def _path(ckpt_dir: str, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}.pt")


def model_state_dict(model: torch.nn.Module) -> dict:
    """The model's parameters and BN statistics in the reference layout."""
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    name: str = "latest") -> str:
    """Write ``state`` to ``<ckpt_dir>/<name>.pt`` (through a temporary file,
    so that a reader never sees half a checkpoint); returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, name)
    tmp = path + ".tmp"
    torch.save({"model": model_state_dict(state.model),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, target: TrainState,
                       name: str = "latest") -> TrainState:
    """Load a checkpoint into ``target``'s model and optimizer (onto their
    devices) and return the state with the saved step."""
    dev = next(target.model.parameters()).device
    ckpt = torch.load(_path(ckpt_dir, name), map_location=dev,
                      weights_only=True)
    target.model.load_state_dict(ckpt["model"], strict=True)
    target.optimizer.load_state_dict(ckpt["optimizer"])
    target.step = int(ckpt["step"])
    return target


def load_checkpoint_weights(ckpt_dir: str, name: str = "latest") -> dict:
    """The model ``state_dict`` of a checkpoint, on the CPU, without a
    train state to load into (for eval, serving or calibration)."""
    ckpt = torch.load(_path(ckpt_dir, name), map_location="cpu",
                      weights_only=True)
    return ckpt["model"]


def save_meta(ckpt_dir: str, meta: dict) -> None:
    """Persist the loop state the checkpoint does not carry (next epoch,
    best metric), as ``meta.json``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, "meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(ckpt_dir, "meta.json"))


def load_meta(ckpt_dir: str) -> dict:
    path = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)
