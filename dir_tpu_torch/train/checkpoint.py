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


def load_torch_dir_checkpoint(pth_path: str,
                              backbone_layers=(3, 4, 6, 3)) -> dict:
    """The reference's released DIR ``.pth`` as a ``state_dict`` of the
    port (counterpart of ``dir_tpu/train/checkpoint.py:
    load_torch_dir_checkpoint``). The port's parameter names are the
    reference's, so the file's ``net`` entry (or the file itself) is kept
    where the mapping table (``weights.dir_mapping``) has the key: what
    the port does not hold (STE block 0, the skip convs of same-width
    Residuals, optimizer state) is dropped. Load the result with
    :func:`prune_to_target` and ``load_state_dict(strict=True)``."""
    from dir_tpu_torch.weights import dir_mapping

    state = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = state["net"] if "net" in state else state
    keys = {e.torch_key for e in dir_mapping(backbone_layers)}
    return {k: torch.as_tensor(v) for k, v in sd.items() if k in keys}


def import_torch_resnet50(sd: dict) -> dict:
    """A torchvision ResNet-50 ``state_dict`` as the port's backbone
    ``state_dict`` (``model.backbone``): the keys the backbone holds, as
    the reference copies matching keys (``fc`` and the step counters are
    dropped). A conv7 stem goes to an s2d backbone through
    ``weights.adapt_stem_s2d``."""
    from dir_tpu_torch.weights import dir_mapping

    keys = {e.torch_key[len("backbone."):]
            for e in dir_mapping((3, 4, 6, 3))
            if e.torch_key.startswith("backbone.")}
    return {k: torch.as_tensor(v) for k, v in sd.items() if k in keys}


def prune_to_target(converted: dict, target: torch.nn.Module) -> dict:
    """The entries of ``converted`` that ``target`` holds, checked for full
    coverage and shape (counterpart of ``prune_to_target`` there): raises
    ``KeyError`` for a parameter or statistic ``target`` has and
    ``converted`` lacks, ``ValueError`` for a shape that differs."""
    out = {}
    for key, want in model_state_dict(target).items():
        if key not in converted:
            raise KeyError(f"missing converted parameter: {key}")
        if tuple(converted[key].shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(converted[key].shape)} vs "
                             f"{tuple(want.shape)}")
        out[key] = converted[key]
    return out


def load_model_weights(model: torch.nn.Module, spec: str,
                       seed: int = 0) -> str:
    """Fill ``model`` (a DIR) with the weights an app's ``--model`` names
    and return what was loaded: ``random`` (seeded random weights,
    ``weights.random_init_``), a reference ``.pth``
    (:func:`load_torch_dir_checkpoint`), or a port checkpoint given as
    ``<ckpt_dir>/<name>``, ``<ckpt_dir>/<name>.pt`` or ``<ckpt_dir>`` (its
    ``latest``). A conv7 stem is rewritten for an s2d model."""
    from dir_tpu_torch.weights import adapt_stem_s2d, random_init_

    if spec == "random":
        random_init_(model, seed)
        return "random"
    if spec.endswith(".pth"):
        sd = load_torch_dir_checkpoint(spec, model.cfg.backbone_layers)
        what = "reference checkpoint"
    else:
        path = spec[:-3] if spec.endswith(".pt") else spec
        sd = (load_checkpoint_weights(path, "latest") if os.path.isdir(path)
              else load_checkpoint_weights(os.path.dirname(path) or ".",
                                           os.path.basename(path)))
        what = "checkpoint"
    if model.cfg.backbone_stem == "s2d":
        sd = adapt_stem_s2d(sd)
    model.load_state_dict(prune_to_target(sd, model), strict=True)
    return what
