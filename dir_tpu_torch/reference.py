"""The reference record: ``dir_tpu``'s own outputs on the port's seeded
full-size flagship, and the measures that hold the port to it.

``tests/torch_port_reference.py`` writes the record on the CPU with both
packages (``tests/data/torch_port_reference.npz``). The weights are the
port's: :func:`weights.random_init_` at seed 0 on the flagship DIR
(ResNet-50, 256x256), conditioned once at fp32 by
:func:`serve.condition_random_`, carried into ``dir_tpu`` by its own torch
converter. ``dir_tpu`` then runs them at full depth:

* A and B at fp32 on its plain routes (``fused_splat_conv`` on and off), on
  :func:`images`;
* C, int8 static serving on the bf16 trunk with the fused int8 kernel off
  (its unfused route), calibrated on :func:`calibration_images`;
* T, one fp32 ``value_and_grad`` of its total loss with B's decoder flags
  on :func:`train_batch`.

This module reads the record with numpy alone, so that ``chip_smoke.py``
holds the port on the card to it without JAX. Its keys:

``digest``
    :func:`state_digest` of the state_dict as drawn;
``conditioned/<state key>``
    every tensor that conditioning changed: the BatchNorm running
    statistics and counters, the MANO heads' biases;
``A/<output>``, ``B/<output>``, ``C/<output>``
    outputs by :func:`flatten`'s names;
``C/amax/<buffer>``
    C's calibrated scales under the port's buffer names;
``T/loss/<term>``, ``T/grad_norm/<parameter>``, ``T/grad/<parameter>``
    the loss terms, every parameter's gradient norm, and the whole
    gradient of :data:`WHOLE_GRADS`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

SEED = 0
N_IMAGES = 4
CALIBRATION_IMAGES = 16
TRAIN_BATCH = 2
# The port's flags of each recorded configuration, on top of
# ``serve.build_flagship``'s defaults (configuration A); T trains with B's
# decoder flags.
CONFIGS = ("A", "B", "C")
T_FLAGS = {"fused_splat_conv": False, "use_pallas_splat": True}
# The parameters whose whole gradient the record keeps: the stem conv and
# the last refine stage's left MANO head.
WHOLE_GRADS = ("backbone.conv1.weight",
               "decoder.projecter_3.regressor.mano_left.weight",
               "decoder.projecter_3.regressor.mano_left.bias")
# The final stage's joints and meshes, both hands: the mm measure.
FINAL_KEYS = ("pd_joint_xyz_left", "pd_joint_xyz_right",
              "pd_mesh_xyz_left", "pd_mesh_xyz_right")
# The decoder's splats by refine stage: (stage, map size, distance in px),
# ``ModelConfig.stage_distances`` at 16 and 32.
SPLATS = ((1, 16, 1.0), (2, 32, 2.0))
# A (pixel, bone) pair this close to its splat's distance threshold (px) may
# fall on either side of the mask's step under another fp32 rounding of the
# joints: the port's fp32 joints stand within 8.2e-6 of the record's in uv,
# 1.3e-4 px at 32. The record's four images have two such pairs (image 0 at
# stage 1's splat, image 3 at stage 2's), and on the card one moved the fp32
# logits by 0.40.
NEAR_THRESHOLD_PX = 3e-4
# The seg labels are compared where the record's top logit leads the next
# by more than this: rounding flips the labels of the pixels in between.
SEG_MARGIN = 4.0
# A gradient norm is held relative to the larger of its own and this share
# of the largest norm: a conv bias feeding a train-mode BatchNorm has a
# gradient that is 0 in exact arithmetic, rounding noise in fp32.
GRAD_NORM_FLOOR = 1e-4


def images() -> np.ndarray:
    return np.random.RandomState(0).randn(
        N_IMAGES, 256, 256, 3).astype(np.float32)


def calibration_images() -> np.ndarray:
    """``chip_smoke.py``'s seeded calibration batch of configuration C."""
    return np.random.RandomState(1).randn(
        CALIBRATION_IMAGES, 256, 256, 3).astype(np.float32)


def train_batch() -> dict:
    """``bench.py``'s seeded train batch at :data:`TRAIN_BATCH`."""
    from dir_tpu_torch.bench import train_batch as bench_batch

    return bench_batch(TRAIN_BATCH, seed=0)


def state_digest(state_dict: dict) -> str:
    """sha256 over the entries in sorted key order: each key, dtype, shape
    and the tensor's bytes."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        v = state_dict[key].detach().cpu().contiguous()
        h.update(f"{key}:{v.dtype}:{tuple(v.shape)}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def load(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def conditioned(state_dict: dict, record: dict) -> dict:
    """``state_dict`` (as :func:`weights.random_init_` drew it) with the
    record's conditioned tensors in place; raises when the draw's digest
    is not the record's."""
    got = state_digest(state_dict)
    if got != str(record["digest"]):
        raise RuntimeError(
            f"the seeded weights' digest {got} is not the record's "
            f"{record['digest']}: this torch draws other weights")
    out = dict(state_dict)
    prefix = "conditioned/"
    for key, value in record.items():
        if key.startswith(prefix):
            name = key[len(prefix):]
            if tuple(out[name].shape) != value.shape:
                raise KeyError(f"{name}: shape {value.shape}")
            out[name] = torch.from_numpy(value).to(out[name].dtype)
    return out


def flagship_state(record: dict) -> dict:
    """The record's weights on the CPU: the seeded flagship drawn here,
    checked against the digest, with the conditioned tensors loaded."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.weights import random_init_

    drawn = random_init_(DIR(ModelConfig()), SEED).state_dict()
    return conditioned(drawn, record)


def amax(record: dict, config: str = "C") -> dict:
    """The recorded static scales as :func:`weights.load_amax` takes them."""
    prefix = f"{config}/amax/"
    return {k[len(prefix):]: torch.tensor(float(v), dtype=torch.float32)
            for k, v in record.items() if k.startswith(prefix)}


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def flatten(out: dict) -> dict:
    """A DIR output dict (either package's) -> ``{"stage<i>/<key>": array,
    "seg": array, "dense": array}`` of fp32 host arrays."""
    flat = {f"stage{i}/{k}": _host(v)
            for i, stage in enumerate(out["stages"]) for k, v in stage.items()}
    for key in ("seg", "dense"):
        flat[key] = _host(out[key])
    return flat


def outputs(record: dict, config: str) -> dict:
    prefix = f"{config}/"
    return {k[len(prefix):]: v for k, v in record.items()
            if k.startswith(prefix) and not k.startswith(prefix + "amax/")}


def kind(name: str) -> str:
    """The tolerance class of an output: joint and mesh xyz (m), uv, the
    seg/dense logits, or the rest (MANO parameters, offset, projection)."""
    if name in ("seg", "dense"):
        return "head"
    return "xyz" if "xyz" in name else "uv" if "uv" in name else "other"


def index(name: str) -> int:
    """The stage of an output; the seg/dense heads, which come last, 3."""
    return 3 if name in ("seg", "dense") else int(name.split("/")[0][5:])


def first_moved(want: dict) -> np.ndarray:
    """Per image of a record's outputs, the :func:`index` of the first
    output that a (pixel, bone) pair within :data:`NEAR_THRESHOLD_PX` of a
    splat's threshold can move (4: none). The mask is a step there, and
    either side is right under another rounding. The splat of refine stage
    s takes that stage's joints and feeds stage s + 1 and the heads; the
    geometry is the record's own joints in fp64."""
    from dir_tpu_torch.ops.splat_conv import bone_distances

    n = want["stage0/pd_joint_uv_left"].shape[0]
    first = np.full(n, 4)
    for stage, size, distance in SPLATS:
        for side in ("left", "right"):
            uv = torch.from_numpy(want[f"stage{stage}/pd_joint_uv_{side}"])
            seg_dist = bone_distances(uv.double(), size)[0]
            near = ((seg_dist - distance).abs() < NEAR_THRESHOLD_PX).reshape(
                n, -1).any(1).numpy()
            first[near] = np.minimum(first[near], stage + 1)
    return first


def errors(got: dict, want: dict, rows=slice(None), first=None) -> dict:
    """Max abs error by :func:`kind` of flattened outputs against the
    record's (``rows`` of it); the names must agree. ``first``
    (:func:`first_moved` of ``want[rows]``) leaves out, for each image, the
    outputs a near-threshold pair can move."""
    if sorted(got) != sorted(want):
        raise KeyError(f"outputs {sorted(set(got) ^ set(want))} differ")
    worst: dict = {}
    for name, w in want.items():
        g, w = got[name], w[rows]
        if g.shape != w.shape or not np.isfinite(g).all():
            raise ValueError(f"{name}: shape {g.shape} against {w.shape}, "
                             "or not finite")
        if first is not None:
            keep = first > index(name)
            if not keep.any():
                continue
            g, w = g[keep], w[keep]
        err = float(np.abs(g.astype(np.float64) - w).max())
        worst[kind(name)] = max(worst.get(kind(name), 0.0), err)
    return worst


def head_errors(got: dict, want: dict) -> dict:
    """The seg/dense heads by what they are for: the share of pixels whose
    seg label (argmax) differs from the record's, among those where the
    record's top logit leads by more than :data:`SEG_MARGIN`; and the dense
    map's RMS error over the record's RMS."""
    seg, top = got["seg"], np.sort(want["seg"], -1)
    sure = top[..., -1] - top[..., -2] > SEG_MARGIN
    flipped = seg.argmax(-1) != want["seg"].argmax(-1)
    dense = want["dense"].astype(np.float64)
    return {"seg_label_share": float(flipped[sure].mean()),
            "dense_rel_rms": float(np.sqrt(((got["dense"] - dense) ** 2).mean()
                                           / (dense ** 2).mean()))}


def final_mm(got: dict, want: dict, rows=slice(None)) -> float:
    """Max abs error over the final stage's joints and meshes of both
    hands, in mm."""
    last = max(int(k.split("/")[0][5:]) for k in want if k.startswith("stage"))
    return max(float(np.abs(got[f"stage{last}/{k}"].astype(np.float64)
                            - want[f"stage{last}/{k}"][rows]).max())
               for k in FINAL_KEYS) * 1e3


def train_step_gradients(model, mano_left, mano_right, batch: dict,
                         device) -> tuple:
    """One step of the port's train path (``train/steps.py:make_train_step``
    with ``TrainConfig()``'s AdamW) on ``batch``: the loss terms and every
    parameter's gradient as that step computed it, on the host."""
    from dir_tpu_torch.config import TrainConfig
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    opt = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    step = make_train_step(model, opt, model.cfg, mano_left, mano_right,
                           device=device)
    _, loss_dict = step(create_train_state(model, opt), batch)
    losses = {k: float(v) for k, v in loss_dict.items()}
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.named_parameters() if p.grad is not None}
    return losses, grads


def train_record(losses: dict, grads: dict) -> dict:
    """A train step's record entries: the loss terms, every gradient's norm
    (fp64) and :data:`WHOLE_GRADS` whole, in the gradients' own dtype."""
    out = {f"T/loss/{k}": np.float64(v) for k, v in losses.items()}
    out.update({f"T/grad_norm/{k}": np.linalg.norm(np.asarray(g, np.float64))
                for k, g in grads.items()})
    out.update({f"T/grad/{k}": np.asarray(grads[k]) for k in WHOLE_GRADS})
    return out


def train_errors(record: dict, losses: dict, grads: dict) -> dict:
    """The port's train step against the record's: the worst loss term
    (relative), the worst gradient norm (relative to the larger of its own
    and :data:`GRAD_NORM_FLOOR` of the largest), and each of
    :data:`WHOLE_GRADS` (max abs error over the tensor's max |value|)."""
    want_loss = {k[len("T/loss/"):]: float(v) for k, v in record.items()
                 if k.startswith("T/loss/")}
    want_norm = {k[len("T/grad_norm/"):]: float(v) for k, v in record.items()
                 if k.startswith("T/grad_norm/")}
    if sorted(losses) != sorted(want_loss):
        raise KeyError(f"loss terms {sorted(losses)} against "
                       f"{sorted(want_loss)}")
    if sorted(grads) != sorted(want_norm):
        raise KeyError(f"{len(grads)} gradients against {len(want_norm)}")
    loss = max((abs(losses[k] - w) / abs(w), k) for k, w in want_loss.items())
    floor = GRAD_NORM_FLOOR * max(want_norm.values())
    norm = max((abs(float(grads[k].norm()) - w) / max(w, floor), k)
               for k, w in want_norm.items())
    whole = {}
    for k in WHOLE_GRADS:
        w = record[f"T/grad/{k}"].astype(np.float64)
        whole[k] = float(np.abs(grads[k].numpy() - w).max()
                         / np.abs(w).max())
    return {"loss_rel": loss[0], "loss_rel_at": loss[1],
            "grad_norm_rel": norm[0], "grad_norm_rel_at": norm[1],
            "whole_grad_rel": whole}
