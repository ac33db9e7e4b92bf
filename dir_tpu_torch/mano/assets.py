"""MANO model assets as tensors: loading, the left-hand fix, and the
deterministic synthetic stand-in.

Counterpart of ``dir_tpu/mano/assets.py``. The licensed MANO files are
not part of the repository; ``load_mano`` reads the ``.npz`` assets that
``tools/convert_mano.py`` writes, and ``synthetic_mano`` makes a random
model with the exact MANO structure, drawing the same numpy random
numbers as the JAX package so that both build bit-identical arrays from
one seed.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# Per-level joint indices for level-batched kinematics: 5 fingers x 3.
LEV1 = (1, 4, 7, 10, 13)
LEV2 = (2, 5, 8, 11, 14)
LEV3 = (3, 6, 9, 12, 15)
# Reorders the concatenated [root, lev1, lev2, lev3] transforms back to
# MANO joint order.
KIN_REORDER = (0, 1, 6, 11, 2, 7, 12, 3, 8, 13, 4, 9, 14, 5, 10, 15)

# Fingertip vertex indices appended as joints 16..20.
TIPS_RIGHT = (745, 317, 444, 556, 673)
TIPS_LEFT = (745, 317, 445, 556, 673)

# Reorder of [16 MANO joints + 5 tips] to the 21-joint convention.
JOINT_REORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
                 10, 11, 12, 19, 7, 8, 9, 20)


class ManoModel(NamedTuple):
    """Constant MANO blend-model tensors of one hand, or of both hands
    stacked on a leading axis (:func:`stack_mano_pair`)."""

    v_template: torch.Tensor       # (778, 3)
    shapedirs: torch.Tensor        # (778, 3, 10)
    posedirs: torch.Tensor         # (778, 3, 135)
    j_regressor: torch.Tensor      # (16, 778)
    weights: torch.Tensor          # (778, 16)
    hands_components: torch.Tensor  # (45, 45) PCA basis, rows are components
    hands_mean: torch.Tensor       # (45,)
    faces: torch.Tensor            # (1538, 3) int32
    tips: torch.Tensor             # (5,) int64 fingertip vertex ids

    def to(self, device) -> "ManoModel":
        return ManoModel(*(t.to(device) for t in self))


def _model_from_arrays(arrays: dict, side: str,
                       tips: tuple | None = None) -> ManoModel:
    if tips is None:
        tips = TIPS_LEFT if side == "left" else TIPS_RIGHT

    def f32(name):
        return torch.from_numpy(np.asarray(arrays[name], np.float32).copy())

    return ManoModel(
        v_template=f32("v_template"),
        shapedirs=f32("shapedirs"),
        posedirs=f32("posedirs"),
        j_regressor=f32("J_regressor"),
        weights=f32("weights"),
        hands_components=f32("hands_components"),
        hands_mean=f32("hands_mean"),
        faces=torch.from_numpy(np.asarray(arrays["faces"], np.int32).copy()),
        tips=torch.tensor(tips, dtype=torch.int64),
    )


def load_mano(path: str, side: str, tips: tuple | None = None) -> ManoModel:
    """Load a converted ``.npz`` MANO asset."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    return _model_from_arrays(arrays, side, tips)


def fix_left_shapedirs(left: ManoModel, right: ManoModel) -> ManoModel:
    """Flip the sign of the left model's x shapedirs when they nearly equal
    the right model's (the well-known MANO left-hand bug)."""
    delta = torch.sum(torch.abs(left.shapedirs[:, 0, :]
                                - right.shapedirs[:, 0, :]))
    shapedirs = left.shapedirs.clone()
    if delta < 1.0:
        shapedirs[:, 0, :] *= -1.0
    return left._replace(shapedirs=shapedirs)


def load_mano_pair(assets_dir: str) -> tuple[ManoModel, ManoModel]:
    """Load (left, right) ``MANO_{LEFT,RIGHT}.npz`` with the left fix."""
    def find(side):
        p = os.path.join(assets_dir, f"MANO_{side.upper()}.npz")
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"No MANO_{side.upper()}.npz under {assets_dir}; run "
                "tools/convert_mano.py on the official files, or use "
                "synthetic_mano().")
        return p

    left = load_mano(find("left"), "left")
    right = load_mano(find("right"), "right")
    return fix_left_shapedirs(left, right), right


def synthetic_mano(side: str = "right", seed: int = 0,
                   tips: tuple | None = None) -> ManoModel:
    """Deterministic random model with the exact MANO structure (778
    verts, 16 joints, 45 PCA components, 1538 faces); same numpy random
    calls, in the same order, as the JAX package's ``synthetic_mano``."""
    rng = np.random.RandomState(seed + (1 if side == "left" else 0))
    nv, nj, npca, nf = 778, 16, 45, 1538
    v_template = rng.uniform(-0.08, 0.08, (nv, 3)).astype(np.float32)
    shapedirs = (rng.randn(nv, 3, 10) * 0.005).astype(np.float32)
    posedirs = (rng.randn(nv, 3, 135) * 0.002).astype(np.float32)
    j_regressor = np.zeros((nj, nv), np.float32)
    for j in range(nj):
        idx = rng.choice(nv, 6, replace=False)
        w = rng.rand(6).astype(np.float32)
        j_regressor[j, idx] = w / w.sum()
    weights = rng.rand(nv, nj).astype(np.float32) ** 4
    weights /= weights.sum(1, keepdims=True)
    q, _ = np.linalg.qr(rng.randn(npca, npca))
    hands_components = q.astype(np.float32)
    hands_mean = (rng.randn(npca) * 0.1).astype(np.float32)
    faces = np.stack(
        [rng.choice(nv, 3, replace=False) for _ in range(nf)]).astype(np.int32)
    arrays = {
        "v_template": v_template,
        "shapedirs": shapedirs,
        "posedirs": posedirs,
        "J_regressor": j_regressor,
        "weights": weights,
        "hands_components": hands_components,
        "hands_mean": hands_mean,
        "faces": faces,
    }
    return _model_from_arrays(arrays, side, tips)


def stack_mano_pair(left: ManoModel, right: ManoModel) -> ManoModel:
    """Both hands' constants stacked on a leading hand axis of size 2."""
    return ManoModel(*(torch.stack([a, b]) for a, b in zip(left, right)))
