"""Zero-pose local joint frames (counterpart of ``dir_tpu/mano/frames.py``;
reference: models/manolayer.py:63-97, 218-228).

``local_frames`` builds, for each of the 15 articulated MANO joints, an
orthonormal frame whose columns are [splay, bend, twist]: the twist axis
points along the bone, palm joints take their splay axis from adjacent
palm-plane normals, and the other joints inherit their parent's frame
rotated by the minimal rotation between the bone directions.
"""

from __future__ import annotations

import torch

from dir_tpu_torch.mano.assets import ManoModel

# MANO-ordered (16-joint) tree data.
_MANO_SON = (2, 3, 17, 5, 6, 18, 8, 9, 20, 11, 12, 19, 14, 15, 16)
_MANO_PARENT = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
_PALM_IDX = (13, 1, 4, 10, 7)
_MANO_ORDER = (0, 5, 6, 7, 9, 10, 11, 17, 18, 19, 13, 14, 15, 1, 2, 3, 4,
               8, 12, 16, 20)
# Zero-pose fingertip vertices.
_TPOSE_TIPS = (744, 320, 444, 555, 672)
# [16 MANO joints + 5 tips] to the 21-joint order.
_TO_21 = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
          10, 11, 12, 19, 7, 8, 9, 20)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _minimal_rotation(old_z: torch.Tensor, new_z: torch.Tensor
                      ) -> torch.Tensor:
    """Rotation taking old_z to new_z about their common perpendicular."""
    x = _norm(_cross(old_z, new_z))
    old_frame = torch.stack([x, _cross(old_z, x), old_z], dim=-1)
    new_frame = torch.stack([x, _cross(new_z, x), new_z], dim=-1)
    return new_frame @ old_frame.transpose(-1, -2)


def build_frames(skel21: torch.Tensor) -> torch.Tensor:
    """(B, 21, 3) joints (21-joint order) -> (B, 15, 3, 3) local frames."""
    skel = skel21[:, list(_MANO_ORDER)]
    z = _norm(skel[:, list(_MANO_SON)] - skel[:, 1:16])       # (B, 15, 3)
    z = torch.cat([torch.zeros_like(z[:, :1]), z], dim=1)     # (B, 16, 3)

    # palm-plane normals give the palm joints' splay axes
    palm = skel[:, list(_PALM_IDX)] - skel[:, 0:1]            # (B, 5, 3)
    n = _norm(_cross(palm[:, :-1], palm[:, 1:]))              # (B, 4, 3)
    zero = torch.zeros_like(n[:, :1])
    palm_x = _norm(torch.cat([n, zero], dim=1) + torch.cat([zero, n], dim=1))

    frames = [None] * 16
    for i, pj in enumerate(_PALM_IDX):
        zx = z[:, pj]
        y = _norm(_cross(zx, palm_x[:, i]))
        frames[pj] = torch.stack([_cross(y, zx), y, zx], dim=-1)
    for i in range(1, 16):
        if i in _PALM_IDX:
            continue
        p = _MANO_PARENT[i]
        frames[i] = _minimal_rotation(z[:, p], z[:, i]) @ frames[p]
    return torch.stack(frames[1:], dim=1)                     # (B, 15, 3, 3)


def local_frames(model: ManoModel, betas: torch.Tensor) -> torch.Tensor:
    """One hand: (B, 10) betas -> (B, 15, 3, 3) zero-pose local frames."""
    v_shaped = (torch.einsum("vcs,bs->bvc", model.shapedirs, betas)
                + model.v_template)
    j16 = torch.einsum("jv,bvc->bjc", model.j_regressor, v_shaped)
    tips = v_shaped[:, list(_TPOSE_TIPS)]
    j21 = torch.cat([j16, tips], dim=1)
    return build_frames(j21[:, list(_TO_21)])
