"""MANO (Romero et al., SIGGRAPH Asia 2017) as DIR's network uses it, in
plain float32 PyTorch: a 6D root rotation and 45 PCA pose coefficients,
quaternion Rodrigues for the fingers, linear blend skinning, five
fingertip vertices appended as joints and the 21 joints reordered, all
centred at one joint.

The licensed model files are not in the repository, so the benchmark draws
a model of the exact MANO structure (778 vertices, 16 joints, 45 PCA
components, 1538 faces) from its seed with numpy (:func:`synthetic`), and
hands the same arrays to the program and to this reference.
"""

from __future__ import annotations

import numpy as np
import torch

PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
TIPS = {"left": (745, 317, 445, 556, 673), "right": (745, 317, 444, 556, 673)}
# [16 MANO joints + 5 tips] -> the 21-joint order
JOINT_ORDER = (0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18, 10, 11, 12, 19,
               7, 8, 9, 20)
FIELDS = ("v_template", "shapedirs", "posedirs", "j_regressor", "weights",
          "hands_components", "hands_mean", "faces", "tips")


def synthetic(seed: int) -> dict:
    """``{"left": arrays, "right": arrays}``: random hands of the MANO
    structure, each a dict of numpy arrays under :data:`FIELDS`."""
    rng = np.random.RandomState(seed % 2 ** 32)
    nv, nj, npca, nf = 778, 16, 45, 1538
    hands = {}
    for side in ("right", "left"):
        j_reg = np.zeros((nj, nv), np.float32)
        for j in range(nj):
            idx = rng.choice(nv, 6, replace=False)
            w = rng.rand(6)
            j_reg[j, idx] = w / w.sum()
        weights = rng.rand(nv, nj) ** 4
        hands[side] = {
            "v_template": rng.uniform(-0.08, 0.08, (nv, 3)),
            "shapedirs": rng.randn(nv, 3, 10) * 0.005,
            "posedirs": rng.randn(nv, 3, 135) * 0.002,
            "j_regressor": j_reg,
            "weights": weights / weights.sum(1, keepdims=True),
            "hands_components": np.linalg.qr(rng.randn(npca, npca))[0],
            "hands_mean": rng.randn(npca) * 0.1,
            "faces": np.stack([rng.choice(nv, 3, replace=False)
                               for _ in range(nf)]).astype(np.int32),
            "tips": np.asarray(TIPS[side], np.int64),
        }
    for side in hands:
        for k, v in hands[side].items():
            if v.dtype == np.float64:
                hands[side][k] = v.astype(np.float32)
    return hands


def tensors(hand: dict, device) -> dict:
    return {k: torch.from_numpy(hand[k]).to(device) for k in FIELDS}


def _quat_rotmat(axisang: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3) through the unit quaternion; the
    angle is the norm of ``axisang + 1e-8``."""
    angle = torch.linalg.norm(axisang + 1e-8, dim=1, keepdim=True)
    q = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2)
                   * axisang / angle], 1)
    w, x, y, z = (q / q.norm(dim=1, keepdim=True)).unbind(1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z),
        2 * (w * y + x * z), 2 * (w * z + x * y), w * w - x * x + y * y - z * z,
        2 * (y * z - w * x), 2 * (x * z - w * y), 2 * (w * x + y * z),
        w * w - x * x - y * y + z * z], 1).reshape(-1, 3, 3)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp((v * v).sum(1, keepdim=True),
                                      min=1e-16))


def _rot6d(p: torch.Tensor) -> torch.Tensor:
    """The symmetric 6D map: both predicted directions weigh alike."""
    x, y = _unit(p[:, :3]), _unit(p[:, 3:])
    mid, orth = _unit(x + y), _unit(x - y)
    x2, y2 = _unit(mid + orth), _unit(mid - orth)
    return torch.stack([x2, y2, _unit(torch.linalg.cross(x2, y2))], 2)


def forward_pca6d(hand: dict, pose: torch.Tensor, betas: torch.Tensor,
                  root: int):
    """pose (B, 6 + 45), betas (B, 10) -> verts (B, 778, 3), joints
    (B, 21, 3), centred at joint ``root``."""
    b = pose.shape[0]
    axis = pose[:, 6:] @ hand["hands_components"] + hand["hands_mean"]
    rots = _quat_rotmat(axis.reshape(-1, 3)).reshape(b, 15, 3, 3)
    root_rot = _rot6d(pose[:, :6])
    v_shaped = (torch.einsum("vcs,bs->bvc", hand["shapedirs"], betas)
                + hand["v_template"])
    j_rest = torch.einsum("jv,bvc->bjc", hand["j_regressor"], v_shaped)
    eye = torch.eye(3, device=pose.device)
    v_posed = v_shaped + torch.einsum("vcp,bp->bvc", hand["posedirs"],
                                      (rots - eye).reshape(b, 135))
    local = torch.cat([root_rot[:, None], rots], 1)            # (B, 16, 3, 3)
    world = []
    for j in range(16):
        t = torch.zeros(b, 4, 4, device=pose.device)
        t[:, :3, :3] = local[:, j]
        t[:, :3, 3] = j_rest[:, j] - (j_rest[:, PARENTS[j]] if j else 0.0)
        t[:, 3, 3] = 1.0
        world.append(t if j == 0 else world[PARENTS[j]] @ t)
    world = torch.stack(world, 1)                              # (B, 16, 4, 4)
    joints16 = world[:, :, :3, 3]
    # skinning transforms: world transform with the rest joint removed
    rel = world[:, :, :3, :].clone()
    rel[..., 3] -= torch.einsum("bjik,bjk->bji", world[:, :, :3, :3], j_rest)
    blend = torch.einsum("vj,bjik->bvik", hand["weights"], rel)
    verts = (torch.einsum("bvik,bvk->bvi", blend[..., :3], v_posed)
             + blend[..., 3])
    joints = torch.cat([joints16, verts[:, hand["tips"]]], 1)[:, JOINT_ORDER]
    center = joints[:, root:root + 1]
    return verts - center, joints - center
