"""MANO skinning layer (counterpart of ``dir_tpu/mano/layer.py``).

Every function works on a leading hand axis ``h``: the model tensors are
``(h, ...)`` (one hand, or both from ``stack_mano_pair``) and the inputs
``(h, B, ...)``. Where the JAX package ``vmap``s one hand's forward over
the pair, this layer writes the hand axis out. The kinematic chain runs
as three level-batched 4x4 compositions. It runs in fp32 (or wider) and
expects TF32 matmuls to be off, which is PyTorch's default.

Two APIs share :func:`mano_skin`: the in-network one (6D root, PCA pose,
quaternion Rodrigues; :func:`mano_forward_pca6d_pair`) and the data-side
one (a root rotation matrix, PCA or rotation-matrix finger pose, classic
Rodrigues, translation and scale; :func:`mano_forward_rotmat_pair`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dir_tpu_torch.device import index_tensor
from dir_tpu_torch.mano.assets import JOINT_REORDER, ManoModel
from dir_tpu_torch.ops.rotation import (batch_rodrigues,
                                        robust_rot6d_to_rotmat, rodrigues,
                                        rot6d_to_rotmat, rotation_project)


def _rt_to_se3(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """([..., 3, 3], [..., 3]) -> [..., 4, 4] rigid transform."""
    se3 = F.pad(torch.cat([rot, trans[..., None]], dim=-1), (0, 0, 0, 1))
    se3[..., 3, 3] = 1.0
    return se3


def pca_to_axis(model: ManoModel, pca: torch.Tensor,
                add_mean: bool = True) -> torch.Tensor:
    """(h, B, ncomps) PCA coefficients -> (h, B, 45) axis-angle pose."""
    axis = torch.einsum("hbc,hcp->hbp", pca,
                        model.hands_components[:, :pca.shape[-1]])
    if add_mean:
        axis = axis + model.hands_mean[:, None]
    return axis


def axis_to_pca(model: ManoModel, axis: torch.Tensor) -> torch.Tensor:
    """One hand: (B, 45) axis-angle -> (B, 45) PCA coefficients, through
    the inverse of the full-rank basis."""
    inv = torch.linalg.inv(model.hands_components)
    return (axis - model.hands_mean[None]) @ inv


def _one(model: ManoModel) -> ManoModel:
    """One hand's model with a hand axis of 1."""
    return ManoModel(*(t[None] for t in model))


def mano_skin(model: ManoModel, root_rot: torch.Tensor,
              local_rots: torch.Tensor, betas: torch.Tensor,
              center_idx: int | None = None):
    """Core MANO skinning over a leading hand axis.

    Args:
        model: hand-stacked ManoModel, tensors (h, ...).
        root_rot: (h, B, 3, 3) global wrist rotation.
        local_rots: (h, B, 15, 3, 3) local rotations of MANO joints 1..15.
        betas: (h, B, 10) shape coefficients.
        center_idx: if not None, subtract joint ``center_idx`` (21-joint
            order) from verts and joints.
    Returns:
        verts (h, B, 778, 3), joints (h, B, 21, 3).
    """
    h, b = root_rot.shape[:2]
    dtype = root_rot.dtype

    v_shaped = (torch.einsum("hvcs,hbs->hbvc", model.shapedirs, betas)
                + model.v_template[:, None])
    j_rest = torch.einsum("hjv,hbvc->hbjc", model.j_regressor, v_shaped)

    eye = torch.eye(3, dtype=dtype, device=root_rot.device)
    pose_map = (local_rots - eye).reshape(h, b, 135)
    v_posed = v_shaped + torch.einsum("hvcp,hbp->hbvc", model.posedirs,
                                      pose_map)

    # MANO joints 1..15 are 5 fingers x 3 levels, finger-major: level l of
    # every finger is the strided slice l::3 of joints 1..15 (LEV1-3).
    root_j = j_rest[:, :, 0]
    t_root = _rt_to_se3(root_rot, root_j)               # (h, B, 4, 4)
    fingers = j_rest[:, :, 1:]                          # (h, B, 15, 3)

    def level(prev, lev, parent_j):
        rel = _rt_to_se3(local_rots[:, :, lev::3],
                         fingers[:, :, lev::3] - parent_j)
        return prev @ rel                               # (h, B, 5, 4, 4)

    t1 = level(t_root[:, :, None].expand(h, b, 5, 4, 4), 0,
               root_j[:, :, None])
    t2 = level(t1, 1, fingers[:, :, 0::3])
    t3 = level(t2, 2, fingers[:, :, 1::3])
    # back to MANO joint order (KIN_REORDER): root, then finger-major
    transforms = torch.cat([
        t_root[:, :, None],
        torch.stack([t1, t2, t3], dim=3).reshape(h, b, 15, 4, 4)], dim=2)
    joints16 = transforms[..., :3, 3]

    # Inverse bind: A' = A - [0 | A @ (j, 0)].
    j_h = torch.cat([j_rest, j_rest.new_zeros(h, b, 16, 1)], dim=-1)
    bind_t = torch.einsum("hbjik,hbjk->hbji", transforms, j_h)
    rel_transforms = transforms.clone()
    rel_transforms[..., :, 3] -= bind_t

    # Linear blend skinning; only the top 3x4 of each blend is needed.
    m = torch.einsum("hvj,hbjik->hbvik", model.weights,
                     rel_transforms[..., :3, :])        # (h, B, 778, 3, 4)
    verts = (torch.einsum("hbvik,hbvk->hbvi", m[..., :3], v_posed)
             + m[..., 3])

    tip_idx = model.tips[:, None, :, None].expand(h, b, -1, 3)
    tips = torch.gather(verts, 2, tip_idx)
    joints = torch.cat([joints16, tips], dim=2)[
        :, :, index_tensor(JOINT_REORDER, verts.device)]

    if center_idx is not None:
        center = joints[:, :, center_idx:center_idx + 1]
        verts = verts - center
        joints = joints - center
    return verts, joints


def mano_forward_pca6d_pair(pair: ManoModel, pose_coeffs: torch.Tensor,
                            betas: torch.Tensor,
                            center_idx: int | None = 0,
                            flat_hand_mean: bool = False,
                            robust_rot: bool = True):
    """In-network MANO forward over a leading hand axis.

    pose_coeffs: (h, B, 6 + ncomps) [6D root | PCA pose]; betas
    (h, B, 10). Returns verts (h, B, 778, 3), joints (h, B, 21, 3) in
    meters, centered at ``center_idx``."""
    h, b = pose_coeffs.shape[:2]
    axis45 = pca_to_axis(pair, pose_coeffs[..., 6:],
                         add_mean=not flat_hand_mean)
    local_rots = batch_rodrigues(axis45.reshape(-1, 3)).reshape(
        h, b, 15, 3, 3)
    to_rot = robust_rot6d_to_rotmat if robust_rot else rot6d_to_rotmat
    root_rot = to_rot(pose_coeffs[..., :6].reshape(-1, 6)).reshape(h, b, 3, 3)
    return mano_skin(pair, root_rot, local_rots, betas, center_idx)


def mano_forward_pca6d(model: ManoModel, pose_coeffs: torch.Tensor,
                       betas: torch.Tensor, center_idx: int | None = 0,
                       flat_hand_mean: bool = False,
                       robust_rot: bool = True):
    """One hand: (B, 6 + ncomps), (B, 10) -> verts (B, 778, 3),
    joints (B, 21, 3)."""
    verts, joints = mano_forward_pca6d_pair(
        _one(model), pose_coeffs[None], betas[None], center_idx,
        flat_hand_mean, robust_rot)
    return verts[0], joints[0]


def mano_forward_rotmat_pair(pair: ManoModel, root_rot: torch.Tensor,
                             pose: torch.Tensor, shape: torch.Tensor,
                             trans: torch.Tensor | None = None,
                             scale: torch.Tensor | None = None,
                             center_idx: int | None = 9,
                             use_pca: bool = True):
    """Data-side MANO forward over a leading hand axis.

    root_rot: (h, B, 3, 3); pose: (h, B, ncomps) PCA coefficients if
    ``use_pca`` else (h, B, 15, 3, 3) local rotations; shape (h, B, 10);
    trans (h, B, 3) or None; scale (h, B) or None. The PCA pose goes
    through the classic Rodrigues formula. Returns verts (h, B, 778, 3),
    joints (h, B, 21, 3): centred at ``center_idx``, then scaled, then
    translated."""
    h, b = root_rot.shape[:2]
    if use_pca:
        axis45 = pca_to_axis(pair, pose, add_mean=True)
        local_rots = rodrigues(axis45.reshape(-1, 3)).reshape(h, b, 15, 3, 3)
    else:
        local_rots = pose
    verts, joints = mano_skin(pair, root_rot, local_rots, shape, center_idx)
    if scale is not None:
        verts = verts * scale[..., None, None]
        joints = joints * scale[..., None, None]
    if trans is not None:
        verts = verts + trans[..., None, :]
        joints = joints + trans[..., None, :]
    return verts, joints


def mano_forward_rotmat(model: ManoModel, root_rot: torch.Tensor,
                        pose: torch.Tensor, shape: torch.Tensor,
                        trans: torch.Tensor | None = None,
                        scale: torch.Tensor | None = None,
                        center_idx: int | None = 9, use_pca: bool = True):
    """One hand of :func:`mano_forward_rotmat_pair`: root_rot (B, 3, 3),
    pose (B, ncomps) or (B, 15, 3, 3), shape (B, 10), trans (B, 3),
    scale (B,) -> verts (B, 778, 3), joints (B, 21, 3)."""
    def lift(t):
        return None if t is None else t[None]

    verts, joints = mano_forward_rotmat_pair(
        _one(model), root_rot[None], pose[None], shape[None], lift(trans),
        lift(scale), center_idx, use_pca)
    return verts[0], joints[0]


def mano_forward_rotmats_proj(model: ManoModel, pose_mats: torch.Tensor,
                              betas: torch.Tensor,
                              center_idx: int | None = 0):
    """One hand, rotation-matrix pose: (B, 16, 3, 3) approximate rotations
    (root first) are projected onto SO(3) by SVD before skinning."""
    mats = rotation_project(pose_mats)
    verts, joints = mano_skin(_one(model), mats[None, :, 0],
                              mats[None, :, 1:], betas[None], center_idx)
    return verts[0], joints[0]
