"""Rotation representations: quaternion, axis-angle, 6D, rotation matrices.

Counterpart of ``dir_tpu/ops/rotation.py``: the in-network maps
(quaternion Rodrigues, the plain and robust 6D maps) and the data-side
ones (classic Rodrigues, Gram-Schmidt 6D, rotmat to axis-angle, the SVD
projection onto SO(3), the pose map). The epsilon placements are kept
exactly, since they set the numerics near zero rotation.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(B, 4) wxyz quaternion (unnormalized) -> (B, 3, 3) rotation matrix."""
    q = quat / torch.linalg.norm(quat, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack([
        w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
        2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
        2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
    ], dim=1)
    return rot.reshape(-1, 3, 3)


def batch_rodrigues(axisang: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3) via the quaternion path.

    The angle is the norm of ``axisang + 1e-8`` (epsilon on the vector,
    not the norm), while the axis is the raw vector over that angle.
    """
    angle = torch.linalg.norm(axisang + 1e-8, dim=1, keepdim=True)
    axis = axisang / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=1)
    return quat_to_rotmat(quat)


def rodrigues(axis: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle -> (N, 3, 3) via the classic Rodrigues formula of
    the data-side MANO: angle = ||axis|| + 1e-8 (epsilon on the norm)."""
    angle = torch.linalg.norm(axis, dim=1, keepdim=True) + 1e-8
    ax = axis / angle
    sin = torch.sin(angle)[..., None]
    cos = torch.cos(angle)[..., None]
    zeros = torch.zeros_like(ax[:, 0])
    # skew-symmetric K with K v = ax x v
    k = torch.stack([
        zeros, -ax[:, 2], ax[:, 1],
        ax[:, 2], zeros, -ax[:, 0],
        -ax[:, 1], ax[:, 0], zeros,
    ], dim=1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    # K^2 = a a^T - I for a unit axis, written out (no 3x3 matmul)
    kk = ax[:, :, None] * ax[:, None, :] - eye
    return eye + sin * k + (1.0 - cos) * kk


def _normalize_rows(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Row-normalize with the magnitude clamped to at least eps; the clamp
    sits inside the sqrt, which keeps the gradient finite at zero."""
    sq = torch.sum(v * v, dim=1, keepdim=True)
    return v / torch.sqrt(torch.clamp(sq, min=eps * eps))


def rot6d_to_rotmat(poses: torch.Tensor) -> torch.Tensor:
    """(B, 6) -> (B, 3, 3), plain Zhou et al. 6D variant."""
    x_raw, y_raw = poses[:, 0:3], poses[:, 3:6]
    x = _normalize_rows(x_raw)
    z = _normalize_rows(torch.linalg.cross(x, y_raw, dim=1))
    y = torch.linalg.cross(z, x, dim=1)
    return torch.stack([x, y, z], dim=2)


def robust_rot6d_to_rotmat(poses: torch.Tensor) -> torch.Tensor:
    """(B, 6) -> (B, 3, 3), symmetric variant that treats both predicted
    directions equally (the in-network MANO layer uses it)."""
    x = _normalize_rows(poses[:, 0:3])
    y = _normalize_rows(poses[:, 3:6])
    middle = _normalize_rows(x + y)
    orthmid = _normalize_rows(x - y)
    x2 = _normalize_rows(middle + orthmid)
    y2 = _normalize_rows(middle - orthmid)
    z = _normalize_rows(torch.linalg.cross(x2, y2, dim=1))
    return torch.stack([x2, y2, z], dim=2)


def rot6d_to_rotmat_gs(vec: torch.Tensor) -> torch.Tensor:
    """(B, 6) -> (B, 3, 3), the Gram-Schmidt variant of the data-side MANO
    (epsilon added to the norm denominators)."""
    x = vec[:, 0:3]
    y = vec[:, 3:6]
    x = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-8)
    y = y - torch.sum(x * y, dim=1, keepdim=True) * x
    y = y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-8)
    z = torch.linalg.cross(x, y, dim=1)
    return torch.stack([x, y, z], dim=2)


def rotmat_to_axis_angle(rot: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (N, 3) axis-angle: sin from the skew part, cos from
    the symmetric part, then the quadrant (branchless)."""
    rot = rot.reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    skew = (rot - rot.transpose(1, 2)) / 2.0
    # (skew[2,1], skew[0,2], skew[1,0]) = sin(theta) * axis
    ell = torch.stack([skew[:, 2, 1], skew[:, 0, 2], skew[:, 1, 0]], dim=1)
    sin = torch.linalg.norm(ell, dim=1)
    axis = ell / (sin[:, None] + 1e-8)

    sym = (rot + rot.transpose(1, 2)) / 2.0 - eye
    outer = axis[:, :, None] * axis[:, None, :] - eye
    tr_sym = sym[:, 0, 0] + sym[:, 1, 1] + sym[:, 2, 2]
    tr_outer = outer[:, 0, 0] + outer[:, 1, 1] + outer[:, 2, 2]
    cos = 1.0 - tr_sym / (tr_outer + 1e-8)

    theta = torch.arcsin(torch.clamp(sin, -1.0 + 1e-7, 1.0 - 1e-7))
    theta = torch.where((cos < 0) & (sin > 0), 3.14159 - theta, theta)
    theta = torch.where((cos < 0) & (sin < 0), -3.14159 - theta, theta)
    return theta[:, None] * axis


def rotation_project(mats: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) matrices -> the closest rotations, by a batched SVD with
    the determinant's sign applied to U's last column."""
    u, _, vt = torch.linalg.svd(mats)
    det = torch.linalg.det(u @ vt)
    u = torch.cat([u[..., :2], u[..., 2:] * torch.sign(det)[..., None, None]],
                  dim=-1)
    return u @ vt


def subtract_flat_id(rot_mats: torch.Tensor) -> torch.Tensor:
    """(B, K*9) flattened rotation matrices minus flattened identities."""
    k = rot_mats.shape[1] // 9
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    return rot_mats - eye.reshape(1, 9).repeat(1, k)


def posemap_axisang(pose_vectors: torch.Tensor):
    """(B, K*3) axis-angle stack -> (pose_map (B, K*9), rot_mats (B, K*9)),
    pose_map being the flattened (R - I) that drives the pose blend
    shapes."""
    b = pose_vectors.shape[0]
    rots = batch_rodrigues(pose_vectors.reshape(-1, 3)).reshape(b, -1)
    return subtract_flat_id(rots), rots
