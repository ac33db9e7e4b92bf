"""Rotation representations used by the in-network MANO layer.

Counterpart of ``dir_tpu/ops/rotation.py`` (quaternion Rodrigues and the
plain/robust 6D maps). The epsilon placements are kept exactly, since
they set the numerics near zero rotation.
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
