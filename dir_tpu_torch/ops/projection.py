"""Camera projection (counterpart of ``dir_tpu/ops/projection.py``)."""

from __future__ import annotations

import torch


def ortho_project(scale: torch.Tensor, trans2d: torch.Tensor,
                  points3d: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection: (B,), (B, 2), (B, N, 3) -> (B, N, 2)
    = scale * xy + trans2d, in normalized [-1, 1] image units."""
    return scale[:, None, None] * points3d[..., :2] + trans2d[:, None, :]


def xyz_to_uv(xyz: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Camera xyz (..., N, 3) -> pixel (u, v) through the (..., 3, 3)
    intrinsics ``camera``."""
    fx = camera[..., 0:1, 0:1]
    fy = camera[..., 1:2, 1:2]
    fu = camera[..., 0:1, 2:3]
    fv = camera[..., 1:2, 2:3]
    u = xyz[..., 0:1] * fx / (xyz[..., 2:3] + 1e-8) + fu
    v = xyz[..., 1:2] * fy / (xyz[..., 2:3] + 1e-8) + fv
    return torch.cat([u, v], dim=-1)
