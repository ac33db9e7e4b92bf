"""Camera projection (counterpart of ``dir_tpu/ops/projection.py``)."""

from __future__ import annotations

import torch


def ortho_project(scale: torch.Tensor, trans2d: torch.Tensor,
                  points3d: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection: (B,), (B, 2), (B, N, 3) -> (B, N, 2)
    = scale * xy + trans2d, in normalized [-1, 1] image units."""
    return scale[:, None, None] * points3d[..., :2] + trans2d[:, None, :]


def _cam_params(camera: torch.Tensor):
    """(fx, fy, fu, fv) of the (..., 3, 3) intrinsics, each (..., 1, 1)."""
    return (camera[..., 0:1, 0:1], camera[..., 1:2, 1:2],
            camera[..., 0:1, 2:3], camera[..., 1:2, 2:3])


def uvd_to_xyz(uvd: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Pixel (u, v, depth) (..., N, 3) -> camera xyz through the (..., 3, 3)
    intrinsics ``camera``."""
    fx, fy, fu, fv = _cam_params(camera)
    x = (uvd[..., 0:1] - fu) * uvd[..., 2:3] / fx
    y = (uvd[..., 1:2] - fv) * uvd[..., 2:3] / fy
    return torch.cat([x, y, uvd[..., 2:3]], dim=-1)


def xyz_to_uv(xyz: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Camera xyz (..., N, 3) -> pixel (u, v) through the (..., 3, 3)
    intrinsics ``camera``."""
    fx, fy, fu, fv = _cam_params(camera)
    u = xyz[..., 0:1] * fx / (xyz[..., 2:3] + 1e-8) + fu
    v = xyz[..., 1:2] * fy / (xyz[..., 2:3] + 1e-8) + fv
    return torch.cat([u, v], dim=-1)


def xyz_to_uvd(xyz: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """Camera xyz (..., N, 3) -> pixel (u, v, depth)."""
    return torch.cat([xyz_to_uv(xyz, camera), xyz[..., 2:3]], dim=-1)
