"""Camera projection (counterpart of ``dir_tpu/ops/projection.py``)."""

from __future__ import annotations

import torch


def ortho_project(scale: torch.Tensor, trans2d: torch.Tensor,
                  points3d: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection: (B,), (B, 2), (B, N, 3) -> (B, N, 2)
    = scale * xy + trans2d, in normalized [-1, 1] image units."""
    return scale[:, None, None] * points3d[..., :2] + trans2d[:, None, :]
