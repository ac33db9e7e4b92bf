"""Point sampling from feature maps with torch ``F.grid_sample`` semantics
(bilinear, zeros padding, ``align_corners=False``): the counterpart of
``dir_tpu/ops/sampling.py``, here simply ``F.grid_sample`` itself."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_nhwc(features: torch.Tensor,
                     coords: torch.Tensor) -> torch.Tensor:
    """Bilinear point sampling.

    Args:
        features: (B, H, W, C) feature maps (any memory layout).
        coords: (B, N, 2) normalized coordinates in [-1, 1];
            coords[..., 0] indexes width, coords[..., 1] height.
    Returns:
        (B, N, C) in the dtype of ``features``. The interpolation runs in
        at least fp32, so bf16 features are not sampled at bf16
        coordinates.
    """
    ct = torch.promote_types(features.dtype, torch.float32)
    ct = torch.promote_types(ct, coords.dtype)
    nchw = features.permute(0, 3, 1, 2).to(ct)
    out = F.grid_sample(nchw, coords.to(ct)[:, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0].permute(0, 2, 1).to(features.dtype)
