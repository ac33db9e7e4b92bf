"""Point sampling from feature maps with torch ``F.grid_sample`` semantics
(bilinear, zeros padding, ``align_corners=False``): the counterpart of
``dir_tpu/ops/sampling.py``.

:func:`grid_sample_nhwc` is ``F.grid_sample`` itself (the JAX package's
gather form). :func:`grid_sample_nhwc_mm` is the selection-matrix form the
JAX package's decoder samples with in training and in eval: the four taps'
weighted one-hot rows summed into one (B, N, H*W) matrix and one batched
matmul. Its backward to the features is that matrix's transpose times the
incoming gradient, one more matmul, where ``F.grid_sample``'s CUDA backward
accumulates with atomics (and raises under deterministic algorithms).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dir_tpu_torch.device import no_tf32


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


def grid_sample_nhwc_mm(features: torch.Tensor,
                        coords: torch.Tensor) -> torch.Tensor:
    """Bilinear point sampling as one selection-matrix product.

    Same arguments and taps as :func:`grid_sample_nhwc`; out-of-map taps
    weigh 0. The selection matrix and the product are in the promoted
    dtype of the features, the coordinates and fp32, with TF32 off, and so
    is the result: fp32 for bf16 features, as ``jnp`` promotes the JAX
    package's bf16 one-hot rows against its fp32 weights. The caller casts.
    """
    b, h, w, c = features.shape
    ct = torch.promote_types(
        torch.promote_types(features.dtype, coords.dtype), torch.float32)
    coords = coords.to(ct)
    x = (coords[..., 0] + 1.0) * w / 2.0 - 0.5
    y = (coords[..., 1] + 1.0) * h / 2.0 - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wx0 = 1.0 - wx1
    wy1 = y - y0
    wy0 = 1.0 - wy1
    cells = torch.arange(h * w, device=features.device)

    def sel_tap(xi, yi, wgt):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        # the weighted one-hot row: the weight where the tap is, else 0
        return torch.where((yc * w + xc)[..., None] == cells,
                           (wgt * inside.to(ct))[..., None], 0.0)

    sel = (sel_tap(x0, y0, wx0 * wy0)
           + sel_tap(x0 + 1, y0, wx1 * wy0)
           + sel_tap(x0, y0 + 1, wx0 * wy1)
           + sel_tap(x0 + 1, y0 + 1, wx1 * wy1))
    with no_tf32():
        return torch.bmm(sel, features.reshape(b, h * w, c).to(ct))
