"""Fused bone-splat + 3x3 fusion convolution, exact factorization
(counterpart of ``dir_tpu/ops/splat_conv.py``).

The splat map is rank-1 per bone and endpoint, so the 3x3 conv over the
(B, S, S, 2*20*C) splat concat factors into a per-sample precontraction
G (B, 3, 3, 80, O) and nine shifted windows of the (B, S, S, 80) weight
maps, concatenated into one K=720 batched matmul. The splat map never
exists. Geometry runs in at least fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dir_tpu_torch.device import index_tensor

# 21-joint hand skeleton: bone k connects PARENT[k] -> CHILD[k].
PARENT = (0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)
CHILD = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20)


def bone_distances(joint_uv: torch.Tensor, size: int):
    """Pixel-to-bone geometry of the splat, in at least fp32.

    joint_uv: (B, 21, 2) in [-1, 1]. Returns ``(seg_dist, seg_len, dist_a,
    dist_b)``: the point-to-segment distance of every pixel centre (x
    fastest) to every bone, (B, S*S, 20); the bones' lengths, (B, 1, 20);
    and the distances to the bones' two endpoints, (B, S*S, 20), all in
    pixels.
    """
    ct = torch.promote_types(joint_uv.dtype, torch.float32)
    uv = (joint_uv.to(ct) + 1.0) / 2.0 * size
    a = uv[:, index_tensor(PARENT, uv.device)][:, None]   # (B, 1, 20, 2)
    bb = uv[:, index_tensor(CHILD, uv.device)][:, None]

    coords = torch.arange(size, dtype=ct, device=uv.device) + 0.5
    yy, xx = torch.meshgrid(coords, coords, indexing="ij")
    p = torch.stack([xx, yy], -1).reshape(1, size * size, 1, 2)

    d_ba = bb - a
    seg_len = torch.hypot(d_ba[..., 0], d_ba[..., 1])[..., None]
    d = d_ba / torch.where(seg_len > 0, seg_len, torch.ones_like(seg_len))
    s = torch.sum((a - p) * d, dim=-1)
    t = torch.sum((p - bb) * d, dim=-1)
    h = torch.clamp(torch.maximum(s, t), min=0.0)
    d_pa = p - a
    cross = d_pa[..., 0] * d[..., 1] - d_pa[..., 1] * d[..., 0]
    seg_dist = torch.hypot(h, cross)
    dist_a = torch.linalg.norm(p - a, dim=-1)
    dist_b = torch.linalg.norm(p - bb, dim=-1)
    return seg_dist, seg_len[..., 0], dist_a, dist_b


def splat_weights(joint_uv: torch.Tensor, size: int, distance: float):
    """Masked interpolation weights of the bone splat.

    joint_uv: (B, 21, 2) in [-1, 1]. Returns (w_a, w_b), each
    (B, S, S, 20), in at least fp32: zero where the pixel is ``distance``
    or more from the bone or the bone has no length.
    """
    seg_dist, seg_len, dist_a, dist_b = bone_distances(joint_uv, size)
    mask = (seg_dist < distance) & (seg_len > 0)
    denom = dist_a + dist_b
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    zero = torch.zeros((), dtype=seg_dist.dtype, device=seg_dist.device)
    w_a = torch.where(mask, 1.0 - dist_a / denom, zero)
    w_b = torch.where(mask, 1.0 - dist_b / denom, zero)
    b = joint_uv.shape[0]
    return (w_a.reshape(b, size, size, 20), w_b.reshape(b, size, size, 20))


def fused_splat_conv(uv_left: torch.Tensor, uv_right: torch.Tensor,
                     feat_left: torch.Tensor, feat_right: torch.Tensor,
                     kernel: torch.Tensor, bias: torch.Tensor,
                     size: int, distance: float) -> torch.Tensor:
    """conv3x3(concat(splat_l, splat_r), kernel) + bias, factored.

    Args:
        uv_*: (B, 21, 2) joint positions in [-1, 1].
        feat_*: (B, 21, C) per-joint features.
        kernel: (3, 3, 2*20*C, O) fusion-conv kernel in the JAX layout
            (input channels [left | right], bone-major, channel-minor).
        bias: (O,).
    Returns:
        (B, S, S, O) in the dtype of ``feat_left``.
    """
    b, _, c = feat_left.shape
    o = kernel.shape[-1]
    dt = feat_left.dtype
    parent = index_tensor(PARENT, feat_left.device)
    child = index_tensor(CHILD, feat_left.device)

    wa_l, wb_l = splat_weights(uv_left, size, distance)
    wa_r, wb_r = splat_weights(uv_right, size, distance)
    wtil = torch.cat([wa_l, wb_l, wa_r, wb_r], dim=-1).to(dt)  # (B,S,S,80)

    ftil = torch.cat([feat_left[:, parent], feat_left[:, child],
                      feat_right[:, parent], feat_right[:, child]], dim=1)

    kr = kernel.reshape(3, 3, 2, 20, c, o)
    kh = torch.cat([kr[:, :, 0], kr[:, :, 0], kr[:, :, 1], kr[:, :, 1]],
                   dim=2)                                    # (3,3,80,C,O)
    g = torch.einsum("xyjco,bjc->bxyjo", kh, ftil.to(kh.dtype))

    pad = F.pad(wtil, (0, 0, 1, 1, 1, 1))
    wins = [pad[:, dy:dy + size, dx:dx + size]
            for dy in range(3) for dx in range(3)]
    wun = torch.cat(wins, dim=-1).reshape(b, size * size, 9 * 80)
    out = torch.bmm(wun, g.reshape(b, 9 * 80, o))
    return out.reshape(b, size, size, o) + bias.to(g.dtype)
