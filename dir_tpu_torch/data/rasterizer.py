"""Minimal z-buffered triangle rasterizer (numpy, offline use; the port's
copy of ``dir_tpu/data/rasterizer.py``).

Replaces the reference's pytorch3d renderer (utils/vis_utils.py:16-381)
for the offline GT mask/dense generation of the prepare step
(dataset/prepare_data.py:174-214). Perspective camera, per-vertex colors,
barycentric interpolation, z-buffer — vectorized over the pixels of each
triangle's bounding box. Offline-only (runs once per dataset build), so
clarity beats speed; a few ms per 256^2 mesh render.
"""

from __future__ import annotations

import numpy as np


def project(verts: np.ndarray, camera: np.ndarray) -> np.ndarray:
    """(V, 3) camera-frame -> (V, 2) pixels + keep z."""
    p = verts @ camera.T
    return np.concatenate([p[:, :2] / p[:, 2:], verts[:, 2:]], axis=1)


def rasterize(verts: np.ndarray, faces: np.ndarray, colors: np.ndarray,
              camera: np.ndarray, size: int,
              image: np.ndarray | None = None,
              zbuf: np.ndarray | None = None):
    """Render a mesh with per-vertex colors into (size, size, 3) float.

    Args:
        verts: (V, 3) camera-frame vertices (z > 0).
        faces: (F, 3) int vertex indices.
        colors: (V, 3) per-vertex colors in [0, 1].
        camera: (3, 3) intrinsics.
        image, zbuf: optional existing buffers to render on top of
            (enables two-hand composition with correct occlusion).
    Returns:
        (image (S, S, 3) float32, zbuf (S, S) float32)
    """
    if image is None:
        image = np.zeros((size, size, 3), np.float32)
    if zbuf is None:
        zbuf = np.full((size, size), np.inf, np.float32)

    uvz = project(verts, camera)
    uv = uvz[:, :2]
    z = uvz[:, 2]

    tri_uv = uv[faces]        # (F, 3, 2)
    tri_z = z[faces]          # (F, 3)
    tri_c = colors[faces]     # (F, 3, 3)

    for f in range(faces.shape[0]):
        a, b, c = tri_uv[f]
        x0 = max(int(np.floor(min(a[0], b[0], c[0]))), 0)
        x1 = min(int(np.ceil(max(a[0], b[0], c[0]))) + 1, size)
        y0 = max(int(np.floor(min(a[1], b[1], c[1]))), 0)
        y1 = min(int(np.ceil(max(a[1], b[1], c[1]))) + 1, size)
        if x0 >= x1 or y0 >= y1:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1) + 0.5,
                             np.arange(y0, y1) + 0.5)
        p = np.stack([xs, ys], axis=-1)  # (h, w, 2)

        v0 = b - a
        v1 = c - a
        den = v0[0] * v1[1] - v1[0] * v0[1]
        if abs(den) < 1e-12:
            continue
        v2 = p - a
        w1 = (v2[..., 0] * v1[1] - v1[0] * v2[..., 1]) / den
        w2 = (v0[0] * v2[..., 1] - v2[..., 0] * v0[1]) / den
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # Perspective-correct depth via linear interpolation of 1/z.
        invz = w0 / tri_z[f, 0] + w1 / tri_z[f, 1] + w2 / tri_z[f, 2]
        depth = 1.0 / np.maximum(invz, 1e-12)
        sub_z = zbuf[y0:y1, x0:x1]
        visible = inside & (depth < sub_z)
        if not visible.any():
            continue
        col = (w0[..., None] * tri_c[f, 0] + w1[..., None] * tri_c[f, 1]
               + w2[..., None] * tri_c[f, 2])
        sub_img = image[y0:y1, x0:x1]
        sub_img[visible] = col[visible]
        sub_z[visible] = depth[visible]
    return image, zbuf


def render_two_hands(verts_left: np.ndarray, verts_right: np.ndarray,
                     faces: np.ndarray, camera: np.ndarray, size: int,
                     colors_left: np.ndarray, colors_right: np.ndarray):
    """Composite both hands with shared z-buffer occlusion."""
    img, zb = rasterize(verts_left, faces, colors_left, camera, size)
    img, zb = rasterize(verts_right, faces, colors_right, camera, size,
                        image=img, zbuf=zb)
    return img, zb


def mask_colors(num_verts: int, side: str) -> np.ndarray:
    """Solid per-hand mask colors following our seg decode convention
    (dir_tpu_torch.data.augment.seg_from_mask): left -> green ch1, right ->
    red ch2 (BGR on disk)."""
    c = np.zeros((num_verts, 3), np.float32)
    if side == "left":
        c[:, 1] = 0.8
    else:
        c[:, 2] = 0.8
    return c


def dense_colors(v_template: np.ndarray) -> np.ndarray:
    """Dense-correspondence color = normalized template position
    (the reference renders per-vertex correspondence colors,
    utils/vis_utils.py:343-356)."""
    v = v_template - v_template.min(0)
    v = v / (v.max(0) + 1e-8)
    return v.astype(np.float32)
