"""2D visualization: skeleton overlays of ground truth against prediction,
and the shaded mesh overlay of a prediction (counterpart of
``dir_tpu/utils/visualize.py``)."""

from __future__ import annotations

import cv2 as cv
import numpy as np

from dir_tpu_torch.data.rasterizer import render_two_hands

# Per-finger BGR colors (thumb..pinky).
_FINGER_COLORS = (
    (0, 0, 255), (0, 165, 255), (0, 255, 255), (0, 255, 0), (255, 0, 0))

# 21-joint chains: wrist -> 4 joints per finger.
_CHAINS = tuple(
    (0, 1 + 4 * f, 2 + 4 * f, 3 + 4 * f, 4 + 4 * f) for f in range(5))


def draw_2d_skeleton(image: np.ndarray, joints_2d: np.ndarray) -> np.ndarray:
    """Draw a 21-joint hand skeleton on a BGR uint8 image copy.

    joints_2d: (21, 2) pixel coordinates (extra columns ignored).
    """
    img = np.ascontiguousarray(image).astype(np.uint8).copy()
    pts = np.asarray(joints_2d)[:, :2]
    for f, chain in enumerate(_CHAINS):
        color = _FINGER_COLORS[f]
        for a, b in zip(chain[:-1], chain[1:]):
            pa = tuple(int(v) for v in pts[a])
            pb = tuple(int(v) for v in pts[b])
            cv.line(img, pa, pb, color, 2)
    for p in pts:
        cv.circle(img, (int(p[0]), int(p[1])), 3, (255, 255, 255), -1)
    return img


def save_prediction_grid(path: str, image_rgb: np.ndarray,
                         joints_gt: np.ndarray,
                         joints_pred: np.ndarray) -> None:
    """Side-by-side overlay dump: ground truth left, prediction right."""
    bgr = image_rgb[:, :, ::-1]
    left = draw_2d_skeleton(bgr, joints_gt)
    right = draw_2d_skeleton(bgr, joints_pred)
    cv.imwrite(path, np.concatenate([left, right], axis=1))


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    np.add.at(vn, faces[:, 0], fn)
    np.add.at(vn, faces[:, 1], fn)
    np.add.at(vn, faces[:, 2], fn)
    return vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12)


def _shaded_colors(verts: np.ndarray, faces: np.ndarray,
                   base_bgr: tuple) -> np.ndarray:
    """Simple two-point-light Lambert shading (stands in for the
    reference's pyrender PointLight setup, utils/visualize.py:88-97)."""
    n = _vertex_normals(verts, faces)
    lights = np.array([[0.0, -0.7, -0.7], [0.5, 0.5, -0.7]], np.float32)
    lights /= np.linalg.norm(lights, axis=-1, keepdims=True)
    diffuse = np.clip(n @ lights.T, 0, 1).sum(-1)  # (V,)
    shade = (0.35 + 0.65 * np.clip(diffuse, 0, 1))[:, None]
    return (np.asarray(base_bgr, np.float32)[None] / 255.0) * shade


def render_mesh_overlay(image_bgr: np.ndarray,
                        verts_left: np.ndarray, verts_right: np.ndarray,
                        faces: np.ndarray, camera: np.ndarray,
                        alpha: float = 1.0) -> np.ndarray:
    """Render both predicted MANO meshes over the input image.

    Counterpart of the reference's pyrender offscreen mesh overlay
    (utils/visualize.py:75-105): shaded mesh pixels replace (or
    alpha-blend into) the image wherever the z-buffer is hit; the
    perspective camera is the (3, 3) intrinsics matrix the dataset
    carries (no pytorch3d camera objects needed — the rasterizer
    projects with it directly).

    Args:
        image_bgr: (S, S, 3) uint8 input crop.
        verts_{left,right}: (778, 3) camera-frame vertices (z > 0), e.g.
            a prediction placed in front of the camera.
        faces: (F, 3) MANO faces.
        camera: (3, 3) intrinsics.
    Returns (S, S, 3) uint8 overlay.
    """
    size = image_bgr.shape[0]
    colors_l = _shaded_colors(verts_left, faces, (80, 180, 80))
    colors_r = _shaded_colors(verts_right, faces, (80, 80, 220))
    rendered, zbuf = render_two_hands(verts_left, verts_right, faces,
                                      camera, size, colors_l, colors_r)
    hit = np.isfinite(zbuf)[..., None]
    img = image_bgr.astype(np.float32) / 255.0
    out = np.where(hit, alpha * rendered + (1 - alpha) * img, img)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)
