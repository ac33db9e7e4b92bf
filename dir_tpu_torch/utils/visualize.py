"""2D visualization: skeleton overlays of ground truth against prediction
(counterpart of the skeleton half of ``dir_tpu/utils/visualize.py``)."""

from __future__ import annotations

import cv2 as cv
import numpy as np

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
