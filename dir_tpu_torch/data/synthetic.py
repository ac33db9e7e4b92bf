"""Synthetic on-disk dataset in the InterHand processed layout
(counterpart of ``dir_tpu/data/synthetic.py``).

Writes {split}/{img,mask,dense,anno}/ with the schema of the real
prepared dataset, from synthetic (or real) MANO models: a few frames drive
the data pipeline, the trainer and the eval app end to end without the
licensed assets. The same seed writes the same files as the JAX package.
"""

from __future__ import annotations

import os
import pickle

import cv2 as cv
import numpy as np

from dir_tpu_torch.data.mano_np import NumpyMano
from dir_tpu_torch.mano.assets import ManoModel


def _draw_hand(img: np.ndarray, pts: np.ndarray, color, radius=2):
    h, w = img.shape[:2]
    for p in pts[::4]:
        x, y = int(p[0]), int(p[1])
        if 0 <= x < w and 0 <= y < h:
            cv.circle(img, (x, y), radius, color, -1)


def generate(out_dir: str, mano_left: ManoModel, mano_right: ManoModel,
             split: str = "train", num_samples: int = 8, img_size: int = 256,
             seed: int = 0) -> None:
    rng = np.random.RandomState(seed)
    manos = {"left": NumpyMano(mano_left), "right": NumpyMano(mano_right)}
    for sub in ("img", "mask", "dense", "anno"):
        os.makedirs(os.path.join(out_dir, split, sub), exist_ok=True)

    camera = np.array([[530.0, 0, img_size / 2],
                       [0, 530.0, img_size / 2],
                       [0, 0, 1.0]], np.float32)
    cam_R = np.eye(3, dtype=np.float32)
    cam_t = np.zeros(3, np.float32)

    for idx in range(num_samples):
        img = np.full((img_size, img_size, 3), 40, np.uint8)
        mask = np.zeros((img_size, img_size, 3), np.uint8)
        dense = np.zeros((img_size, img_size, 3), np.uint8)
        params = {}
        for hand, depth_off, x_off in (("left", 0.55, -0.03),
                                       ("right", 0.6, 0.03)):
            from scipy.spatial.transform import Rotation as R
            root = R.random(random_state=rng.randint(1 << 30)).as_matrix()
            root = root.astype(np.float32).reshape(1, 3, 3)
            pose = (rng.randn(1, 45) * 0.3).astype(np.float32)
            shape = (rng.randn(1, 10) * 0.5).astype(np.float32)
            trans = np.array(
                [[x_off + rng.randn() * 0.01, rng.randn() * 0.01,
                  depth_off + rng.randn() * 0.02]], np.float32)
            params[hand] = {"R": root, "pose": pose, "shape": shape,
                            "trans": trans}

            verts, _ = manos[hand](root, pose, shape, trans=trans,
                                   center_idx=None)
            v2 = verts[0] @ camera.T
            v2 = v2[:, :2] / v2[:, 2:]
            # mask colors follow our decode convention: left -> ch1
            # (green), right -> ch2 (red) in BGR.
            color = (0, 200, 0) if hand == "left" else (0, 0, 200)
            _draw_hand(img, v2, (160, 160, 160))
            _draw_hand(mask, v2, color, radius=3)
            # dense colors: normalized template position
            _draw_hand(dense, v2, (100, 150, 200), radius=3)

        cv.imwrite(os.path.join(out_dir, split, "img", f"{idx}.jpg"), img)
        cv.imwrite(os.path.join(out_dir, split, "mask", f"{idx}.jpg"), mask)
        cv.imwrite(os.path.join(out_dir, split, "dense", f"{idx}.jpg"), dense)
        anno = {
            "camera": {"R": cam_R, "t": cam_t, "camera": camera},
            "mano_params": params,
        }
        with open(os.path.join(out_dir, split, "anno", f"{idx}.pkl"),
                  "wb") as f:
            pickle.dump(anno, f)
