"""Image/label augmentation, host-side numpy + cv2 (counterpart of
``dir_tpu/data/augment.py``).

The reference's training augmentation: horizontal flip with the
left/right swap, a global rotation/scale/translation affine with the 3D
labels re-lifted through the camera, motion blur and photometric noise.
The same numpy random draws, in the same order, as the JAX package.
"""

from __future__ import annotations

import math
from typing import List

import cv2 as cv
import numpy as np


def sample_aug_config(rng: np.random.RandomState, scale_factor: float = 0.1,
                      rot_factor: float = 180.0, transl_factor: float = 10.0,
                      flip: bool = True):
    """Random augmentation parameters (utils/utils.py:462-473)."""
    scale = 1.0 + (rng.rand() * 2 - 1) * scale_factor
    rot = (rng.rand() * 2 - 1) * rot_factor
    tx = (rng.rand() * 2 - 1) * transl_factor
    ty = (rng.rand() * 2 - 1) * transl_factor
    do_flip = bool(rng.rand() <= 0.5) if flip else False
    return scale, rot, tx, ty, do_flip


def get_affine_mat(theta: float, scale: float, u: float, v: float,
                   size: int) -> np.ndarray:
    """3x3 affine: rotate+scale about the image center then translate
    (utils/utils.py:298-347)."""
    t = np.deg2rad(theta)
    center = np.array([size / 2, size / 2, 1], np.float32)
    rot = np.array([[math.cos(t), -math.sin(t), 0],
                    [math.sin(t), math.cos(t), 0],
                    [0, 0, 1]], np.float32)
    rot[:2, 2] = ((np.identity(3, np.float32) - rot) @ center)[:2]
    sc = np.diag([scale, scale, 1.0]).astype(np.float32)
    sc[:2, 2] = ((np.identity(3, np.float32) - sc) @ center)[:2]
    tr = np.identity(3, np.float32)
    tr[0, 2] = u
    tr[1, 2] = v
    return tr @ sc @ rot


def rotation_mat3d(theta: float) -> np.ndarray:
    """In-plane 3D rotation used to update MANO global R
    (utils/utils.py:323-333)."""
    t = np.deg2rad(theta)
    m = np.zeros((3, 3), np.float32)
    m[0, 0] = math.cos(t)
    m[0, 1] = -math.sin(t)
    m[1, 0] = math.sin(t)
    m[1, 1] = math.cos(t)
    m[2, 2] = 1.0
    return m


def flip_images_labels(imgs: List[np.ndarray],
                       labels2d: List[np.ndarray], img_size: int):
    """Horizontal flip: x' = size - x - 1 (utils/utils.py:475-493)."""
    out_imgs = [img[:, ::-1].copy() for img in imgs]
    out_labels = []
    for lab in labels2d:
        lab = lab.copy()
        lab[:, 0:1] = img_size - lab[:, 0:1] - 1
        out_labels.append(lab)
    return out_imgs, out_labels


def affine_3d(theta: float, scale: float, u: float, v: float,
              camera: np.ndarray, imgs: List[np.ndarray],
              labels2d: List[np.ndarray], depths: List[np.ndarray],
              img_size: int, use_native: bool = False):
    """Affine-warp images + 2D labels, re-lift 3D through the intrinsics
    keeping depths fixed (utils/utils.py:405-441).

    use_native routes the warp through native/imageops.cpp (constant
    border, as cv2's default here; within 1 u8 LSB of cv2). cv2 stays the
    default."""
    m = get_affine_mat(theta, scale, u, v, img_size)
    if use_native:
        from dir_tpu_torch.data import native
        out_imgs = [native.affine_warp(img, m[:2], img_size,
                                       border="constant")
                    for img in imgs]
    else:
        out_imgs = [cv.warpAffine(img, m[:2], dsize=(img_size, img_size))
                    for img in imgs]
    out_2d, out_3d = [], []
    fx, fy = camera[0, 0], camera[1, 1]
    fu, fv = camera[0, 2], camera[1, 2]
    for lab, dep in zip(labels2d, depths):
        uv = lab @ m[:2, :2].T + m[:2, 2:3].T
        out_2d.append(uv)
        x = (uv[:, 0:1] - fu) * dep / fx
        y = (uv[:, 1:2] - fv) * dep / fy
        out_3d.append(np.concatenate([x, y, dep], axis=-1))
    return out_imgs, out_2d, out_3d


def motion_blur(img: np.ndarray, rng: np.random.RandomState,
                max_size: int = 10) -> np.ndarray:
    """Random line kernel blur (utils/utils.py:525-533)."""
    size = rng.randint(3, max_size)
    angle = rng.uniform(-180, 180)
    k = np.zeros((size, size), np.float32)
    k[(size - 1) // 2, :] = 1.0
    rot = cv.getRotationMatrix2D((size / 2 - 0.5, size / 2 - 0.5), angle, 1.0)
    k = cv.warpAffine(k, rot, (size, size))
    k = k / np.sum(k)
    return cv.filter2D(img, -1, k)


def add_noise(img: np.ndarray, rng: np.random.RandomState,
              noise: float = 0.0, scale: float = 255.0, alpha: float = 0.3,
              beta: float = 0.05) -> np.ndarray:
    """Brightness + gaussian noise (utils/utils.py:445-452)."""
    a = rng.uniform(1 - alpha, 1 + alpha, 3)
    b = scale * beta * (2 * rng.rand() - 1)
    out = a * img + b
    if noise > 0:
        out = out + scale * rng.normal(0.0, noise, img.shape)
    return np.clip(out, 0, scale).astype(np.uint8)


def seg_from_mask(mask: np.ndarray, flipped: bool) -> np.ndarray:
    """Decode the 3-class segmentation from the rendered mask colors
    (dataset/interhand.py:206-215): channel 1 (left) vs channel 2
    (right); a flip swaps the labels."""
    hand = np.logical_or(mask[:, :, 1] > 50, mask[:, :, 2] > 50)
    left = np.logical_and(hand, mask[:, :, 1] >= mask[:, :, 2])
    right = np.logical_and(hand, mask[:, :, 1] < mask[:, :, 2])
    seg = np.zeros(mask.shape[:2], np.int32)
    if flipped:
        seg[right] = 1
        seg[left] = 2
    else:
        seg[left] = 1
        seg[right] = 2
    return seg


# ImageNet statistics (dataset/interhand.py:108).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img_bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 HWC."""
    rgb = img_bgr[:, :, ::-1].astype(np.float32) / 255.0
    return (rgb - IMAGENET_MEAN) / IMAGENET_STD
