"""InterHand2.6M processed-format dataset (counterpart of
``dir_tpu/data/interhand.py``).

Reads the on-disk layout of the reference's offline converter
({split}/{img,mask,dense,anno}/{idx}.{jpg,pkl}), synthesizes the GT
verts/joints from the stored MANO parameters with the host-side numpy
MANO and applies the training augmentation. Each sample is a flat dict of
numpy arrays, NHWC, ready to collate; for the same (seed, idx, epoch) it
equals the JAX package's bit for bit.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from glob import glob
from typing import Dict

import cv2 as cv
import numpy as np

from dir_tpu_torch.data import augment, native
from dir_tpu_torch.data.mano_np import NumpyMano
from dir_tpu_torch.mano.assets import ManoModel


def _load_anno(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


class InterHandDataset:
    """Training/eval dataset over the processed InterHand2.6M layout."""

    def __init__(self, data_path: str, split: str,
                 mano_left: ManoModel, mano_right: ManoModel,
                 img_size: int = 256, augment_train: bool = True,
                 seed: int = 25, native_warp: bool = False,
                 wire8: bool = False):
        assert split in ("train", "test", "val")
        # wire8: emit img/dense/seg as uint8 (the host pipeline's own
        # dtype up to its last normalize step) and let the train step
        # normalize on the device (train/steps.py:decode_wire8): the same
        # values, about 3.8x fewer host-to-device bytes per batch.
        self.wire8 = wire8
        self.data_path = data_path
        self.split = split
        self.img_size = img_size
        self.augment_train = augment_train and split == "train"
        # Route the aug warp through native/imageops.cpp instead of cv2
        # (same constant-border semantics; see augment.affine_3d).
        self.native_warp = native_warp
        self.mano = {"left": NumpyMano(mano_left),
                     "right": NumpyMano(mano_right)}
        self.size = len(glob(osp.join(data_path, split, "anno", "*.pkl")))
        self._seed = seed
        # Set by BatchLoader at the start of each epoch (and restored on
        # resume) — augmentation is a pure function of (seed, idx, epoch),
        # so an interrupted run replays the exact same aug stream.
        self.epoch = 0

    def _sample_rng(self, idx: int) -> np.random.RandomState:
        """Deterministic per-(seed, idx, epoch) RNG — thread-safe (no
        shared mutable state), varying across epochs, reproducible under
        checkpoint resume."""
        return np.random.RandomState(
            (self._seed * 1000003 + idx * 7919 + self.epoch * 104729)
            % (2 ** 31))

    def __len__(self) -> int:
        return self.size

    def _mano_gt(self, params: dict, hand: str, R: np.ndarray,
                 T: np.ndarray, camera: np.ndarray):
        """Stored MANO params -> camera-frame verts/joints + 2D pixels."""
        root = np.asarray(params["R"], np.float32).reshape(1, 3, 3)
        pose = np.asarray(params["pose"], np.float32).reshape(1, -1)
        shape = np.asarray(params["shape"], np.float32).reshape(1, 10)
        trans = np.asarray(params["trans"], np.float32).reshape(1, 3)
        verts, joints = self.mano[hand](root, pose, shape, trans=trans,
                                        center_idx=None)
        verts = verts[0] @ R.T + T
        joints = joints[0] @ R.T + T
        v2 = verts @ camera.T
        v2 = v2[:, :2] / v2[:, 2:]
        j2 = joints @ camera.T
        j2 = j2[:, :2] / j2[:, 2:]
        return verts, joints, v2, j2

    def _load_raw(self, idx: int):
        """Decode images and synthesize camera-frame MANO GT — the
        deterministic (epoch-independent) part of ``__getitem__``, and
        exactly what the packed sample cache stores
        (data/sample_cache.py)."""
        split = self.split
        img = cv.imread(osp.join(self.data_path, split, "img", f"{idx}.jpg"))
        mask = cv.imread(osp.join(self.data_path, split, "mask", f"{idx}.jpg"))
        dense = cv.imread(
            osp.join(self.data_path, split, "dense", f"{idx}.jpg"))
        data = _load_anno(
            osp.join(self.data_path, split, "anno", f"{idx}.pkl"))

        R = np.asarray(data["camera"]["R"], np.float32)
        T = np.asarray(data["camera"]["t"], np.float32)
        camera = np.asarray(data["camera"]["camera"], np.float32)

        vl, jl, v2l, j2l = self._mano_gt(data["mano_params"]["left"], "left",
                                         R, T, camera)
        vr, jr, v2r, j2r = self._mano_gt(data["mano_params"]["right"],
                                         "right", R, T, camera)
        return (img, mask, dense, camera,
                vl, jl, v2l, j2l, vr, jr, v2r, j2r)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        S = self.img_size
        (img, mask, dense, camera,
         vl, jl, v2l, j2l, vr, jr, v2r, j2r) = self._load_raw(idx)

        do_flip = False
        rng = self._sample_rng(idx)
        if self.augment_train:
            scale, rot, tx, ty, do_flip = augment.sample_aug_config(rng)
            if do_flip:
                imgs, labels = augment.flip_images_labels(
                    [img, mask, dense], [j2l, j2r, v2l, v2r], S)
                img, mask, dense = imgs
                j2r, j2l, v2r, v2l = labels
                jr, jl, vr, vl = jl, jr, vl, vr

            if rng.rand() <= 0.3:
                img = augment.motion_blur(img, rng)

            imgs, l2d, l3d = augment.affine_3d(
                rot, scale, tx, ty, camera, [img, mask, dense],
                [j2l, j2r, v2l, v2r],
                [jl[:, 2:], jr[:, 2:], vl[:, 2:], vr[:, 2:]], S,
                use_native=self.native_warp)
            img, mask, dense = imgs
            j2l, j2r, v2l, v2r = l2d
            jl, jr, vl, vr = l3d

        center_left = jl[9:10].copy()
        center_right = jr[9:10].copy()
        seg = native.seg_from_mask(mask, do_flip)

        # Photometric noise on the train split only, as the JAX package
        # does (the reference also adds it to the test split, a bug).
        if self.augment_train:
            img = augment.add_noise(img, rng, noise=0.01)

        if self.wire8:
            # ship the pipeline's uint8 (warp, blur and noise all emit
            # uint8) and normalize on the device: exact
            img_norm = np.ascontiguousarray(img, np.uint8)
            dense_norm = np.ascontiguousarray(dense, np.uint8)
            seg = seg.astype(np.uint8)
        else:
            img_norm = native.normalize_bgr(img, augment.IMAGENET_MEAN,
                                            augment.IMAGENET_STD)
            # Dense GT stays in the on-disk BGR order, as the reference
            # trains its dense head on it.
            dense_norm = dense.astype(np.float32) / 255.0

        def nuv(l2d, l3d):
            return np.concatenate(
                [l2d / S * 2 - 1, l3d[:, 2:]], axis=-1).astype(np.float32)

        return {
            "img": img_norm,
            "img_rgb": img[:, :, ::-1].astype(np.float32),
            "seg": seg,
            "dense": dense_norm,
            "joint_2d_left": nuv(j2l, jl),
            "joint_2d_right": nuv(j2r, jr),
            "mesh_2d_left": nuv(v2l, vl),
            "mesh_2d_right": nuv(v2r, vr),
            "joint_3d_left": jl.astype(np.float32),
            "joint_3d_right": jr.astype(np.float32),
            "mesh_3d_left": vl.astype(np.float32),
            "mesh_3d_right": vr.astype(np.float32),
            "center_left": center_left.astype(np.float32),
            "center_right": center_right.astype(np.float32),
            "camera": camera,
        }


class InterHandRawEval:
    """Eval dataset without augmentation, exposing the raw GT the metric
    harness needs."""

    def __init__(self, data_path: str, mano_left: ManoModel,
                 mano_right: ManoModel, split: str = "test",
                 img_size: int = 256, load_hms: bool = False):
        self.inner = InterHandDataset(data_path, split, mano_left, mano_right,
                                      img_size=img_size, augment_train=False)
        self.load_hms = load_hms
        self.img_size = img_size

    def __len__(self):
        return len(self.inner)

    def _read_hms(self, idx: int) -> Dict[str, np.ndarray]:
        """The 7 per-hand heatmap jpgs, resized to the image size, that the
        offline prepare step writes. Shape (7, S, S, 3)."""
        out = {}
        root = os.path.join(self.inner.data_path, self.inner.split, "hms")
        for hand in ("left", "right"):
            hms = []
            for h in range(7):
                p = os.path.join(root, f"{idx}_{h}_{hand}.jpg")
                hm = cv.imread(p)
                if hm.shape[0] != self.img_size:
                    hm = cv.resize(hm, (self.img_size, self.img_size))
                hms.append(hm)
            out[f"hms_{hand}"] = np.stack(hms).astype(np.float32)
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        s = self.inner[idx]
        out = {
            "img": s["img"],
            "joints_left_gt": s["joint_3d_left"],
            "joints_right_gt": s["joint_3d_right"],
            "verts_left_gt": s["mesh_3d_left"],
            "verts_right_gt": s["mesh_3d_right"],
            "camera": s["camera"],
        }
        if self.load_hms:
            out.update(self._read_hms(idx))
        return out
