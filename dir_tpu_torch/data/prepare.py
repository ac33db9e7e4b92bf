"""Offline InterHand2.6M conversion: raw release -> processed layout
(the port's copy of ``dir_tpu/data/prepare.py``, on the port's MANO
assets, ``mano_np`` and ``rasterizer``).

Reimplements dataset/prepare_data.py: parse the InterHand2.6M annotation
JSONs, select valid interacting two-hand frames, run MANO to get GT
verts, crop to img_size around both hands with intrinsics rewrite, write
``{split}/{img,anno}/{idx}.{jpg,pkl}``, then render per-frame GT ``mask``
and ``dense`` images — with the numpy rasterizer instead of pytorch3d.

Run once per split: ``prepare_split(raw_root, save_dir, split, mano_left,
mano_right)`` with the pair of ``mano.assets.load_mano_pair``.
"""

from __future__ import annotations

import json
import os
import pickle

import cv2 as cv
import numpy as np

from dir_tpu_torch.data.mano_np import NumpyMano
from dir_tpu_torch.data.rasterizer import (dense_colors, mask_colors,
                                           render_two_hands)
from dir_tpu_torch.mano.assets import ManoModel

IMG_SIZE = 256
CROP_RATIO = 0.8    # HAND_BBOX_RATIO (dataset/dataset_utils.py:6)
HEATMAP_SIZE = 64   # dataset/dataset_utils.py:7
HEATMAP_SIGMA = 2   # dataset/dataset_utils.py:8


def joint_heatmaps(joints2d: np.ndarray, img_size: int = IMG_SIZE,
                   hm_size: int = HEATMAP_SIZE,
                   sigma: float = HEATMAP_SIGMA) -> np.ndarray:
    """(21, 2) pixel joints -> (21, hm, hm) gaussian heatmaps.

    The reference's eval dataset READS 7 packed heatmap jpgs per hand
    (dataset/interhand.py:62-66) but its prepare step never writes them
    (prepare_data.py:179 creates the dir only) — we close that gap:
    21 channels packed 3-per-jpg into 7 files.
    """
    scale = hm_size / img_size
    yy, xx = np.mgrid[0:hm_size, 0:hm_size]
    maps = []
    for j in joints2d:
        cx, cy = j[0] * scale, j[1] * scale
        d2 = (xx - cx) ** 2 + (yy - cy) ** 2
        maps.append(np.exp(-d2 / (2.0 * sigma ** 2)))
    return np.stack(maps).astype(np.float32)


def cut_two_hand_img(img, label2d_list, camera, img_size=IMG_SIZE,
                     ratio=CROP_RATIO):
    """Crop the union bbox of both hands to a square, rewriting the
    intrinsics (dataset/dataset_utils.py:26-58)."""
    mins = np.min([l.min(0) for l in label2d_list], axis=0)
    maxs = np.max([l.max(0) for l in label2d_list], axis=0)
    mid = (mins + maxs) / 2
    half = np.max(maxs - mins) / 2 / ratio
    scale = img_size / 2 / half
    m = scale * np.array([[1, 0, half - mid[0]], [0, 1, half - mid[1]]],
                         np.float32)
    out = cv.warpAffine(img, m, dsize=(img_size, img_size))
    label_out = []
    for lab in label2d_list:
        x = np.concatenate([lab, np.ones_like(lab[:, :1])], axis=-1)
        label_out.append(x @ m.T)
    cam = camera.copy()
    cam[0, 0] *= m[0, 0]
    cam[1, 1] *= m[1, 1]
    cam[0, 2] = cam[0, 2] * m[0, 0] + m[0, 2]
    cam[1, 2] = cam[1, 2] * m[1, 1] + m[1, 2]
    return out, label_out, cam


def _j21_regressor(mano: NumpyMano) -> np.ndarray:
    """(21, 778) joint regressor: 16 MANO rows + 5 fingertip one-hots,
    reordered to the 21-joint convention (apps/eval.py:27-41)."""
    base = mano.j_regressor.astype(np.float32)
    tips = np.zeros((5, base.shape[1]), np.float32)
    for i, v in enumerate((745, 317, 444, 556, 673)):
        tips[i, v] = 1.0
    j21 = np.concatenate([base, tips], axis=0)
    order = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
             10, 11, 12, 19, 7, 8, 9, 20]
    return j21[order]


class InterHandRawLoader:
    """Reader over the raw InterHand2.6M release (annotations/{split}/
    InterHand2.6M_{split}_{data,camera,MANO_NeuralAnnot}.json)
    (reference: prepare_data.py:27-120)."""

    def __init__(self, root: str, split: str):
        self.root = root
        self.split = split
        self.img_root = os.path.join(root, "images", split)
        anno = os.path.join(root, "annotations", split)
        with open(os.path.join(
                anno, f"InterHand2.6M_{split}_data.json")) as f:
            self.data = json.load(f)
        with open(os.path.join(
                anno, f"InterHand2.6M_{split}_camera.json")) as f:
            self.cameras = json.load(f)
        with open(os.path.join(
                anno, f"InterHand2.6M_{split}_MANO_NeuralAnnot.json")) as f:
            self.mano_params = json.load(f)

    def __len__(self):
        return len(self.data["images"])

    def camera_of(self, capture_id: str, cam_id: str):
        cam = self.cameras[capture_id]
        # InterHand convention: campos in mm, camrot world->cam rows.
        t = -np.asarray(cam["camrot"][cam_id], np.float32) @ np.asarray(
            cam["campos"][cam_id], np.float32) / 1000.0
        R = np.asarray(cam["camrot"][cam_id], np.float32)
        fx, fy = cam["focal"][cam_id]
        cx, cy = cam["princpt"][cam_id]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        return R, t, K

    def frame(self, idx: int):
        img_info = self.data["images"][idx]
        ann = self.data["annotations"][idx]
        capture_id = str(img_info["capture"])
        cam_id = img_info["camera"]
        img_path = os.path.join(self.img_root, img_info["file_name"])
        frame_id = str(img_info["frame_idx"])
        hand_type = ann["hand_type"]
        valid = bool(ann["hand_type_valid"])
        mano = self.mano_params.get(capture_id, {}).get(frame_id)
        return {
            "img_path": img_path,
            "hand_type": hand_type,
            "valid": valid,
            "camera": self.camera_of(capture_id, cam_id),
            "mano": mano,
        }


def prepare_split(root: str, save_dir: str, split: str,
                  mano_left: ManoModel, mano_right: ManoModel,
                  max_samples: int | None = None,
                  render: bool = True) -> int:
    """Convert one split; returns the number of frames written."""
    loader = InterHandRawLoader(root, split)
    manos = {"left": NumpyMano(mano_left), "right": NumpyMano(mano_right)}
    faces = manos["left"].faces
    for sub in ("img", "mask", "dense", "anno", "hms"):
        os.makedirs(os.path.join(save_dir, split, sub), exist_ok=True)

    idx_out = 0
    for i in range(len(loader)):
        if max_samples is not None and idx_out >= max_samples:
            break
        fr = loader.frame(i)
        if fr["hand_type"] != "interacting" or not fr["valid"]:
            continue
        if fr["mano"] is None or any(
                fr["mano"].get(h) is None for h in ("left", "right")):
            continue
        img = cv.imread(fr["img_path"])
        if img is None:
            continue
        R, t, K = fr["camera"]

        params, verts2d, verts_cam = {}, [], {}
        for hand in ("left", "right"):
            mp = fr["mano"][hand]
            mano = manos[hand]
            pose_full = np.asarray(mp["pose"], np.float32).reshape(1, -1)
            root_rot = NumpyMano.rodrigues(pose_full[:, :3])
            # Stored pose is PCA, computed as in the reference:
            # axis2pca(raw_axis + hands_mean) (prepare_data.py:103-104).
            pca = mano.axis_to_pca(
                pose_full[:, 3:48] + mano.hands_mean[None]).astype(
                np.float32)
            shape = np.asarray(mp["shape"], np.float32).reshape(1, 10)
            trans = np.asarray(mp["trans"], np.float32).reshape(1, 3)
            verts, _ = mano(root_rot, pca, shape, trans=trans,
                            center_idx=None, use_pca=True)
            v_cam = verts[0] @ R.T + t
            p = v_cam @ K.T
            verts2d.append(p[:, :2] / p[:, 2:])
            verts_cam[hand] = v_cam
            params[hand] = {"R": root_rot.astype(np.float32),
                            "pose": pca, "shape": shape, "trans": trans}

        crop, labels_out, K_new = cut_two_hand_img(img, verts2d, K)
        cv.imwrite(os.path.join(save_dir, split, "img", f"{idx_out}.jpg"),
                   crop)
        # Schema matches the reference's anno pkl (prepare_data.py:157-164)
        anno = {"inter_idx": idx_out,
                "image": fr.get("image_info"),
                "annotation": fr.get("annotation"),
                "camera": {"R": R, "t": t, "camera": K_new},
                "mano_params": params}
        with open(os.path.join(save_dir, split, "anno",
                               f"{idx_out}.pkl"), "wb") as f:
            pickle.dump(anno, f)

        # Per-hand joint heatmaps, 21 channels packed 3-per-jpg
        # (the eval dataset's 7-file layout, dataset/interhand.py:62-66).
        for hand in ("left", "right"):
            verts_h = verts_cam[hand]
            j21 = np.einsum("jv,vc->jc",
                            _j21_regressor(manos[hand]), verts_h)
            p = j21 @ K_new.T
            j2d = p[:, :2] / p[:, 2:]
            hms = joint_heatmaps(j2d)
            for h_idx in range(7):
                pack = np.transpose(hms[3 * h_idx:3 * h_idx + 3],
                                    (1, 2, 0))
                cv.imwrite(os.path.join(
                    save_dir, split, "hms",
                    f"{idx_out}_{h_idx}_{hand}.jpg"),
                    (pack * 255).astype(np.uint8))

        if render:
            nv = verts_cam["left"].shape[0]
            mask_img, _ = render_two_hands(
                verts_cam["left"], verts_cam["right"], faces, K_new,
                IMG_SIZE, mask_colors(nv, "left"), mask_colors(nv, "right"))
            dense_l = dense_colors(manos["left"].v_template.astype(np.float32))
            dense_r = dense_colors(manos["right"].v_template.astype(np.float32))
            dense_img, _ = render_two_hands(
                verts_cam["left"], verts_cam["right"], faces, K_new,
                IMG_SIZE, dense_l, dense_r)
            cv.imwrite(os.path.join(save_dir, split, "mask",
                                    f"{idx_out}.jpg"),
                       (mask_img * 255).astype(np.uint8))
            cv.imwrite(os.path.join(save_dir, split, "dense",
                                    f"{idx_out}.jpg"),
                       (dense_img * 255).astype(np.uint8))
        idx_out += 1
    return idx_out
