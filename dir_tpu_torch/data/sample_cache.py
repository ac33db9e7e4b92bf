"""Packed pre-decoded sample cache: decode once, serve from mmap
(counterpart of ``dir_tpu/data/sample_cache.py``, same layout and
version, so either package reads the other's cache).

The per-sample host cost splits into a deterministic part (JPEG decode of
img/mask/dense and the numpy MANO GT from the stored parameters,
``InterHandDataset._load_raw``) and the per-epoch augmentation.
:func:`build_cache` runs the deterministic part once and packs it into
flat mmap-able ``.npy`` arrays; :class:`CachedInterHandDataset` then
serves ``_load_raw`` as a copy out of the page cache.

Layout of ``<data_path>/<split>/packed/``:
  img.npy, mask.npy, dense.npy    (N, S, S, 3) uint8
  gt.npy                          (N, GT_WIDTH) float32: verts/joints 3D
                                  and 2D of both hands, then the 3x3
                                  camera, packed flat per sample
  meta.json                       {"count", "img_size", "version"}
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from dir_tpu_torch.data.interhand import InterHandDataset
from dir_tpu_torch.mano.assets import ManoModel

_VERSION = 1

# per-hand: verts3d 778*3, joints3d 21*3, verts2d 778*2, joints2d 21*2
_SECTIONS = (("vl", (778, 3)), ("jl", (21, 3)),
             ("v2l", (778, 2)), ("j2l", (21, 2)),
             ("vr", (778, 3)), ("jr", (21, 3)),
             ("v2r", (778, 2)), ("j2r", (21, 2)),
             ("camera", (3, 3)))
GT_WIDTH = sum(int(np.prod(s)) for _, s in _SECTIONS)


def _pack_gt(raw) -> np.ndarray:
    (_, _, _, camera, vl, jl, v2l, j2l, vr, jr, v2r, j2r) = raw
    vals = {"vl": vl, "jl": jl, "v2l": v2l, "j2l": j2l,
            "vr": vr, "jr": jr, "v2r": v2r, "j2r": j2r, "camera": camera}
    return np.concatenate(
        [np.asarray(vals[k], np.float32).reshape(-1) for k, _ in _SECTIONS])


def _unpack_gt(row: np.ndarray):
    out = []
    ofs = 0
    for _, shape in _SECTIONS:
        n = int(np.prod(shape))
        out.append(row[ofs:ofs + n].reshape(shape).copy())
        ofs += n
    return out  # [vl, jl, v2l, j2l, vr, jr, v2r, j2r, camera]


def cache_dir(data_path: str, split: str) -> str:
    return osp.join(data_path, split, "packed")


def build_cache(data_path: str, split: str, mano_left: ManoModel,
                mano_right: ManoModel, img_size: int = 256,
                log_every: int = 1000) -> str:
    """One decode+MANO pass over the split -> packed/ arrays. Atomic:
    writes to packed.tmp/ and renames, so an interrupted build never
    leaves a half-cache that CachedInterHandDataset would trust."""
    ds = InterHandDataset(data_path, split, mano_left, mano_right,
                          img_size=img_size, augment_train=False)
    n = len(ds)
    final = cache_dir(data_path, split)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrs = {
        name: np.lib.format.open_memmap(
            osp.join(tmp, f"{name}.npy"), mode="w+", dtype=np.uint8,
            shape=(n, img_size, img_size, 3))
        for name in ("img", "mask", "dense")
    }
    gt = np.lib.format.open_memmap(osp.join(tmp, "gt.npy"), mode="w+",
                                   dtype=np.float32, shape=(n, GT_WIDTH))
    for i in range(n):
        raw = ds._load_raw(i)
        img, mask, dense = raw[0], raw[1], raw[2]
        arrs["img"][i] = img
        arrs["mask"][i] = mask
        arrs["dense"][i] = dense
        gt[i] = _pack_gt(raw)
        if log_every and (i + 1) % log_every == 0:
            print(f"sample_cache: {i + 1}/{n}")
    for a in arrs.values():
        a.flush()
    gt.flush()
    with open(osp.join(tmp, "meta.json"), "w") as f:
        json.dump({"count": n, "img_size": img_size,
                   "version": _VERSION}, f)
    if osp.isdir(final):
        import shutil
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


class CachedInterHandDataset(InterHandDataset):
    """InterHandDataset with ``_load_raw`` served from the packed cache.

    Output-identical to the JPEG-path dataset for the same
    (seed, idx, epoch): the augmentation and everything after
    ``_load_raw`` are inherited unchanged."""

    def __init__(self, data_path: str, split: str,
                 mano_left: ManoModel, mano_right: ManoModel,
                 img_size: int = 256, augment_train: bool = True,
                 seed: int = 25, native_warp: bool = False,
                 wire8: bool = False):
        super().__init__(data_path, split, mano_left, mano_right,
                         img_size=img_size, augment_train=augment_train,
                         seed=seed, native_warp=native_warp, wire8=wire8)
        d = cache_dir(data_path, split)
        meta_path = osp.join(d, "meta.json")
        if not osp.exists(meta_path):
            raise FileNotFoundError(
                f"no packed cache at {d}: run build_cache() first")
        with open(meta_path) as f:
            meta = json.load(f)
        if meta["version"] != _VERSION:
            raise ValueError(f"cache version {meta['version']} != "
                             f"{_VERSION}; rebuild {d}")
        if meta["img_size"] != img_size:
            raise ValueError(f"cache img_size {meta['img_size']} != "
                             f"requested {img_size}; rebuild {d}")
        # mmap mode "r": the OS page cache shares the arrays across
        # loader threads and processes; nothing is read until sliced
        self._mm = {name: np.load(osp.join(d, f"{name}.npy"),
                                  mmap_mode="r")
                    for name in ("img", "mask", "dense", "gt")}
        self.size = int(meta["count"])

    def _load_raw(self, idx: int):
        # .copy(): augmentation and seg decode downstream must never
        # see (or risk mutating) the shared mmap pages
        img = np.array(self._mm["img"][idx])
        mask = np.array(self._mm["mask"][idx])
        dense = np.array(self._mm["dense"][idx])
        (vl, jl, v2l, j2l, vr, jr, v2r, j2r,
         camera) = _unpack_gt(self._mm["gt"][idx])
        return (img, mask, dense, camera,
                vl, jl, v2l, j2l, vr, jr, v2r, j2r)
