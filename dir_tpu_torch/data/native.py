"""ctypes binding of ``native/imageops.cpp`` with the numpy/cv2 routes
beside it (counterpart of ``dir_tpu/data/native.py``).

The library fuses the per-sample hot path of the host pipeline (affine
warp, normalize, seg decode). The port builds its own copy at first use
into ``<repo>/build/`` with ``native/Makefile``'s flags. Since those
include ``-march=native``, the file name carries a tag of the host's CPU,
so that a copy built on one machine is never loaded on another. Where no
compiler is present the numpy/cv2 implementations run instead, with the
same results (the tests hold the two routes against each other); which
route runs is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "imageops.cpp")
BUILD_DIR = os.path.join(_REPO, "build")
# native/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib = None          # the loaded library, False once it is known missing


def _host_tag() -> str:
    """A short tag of this host's CPU (model and instruction-set flags)."""
    info = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    info += line
                    if line.startswith(("flags", "Features")):
                        break
    except OSError:
        pass
    return hashlib.sha1(info.encode()).hexdigest()[:10]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libimageops-{_host_tag()}.so")


def build() -> str:
    """Compile the library unless it is newer than the source; returns its
    path. Raises ``FileNotFoundError`` without a compiler and
    ``subprocess.CalledProcessError`` when the compiler fails."""
    lib = library_path()
    if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(
            SOURCE):
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++/c++) on the PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, lib)
    return lib


def _load():
    """The library, or None where it cannot be built; logs the route."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                path = build()
                lib = ctypes.CDLL(path)
            except (OSError, subprocess.SubprocessError) as e:
                _log.warning("imageops: native library unavailable (%s); "
                             "the numpy/cv2 routes run", e)
                _lib = False
                return None
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            ci = ctypes.c_int
            lib.affine_warp_u8.argtypes = [u8p, ci, ci, u8p, ci, ci, f32p, ci]
            lib.normalize_bgr_u8.argtypes = [u8p, ci, ci, f32p, f32p, f32p]
            lib.seg_from_mask_u8.argtypes = [u8p, ci, ci, ci, i32p]
            for fn in (lib.affine_warp_u8, lib.normalize_bgr_u8,
                       lib.seg_from_mask_u8):
                fn.restype = None
            _log.info("imageops: native library %s", path)
            _lib = lib
        return _lib or None


def available() -> bool:
    return _load() is not None


def affine_warp(img: np.ndarray, m2x3: np.ndarray, out_size: int,
                border: str = "constant") -> np.ndarray:
    """Bilinear affine warp of an (H, W, 3) uint8 image by the forward
    2x3 matrix, as cv2.warpAffine's INTER_LINEAR (native or cv2).
    border "constant" fills zeros, "replicate" repeats the edge."""
    lib = _load()
    if lib is None:
        import cv2 as cv
        mode = (cv.BORDER_REPLICATE if border == "replicate"
                else cv.BORDER_CONSTANT)
        return cv.warpAffine(img, m2x3, dsize=(out_size, out_size),
                             flags=cv.INTER_LINEAR, borderMode=mode)
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    out = np.empty((out_size, out_size, 3), np.uint8)
    lib.affine_warp_u8(img, img.shape[0], img.shape[1], out, out_size,
                       out_size, np.ascontiguousarray(m2x3, np.float32),
                       1 if border == "replicate" else 0)
    return out


def normalize_bgr(img: np.ndarray, mean, std) -> np.ndarray:
    """BGR uint8 -> normalized RGB float32 (native or numpy)."""
    lib = _load()
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if lib is None:
        rgb = img[:, :, ::-1].astype(np.float32) / 255.0
        return (rgb - mean) / std
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape[:2] + (3,), np.float32)
    lib.normalize_bgr_u8(img, img.shape[0], img.shape[1], out, mean, std)
    return out


def seg_from_mask(mask: np.ndarray, flipped: bool) -> np.ndarray:
    """3-class seg decode of an (H, W, 3) uint8 mask (native or numpy)."""
    lib = _load()
    if lib is None:
        from dir_tpu_torch.data.augment import seg_from_mask as np_impl
        return np_impl(mask, flipped)
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(mask.shape[:2], np.int32)
    lib.seg_from_mask_u8(mask, mask.shape[0], mask.shape[1], int(flipped),
                         out)
    return out
