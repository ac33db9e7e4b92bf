"""The port's data side against the JAX package on the CPU: the data-side
geometry (rotations, the rotation-matrix MANO API, local frames), the MANO
assets (pickle conversion, tips), the numpy MANO, the synthetic writer,
the host dataset (train and test, epochs 0 and 1, wire8, native warp), the
raw eval dataset, the packed cache, the native binding, the loader and the
config file.

Tolerances: the geometry is held at fp32 to a few ulps of its values
(measured max abs errors in brackets, seed 25) and at fp64 to 1e-14; every
host-pipeline output (NumpyMano, the synthetic files, dataset samples, the
cache, the loader's batches, the native binding) is bit-equal.
"""

import dataclasses
import json
import os
import pickle
import sys
import threading
import time
import types

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch
from scipy.spatial.transform import Rotation as R

from dir_tpu import config as jconfig
from dir_tpu.data import augment as jaugment
from dir_tpu.data import native as jnative
from dir_tpu.data import sample_cache as jcache
from dir_tpu.data import synthetic as jsynthetic
from dir_tpu.data.interhand import InterHandDataset as JDataset
from dir_tpu.data.interhand import InterHandRawEval as JRawEval
from dir_tpu.data.loader import BatchLoader as JLoader
from dir_tpu.data.mano_np import NumpyMano as JNumpyMano
from dir_tpu.mano import assets as jassets
from dir_tpu.mano import frames as jframes
from dir_tpu.mano import layer as jlayer
from dir_tpu.ops import rotation as jrot

from dir_tpu_torch import config as tconfig
from dir_tpu_torch.data import augment as taugment
from dir_tpu_torch.data import native as tnative
from dir_tpu_torch.data import sample_cache as tcache
from dir_tpu_torch.data import synthetic as tsynthetic
from dir_tpu_torch.data.interhand import InterHandDataset, InterHandRawEval
from dir_tpu_torch.data.loader import BatchLoader
from dir_tpu_torch.data.mano_np import NumpyMano
from dir_tpu_torch.mano import assets as tassets
from dir_tpu_torch.mano import frames as tframes
from dir_tpu_torch.mano import layer as tlayer
from dir_tpu_torch.ops import rotation as trot

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads, x64  # noqa: E402

# fp32 bounds [measured]: rotations 2e-6 [2.4e-7], the SVD projection 5e-6
# [1.4e-6, reflections included], MANO rotmat API 1e-6 m [2.4e-7],
# axis_to_pca 5e-6 [8.6e-7, through a 45x45 inverse], local frames 1e-5
# [1.7e-6]; fp64 1e-14 [3.3e-15], the SVD projection 2e-14 [3.8e-15].
TOL = {np.float32: {"rot": 2e-6, "svd": 5e-6, "mano": 1e-6, "pca": 5e-6,
                    "frames": 1e-5},
       np.float64: {"rot": 1e-14, "svd": 2e-14, "mano": 1e-14, "pca": 1e-14,
                    "frames": 1e-14}}
N_TRAIN, N_TEST = 6, 5


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _equal_dicts(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert np.asarray(g).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(g, want[k], err_msg=k)


def _manos(tips=None):
    jr = jassets.synthetic_mano("right", seed=0, tips=tips)
    jl = jassets.fix_left_shapedirs(
        jassets.synthetic_mano("left", seed=0, tips=tips), jr)
    tr = tassets.synthetic_mano("right", seed=0, tips=tips)
    tl = tassets.fix_left_shapedirs(
        tassets.synthetic_mano("left", seed=0, tips=tips), tr)
    return (jl, jr), (tl, tr)


@pytest.fixture(scope="module")
def manos():
    """((jax left, right), (port left, right)), data-side tips."""
    return _manos(jassets.TIPS_DATA)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory, manos):
    """A synthetic split written by the port's writer."""
    _, (tl, tr) = manos
    d = str(tmp_path_factory.mktemp("port_data"))
    tsynthetic.generate(d, tl, tr, split="train", num_samples=N_TRAIN)
    tsynthetic.generate(d, tl, tr, split="test", num_samples=N_TEST, seed=7)
    return d


# -- geometry ----------------------------------------------------------------

def _rotation_inputs(name, dtype):
    rng = np.random.RandomState(25)
    if name == "rodrigues":
        x = rng.randn(32, 3) * 2.0
    elif name == "rot6d_to_rotmat_gs":
        x = rng.randn(64, 6)
    elif name == "rotmat_to_axis_angle":
        angles = rng.uniform(0.2, 2.6, size=24)
        axes = rng.randn(24, 3)
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        x = R.from_rotvec(axes * angles[:, None]).as_matrix()
    elif name == "rotation_project":
        x = (R.random(8, random_state=3).as_matrix()
             + rng.randn(8, 3, 3) * 0.05)
        x[:4, :, 2] *= -1   # reflections project to det +1 too
    elif name == "subtract_flat_id":
        x = rng.randn(4, 135)
    else:
        x = rng.randn(4, 45)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("name", ["rodrigues", "rot6d_to_rotmat_gs",
                                  "rotmat_to_axis_angle", "rotation_project",
                                  "subtract_flat_id", "posemap_axisang"])
def test_rotation_matches_jax(name, dtype):
    x = _rotation_inputs(name, dtype)
    with x64(dtype == np.float64):
        want = getattr(jrot, name)(jnp.asarray(x))
        want = [np.asarray(a) for a in (want if isinstance(want, tuple)
                                        else (want,))]
    got = getattr(trot, name)(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        key = "svd" if name == "rotation_project" else "rot"
        assert _err(g.numpy(), w) <= TOL[dtype][key], name


def _mano_pair(dtype):
    jm = jassets.synthetic_mano("right", seed=13)
    tm = tassets.synthetic_mano("right", seed=13)
    if dtype == np.float64:
        jm = jax.tree.map(lambda a: (jnp.asarray(a, jnp.float64)
                                     if jnp.issubdtype(a.dtype, jnp.floating)
                                     else a), jm)
        tm = tassets.ManoModel(*(a.double() if a.is_floating_point() else a
                                 for a in tm))
    return jm, tm


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["fp32", "fp64"])
@pytest.mark.parametrize("api", ["rotmat_pca", "rotmat_mats", "rotmats_proj",
                                 "axis_to_pca", "local_frames"])
def test_mano_data_side_matches_jax(api, dtype):
    rng = np.random.RandomState(25)
    b = 3
    root = R.random(b, random_state=7).as_matrix().astype(dtype)
    pca = (rng.randn(b, 45) * 0.5).astype(dtype)
    shape = rng.randn(b, 10).astype(dtype)
    trans = rng.randn(b, 3).astype(dtype)
    scale = rng.uniform(0.8, 1.2, b).astype(dtype)
    local = R.random(b * 15, random_state=2).as_matrix().reshape(
        b, 15, 3, 3).astype(dtype)
    noisy = (R.random(b * 16, random_state=9).as_matrix().reshape(
        b, 16, 3, 3) + rng.randn(b, 16, 3, 3) * 0.02).astype(dtype)
    J, T = jnp.asarray, torch.from_numpy
    with x64(dtype == np.float64):
        jm, tm = _mano_pair(dtype)
        if api == "rotmat_pca":
            want = jlayer.mano_forward_rotmat(jm, J(root), J(pca), J(shape),
                                              trans=J(trans), scale=J(scale))
            got = tlayer.mano_forward_rotmat(tm, T(root), T(pca), T(shape),
                                             trans=T(trans), scale=T(scale))
        elif api == "rotmat_mats":
            want = jlayer.mano_forward_rotmat(jm, J(root), J(local), J(shape),
                                              center_idx=None, use_pca=False)
            got = tlayer.mano_forward_rotmat(tm, T(root), T(local), T(shape),
                                             center_idx=None, use_pca=False)
        elif api == "rotmats_proj":
            want = jlayer.mano_forward_rotmats_proj(jm, J(noisy), J(shape))
            got = tlayer.mano_forward_rotmats_proj(tm, T(noisy), T(shape))
        elif api == "axis_to_pca":
            want = (jlayer.axis_to_pca(jm, J(pca)),)
            got = (tlayer.axis_to_pca(tm, T(pca)),)
        else:
            want = (jframes.local_frames(jm, J(shape)),)
            got = (tframes.local_frames(tm, T(shape)),)
        want = [np.asarray(w) for w in want]
    key = {"axis_to_pca": "pca", "local_frames": "frames"}.get(api, "mano")
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _err(g.numpy(), w) <= TOL[dtype][key], api


# -- assets ------------------------------------------------------------------

def _chumpy_pickle(path: str, model) -> dict:
    """Write an official-style MANO pickle: shapedirs as a chumpy Select
    over a Ch, J_regressor scipy-sparse, the rest plain arrays. Stand-in
    ``chumpy`` modules exist only while the file is written."""
    arrays = {k: np.asarray(getattr(model, a), np.float64) for k, a in (
        ("v_template", "v_template"), ("shapedirs", "shapedirs"),
        ("posedirs", "posedirs"), ("J_regressor", "j_regressor"),
        ("weights", "weights"), ("hands_components", "hands_components"),
        ("hands_mean", "hands_mean"))}
    mods = {n: types.ModuleType(n) for n in ("chumpy", "chumpy.ch",
                                              "chumpy.reordering")}

    class Ch:
        pass

    class Select:
        pass

    for cls, mod in ((Ch, "chumpy.ch"), (Select, "chumpy.reordering")):
        cls.__module__, cls.__qualname__ = mod, cls.__name__
        setattr(mods[mod], cls.__name__, cls)
    flat = Ch()
    flat.__dict__["x"] = arrays["shapedirs"].ravel()[::-1].copy()
    sel = Select()
    n = flat.__dict__["x"].size
    sel.__dict__.update(a=flat, idxs=(n - 1 - np.arange(n)).reshape(
        arrays["shapedirs"].shape))
    raw = dict(arrays, shapedirs=sel,
               J_regressor=scipy.sparse.csc_matrix(arrays["J_regressor"]),
               f=np.asarray(model.faces, np.uint32))
    saved = {n: sys.modules.get(n) for n in mods}
    sys.modules.update(mods)
    try:
        with open(path, "wb") as f:
            pickle.dump(raw, f, protocol=2)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n)
            else:
                sys.modules[n] = m
    return arrays


def test_convert_mano_pkl_matches_jax(tmp_path, manos):
    (jl, jr), _ = manos
    for side, model in (("LEFT", jl), ("RIGHT", jr)):
        pkl = str(tmp_path / f"MANO_{side}.pkl")
        arrays = _chumpy_pickle(pkl, model)
        tassets.convert_mano_pkl(pkl, str(tmp_path / f"port_{side}.npz"),
                                 side.lower())
        jassets.convert_mano_pkl(pkl, str(tmp_path / f"jax_{side}.npz"),
                                 side.lower())
        with np.load(tmp_path / f"port_{side}.npz") as got, \
                np.load(tmp_path / f"jax_{side}.npz") as want:
            assert got.files == want.files
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(
                got["shapedirs"], arrays["shapedirs"].astype(np.float32))


@pytest.mark.parametrize("tips_style", ["network", "data"])
@pytest.mark.parametrize("fmt", ["npz", "pkl"])
def test_load_mano_pair_matches_jax(tmp_path, manos, tips_style, fmt):
    (jl, jr), _ = manos
    for side, model in (("LEFT", jl), ("RIGHT", jr)):
        pkl = str(tmp_path / f"MANO_{side}.pkl")
        _chumpy_pickle(pkl, model)
        if fmt == "npz":
            tassets.convert_mano_pkl(pkl, str(tmp_path / f"MANO_{side}.npz"),
                                     side.lower())
            os.remove(pkl)
    want = jassets.load_mano_pair(str(tmp_path), tips_style=tips_style)
    got = tassets.load_mano_pair(str(tmp_path), tips_style=tips_style)
    for g, w in zip(got, want):
        for name in tassets.ManoModel._fields:
            np.testing.assert_array_equal(getattr(g, name).numpy(),
                                          np.asarray(getattr(w, name)),
                                          err_msg=name)
    tips = ((jassets.TIPS_DATA, jassets.TIPS_DATA) if tips_style == "data"
            else (jassets.TIPS_LEFT, jassets.TIPS_RIGHT))
    assert tuple(got[0].tips.tolist()) == tips[0]
    assert tuple(got[1].tips.tolist()) == tips[1]
    assert tassets.MANO_PARENTS == jassets.MANO_PARENTS


def test_load_mano_pair_missing(tmp_path):
    with pytest.raises(FileNotFoundError, match="MANO_LEFT"):
        tassets.load_mano_pair(str(tmp_path))


# -- host pipeline -----------------------------------------------------------

@pytest.mark.parametrize("center_idx,use_pca,new_skel",
                         [(None, True, False), (9, True, True),
                          (0, False, False)])
def test_numpy_mano_bit_equal(manos, center_idx, use_pca, new_skel):
    (_, jr), (_, tr) = manos
    rng = np.random.RandomState(3)
    b = 3
    root = R.random(b, random_state=3).as_matrix().astype(np.float32)
    pose = (rng.randn(b, 45) * 0.3).astype(np.float32)
    if not use_pca:
        pose = R.random(b * 15, random_state=4).as_matrix().reshape(
            b, 15, 3, 3).astype(np.float32)
    args = (root, pose, rng.randn(b, 10).astype(np.float32))
    kw = dict(trans=rng.randn(b, 3).astype(np.float32),
              scale=rng.uniform(0.9, 1.1, b).astype(np.float32),
              center_idx=center_idx, use_pca=use_pca, new_skel=new_skel)
    got = NumpyMano(tr)(*args, **kw)
    want = JNumpyMano(jr)(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    axis = pose.reshape(b, -1)[:, :45]
    np.testing.assert_array_equal(NumpyMano(tr).axis_to_pca(axis),
                                  JNumpyMano(jr).axis_to_pca(axis))


def test_synthetic_files_match_jax(tmp_path, manos):
    (jl, jr), (tl, tr) = manos
    tsynthetic.generate(str(tmp_path / "port"), tl, tr, split="train",
                        num_samples=3, seed=4)
    jsynthetic.generate(str(tmp_path / "jax"), jl, jr, split="train",
                        num_samples=3, seed=4)
    for sub in ("img", "mask", "dense", "anno"):
        names = sorted(os.listdir(tmp_path / "jax" / "train" / sub))
        assert sorted(os.listdir(tmp_path / "port" / "train" / sub)) == names
        for name in names:
            got = str(tmp_path / "port" / "train" / sub / name)
            want = str(tmp_path / "jax" / "train" / sub / name)
            if sub == "anno":
                with open(got, "rb") as f:
                    g = pickle.load(f)
                with open(want, "rb") as f:
                    w = pickle.load(f)
                for part in ("camera", "mano_params"):
                    for k in w[part]:
                        inner = w[part][k]
                        if isinstance(inner, dict):
                            for kk in inner:
                                np.testing.assert_array_equal(
                                    g[part][k][kk], inner[kk])
                        else:
                            np.testing.assert_array_equal(g[part][k], inner)
            else:
                np.testing.assert_array_equal(cv.imread(got), cv.imread(want))


@pytest.mark.parametrize("split,epoch,wire8,native_warp", [
    ("train", 0, False, False), ("train", 1, False, False),
    ("train", 0, True, False), ("train", 1, True, False),
    ("train", 0, False, True), ("train", 1, True, True),
    ("test", 0, False, False), ("test", 0, True, False)])
def test_dataset_bit_equal(data_dir, manos, split, epoch, wire8, native_warp):
    (jl, jr), (tl, tr) = manos
    kw = dict(seed=25, wire8=wire8, native_warp=native_warp)
    got = InterHandDataset(data_dir, split, tl, tr, **kw)
    want = JDataset(data_dir, split, jl, jr, **kw)
    got.epoch = want.epoch = epoch
    assert len(got) == len(want) == (N_TRAIN if split == "train" else N_TEST)
    for i in range(len(want)):
        _equal_dicts(got[i], want[i])
    if wire8:
        s = got[0]
        assert s["img"].dtype == s["dense"].dtype == s["seg"].dtype == np.uint8


def test_raw_eval_bit_equal(data_dir, manos):
    (jl, jr), (tl, tr) = manos
    got = InterHandRawEval(data_dir, tl, tr)
    want = JRawEval(data_dir, jl, jr)
    for i in range(len(want)):
        _equal_dicts(got[i], want[i])


def test_build_cache_matches_jax(tmp_path, manos):
    (jl, jr), (tl, tr) = manos
    for tag in ("port", "jax"):
        tsynthetic.generate(str(tmp_path / tag), tl, tr, split="train",
                            num_samples=3)
    tcache.build_cache(str(tmp_path / "port"), "train", tl, tr, log_every=0)
    jcache.build_cache(str(tmp_path / "jax"), "train", jl, jr, log_every=0)
    got_dir = tcache.cache_dir(str(tmp_path / "port"), "train")
    want_dir = jcache.cache_dir(str(tmp_path / "jax"), "train")
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    for name in os.listdir(want_dir):
        with open(os.path.join(got_dir, name), "rb") as g, \
                open(os.path.join(want_dir, name), "rb") as w:
            assert g.read() == w.read(), name
    assert tcache.GT_WIDTH == jcache.GT_WIDTH


@pytest.mark.parametrize("epoch", [0, 1])
def test_cached_dataset_equals_jpeg_path(tmp_path, manos, epoch):
    _, (tl, tr) = manos
    d = str(tmp_path)
    tsynthetic.generate(d, tl, tr, split="train", num_samples=3)
    tcache.build_cache(d, "train", tl, tr, log_every=0)
    got = tcache.CachedInterHandDataset(d, "train", tl, tr, seed=25)
    want = InterHandDataset(d, "train", tl, tr, seed=25)
    got.epoch = want.epoch = epoch
    for i in range(len(want)):
        _equal_dicts(got[i], want[i])
    with pytest.raises(ValueError, match="img_size"):
        tcache.CachedInterHandDataset(d, "train", tl, tr, img_size=128)


def test_native_binding_matches_jax():
    """The port's build of native/imageops.cpp against the JAX package's
    binding (same source) and against the port's own cv2/numpy routes."""
    assert tnative.available() and jnative.available()
    rng = np.random.RandomState(25)
    img = rng.randint(0, 255, (96, 96, 3)).astype(np.uint8)
    for theta, scale, u, v in ((25.0, 1.1, 3.0, -2.0), (-137.0, 0.92, -9.5,
                                                         7.25)):
        m = taugment.get_affine_mat(theta, scale, u, v, 96)[:2]
        for border in ("constant", "replicate"):
            got = tnative.affine_warp(img, m, 96, border=border)
            np.testing.assert_array_equal(
                got, jnative.affine_warp(img, m, 96, border=border))
            mode = (cv.BORDER_REPLICATE if border == "replicate"
                    else cv.BORDER_CONSTANT)
            want = cv.warpAffine(img, m, dsize=(96, 96),
                                 flags=cv.INTER_LINEAR, borderMode=mode)
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.002
    mean, std = taugment.IMAGENET_MEAN, taugment.IMAGENET_STD
    got = tnative.normalize_bgr(img, mean, std)
    np.testing.assert_array_equal(got, jnative.normalize_bgr(img, mean, std))
    np.testing.assert_allclose(got, taugment.normalize_image(img), atol=1e-6)
    for flipped in (False, True):
        got = tnative.seg_from_mask(img, flipped)
        np.testing.assert_array_equal(got, jnative.seg_from_mask(img, flipped))
        np.testing.assert_array_equal(got, taugment.seg_from_mask(img,
                                                                  flipped))
        np.testing.assert_array_equal(got, jaugment.seg_from_mask(img,
                                                                  flipped))
    assert os.path.basename(tnative.library_path()).startswith("libimageops-")


def test_native_library_rebuilds_from_source():
    """A stale library (older than the source) is rebuilt into place."""
    lib = tnative.build()
    os.utime(lib, (0, 0))
    assert tnative.build() == lib
    assert os.path.getmtime(lib) >= os.path.getmtime(tnative.SOURCE)


# -- loader ------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_matches_jax(data_dir, manos, shuffle, drop_last):
    (jl, jr), (tl, tr) = manos
    split = "train" if shuffle else "test"
    kw = dict(batch_size=2, shuffle=shuffle, drop_last=drop_last,
              num_threads=2, seed=7, pad_last=not drop_last)
    got = BatchLoader(InterHandDataset(data_dir, split, tl, tr), **kw)
    want = JLoader(JDataset(data_dir, split, jl, jr), **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        g, w = list(got), list(want)
        assert len(g) == len(w) == len(want)
        for a, b in zip(g, w):
            _equal_dicts(a, b)


def test_loader_pad_last_and_valid(data_dir, manos):
    _, (tl, tr) = manos
    ds = InterHandDataset(data_dir, "test", tl, tr, augment_train=False)
    loader = BatchLoader(ds, batch_size=4, shuffle=False, drop_last=False,
                         pad_last=True, num_threads=2)
    batches = list(loader)
    assert [int(b["_valid"]) for b in batches] == [4, N_TEST - 4]
    assert batches[1]["img"].shape == (4, 256, 256, 3)
    # the padding repeats the last real sample
    for k in ("img", "joint_3d_left"):
        for i in range(N_TEST - 4, 4):
            np.testing.assert_array_equal(batches[1][k][i],
                                          batches[1][k][N_TEST - 5])


def test_loader_iter_from_and_peek(data_dir, manos):
    (jl, jr), (tl, tr) = manos
    kw = dict(batch_size=2, shuffle=True, drop_last=True, num_threads=2,
              seed=3)
    loader = BatchLoader(InterHandDataset(data_dir, "train", tl, tr), **kw)
    jloader = JLoader(JDataset(data_dir, "train", jl, jr), **kw)
    full = list(loader)
    loader.set_epoch(0)
    tail = list(loader.iter_from(1))
    assert len(tail) == len(full) - 1
    for a, b in zip(tail, full[1:]):
        _equal_dicts(a, b)
    jloader.set_epoch(0)
    _equal_dicts(list(jloader.iter_from(2))[0], full[2])
    # peek: the first batch of the current epoch, no epoch advance
    loader.set_epoch(1)
    jloader.set_epoch(1)
    _equal_dicts(loader.peek_batch(), jloader.peek_batch())
    assert loader._epoch == 1


def test_loader_abandoned_iterator_unblocks(data_dir, manos):
    """A consumer that stops after one batch, with the queue full, leaves
    no producer blocked behind."""
    _, (tl, tr) = manos
    ds = InterHandDataset(data_dir, "train", tl, tr)
    loader = BatchLoader(ds, batch_size=1, shuffle=False, drop_last=True,
                         num_threads=1, prefetch=1)
    before = set(threading.enumerate())
    it = iter(loader)
    next(it)
    time.sleep(0.3)          # let the producer fill the queue and block
    it.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        alive = [t for t in set(threading.enumerate()) - before
                 if t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive


def test_loader_forwards_a_failed_sample():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise KeyError("sample 2")
            return {"x": np.full((2,), i, np.float32)}

    loader = BatchLoader(Broken(), batch_size=1, num_threads=1)
    it = iter(loader)
    assert [float(next(it)["x"][0, 0]) for _ in range(2)] == [0.0, 1.0]
    with pytest.raises(KeyError, match="sample 2"):
        next(it)


def test_collate_pinned_layout():
    """Pinned collation gives the same values as the numpy collation (the
    pinned allocation itself needs a card: tests/test_torch_port_gpu.py)."""
    from dir_tpu_torch.data.loader import collate
    samples = [{"a": np.arange(6, dtype=np.uint8).reshape(2, 3) + i,
                "b": np.float32(i)} for i in range(3)]
    got = collate(samples)
    assert got["a"].shape == (3, 2, 3) and got["a"].dtype == np.uint8
    np.testing.assert_array_equal(got["b"], [0.0, 1.0, 2.0])


# -- config ------------------------------------------------------------------

def test_config_file_reads_in_both_packages(tmp_path):
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(backbone_layers=(1, 1, 1, 1),
                                  dtype="bfloat16", fused_l2_bands=4),
        data=tconfig.DataConfig(data_dir="/x", device_pipeline=True,
                                wire8=True, mean=(0.5, 0.5, 0.5)),
        train=tconfig.TrainConfig(batch_size=3, step_milestones=(2, 5),
                                  output_dir="/o"),
        mano_assets="/m")
    path = str(tmp_path / "config.yaml")
    tconfig.save_yaml(cfg, path)
    assert tconfig.load_yaml(path) == cfg
    with open(path) as f:
        json.load(f)
    got = jconfig.load_yaml(path)
    want = jconfig.Config(
        model=jconfig.ModelConfig(backbone_layers=(1, 1, 1, 1),
                                  dtype="bfloat16"),
        data=jconfig.DataConfig(data_dir="/x", device_pipeline=True,
                                wire8=True, mean=(0.5, 0.5, 0.5)),
        train=jconfig.TrainConfig(batch_size=3, step_milestones=(2, 5),
                                  output_dir="/o"),
        mano_assets="/m")
    assert got == want


def test_config_sections_match_jax():
    """Same fields and defaults as the JAX package (the model config has
    the port's kernel fields besides)."""
    for name in ("DataConfig", "TrainConfig", "ModelConfig", "Config"):
        want = {f.name: f.default for f in dataclasses.fields(
            getattr(jconfig, name))}
        got = {f.name: f.default for f in dataclasses.fields(
            getattr(tconfig, name))}
        assert set(want) <= set(got), name
        for k, v in want.items():
            assert got[k] == v, (name, k)
        if name != "ModelConfig":
            assert set(got) == set(want), name
