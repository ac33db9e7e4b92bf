"""The port's on-device data pipeline against the JAX package's, on the
CPU. ``jax.random`` and ``torch.Generator`` never agree, so the training
path is held by replaying the JAX package's draws (rebuilt here with its
key splits) through the port's apply functions; at ``train=False`` nothing
is drawn and the whole preprocess is compared as it stands.

Tolerances (measured max abs errors in brackets, 4 synthetic samples at
256x256): at ``train=False`` every output 1e-6 [3.6e-7, mesh uv; the image
1.2e-7; seg and dense equal]; with the replayed draws, the normalized image
1e-3 [1.6e-4: the blur's and the warp's fp32 sums run in another order, and
bilinear taps magnify a last-bit shift of a sample coordinate], dense 3e-4
[5.8e-5], labels 2e-6 [4.8e-7], seg labels differing at no more than 1e-4
of the pixels [1 pixel of 262,144: the warped mask's two colour channels
tie within rounding there]; the single functions on [0, 255] images 2e-3
absolute [warp 3.7e-4, blur 3.1e-5, noise 0], the affine matrices and their
inverses 1e-4 [0], seg equal.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.data import device_pipeline as jdp
from dir_tpu.data import synthetic as jsynthetic
from dir_tpu.data.loader import collate as jcollate
from dir_tpu.mano import assets as jassets

from dir_tpu_torch.data import device_pipeline as tdp
from dir_tpu_torch.data.interhand import InterHandDataset
from dir_tpu_torch.data.loader import collate
from dir_tpu_torch.mano import assets as tassets

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads  # noqa: E402

B = 4
EVAL_TOL = 1e-6
TRAIN_TOL = {"img": 1e-3, "dense": 3e-4}
LABEL_TOL = 2e-6
SEG_MISMATCH_SHARE = 1e-4
OP_TOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Data-side MANO pairs of both packages and a synthetic split written
    by the JAX package's writer (the port's writes the same files)."""
    jr = jassets.synthetic_mano("right", seed=0, tips=jassets.TIPS_DATA)
    jl = jassets.fix_left_shapedirs(
        jassets.synthetic_mano("left", seed=0, tips=jassets.TIPS_DATA), jr)
    tr = tassets.synthetic_mano("right", seed=0, tips=tassets.TIPS_DATA)
    tl = tassets.fix_left_shapedirs(
        tassets.synthetic_mano("left", seed=0, tips=tassets.TIPS_DATA), tr)
    d = str(tmp_path_factory.mktemp("dev_data"))
    jsynthetic.generate(d, jl, jr, split="test", num_samples=B)
    raw = collate([tdp.RawInterHandDataset(d, "test")[i] for i in range(B)])
    jraw = jcollate([jdp.RawInterHandDataset(d, "test")[i]
                     for i in range(B)])
    for k in jraw:
        np.testing.assert_array_equal(raw[k], jraw[k], err_msg=k)
    return d, (jl, jr), (tl, tr), raw


def _err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def jax_draws(key, b: int, image_shape) -> dict:
    """The values ``make_preprocess_fn(train=True)`` of the JAX package
    draws from ``key``, with its own key splits (preprocess: kf, ka, kb,
    kn; _affine_mats: k1..k4; motion_blur: k1..k3; add_noise: k1..k3)."""
    u = jax.random.uniform
    kf, ka, kb, kn = jax.random.split(key, 4)
    k1, k2, k3, k4 = jax.random.split(ka, 4)
    draws = {"flip_u": u(kf, (b,)),
             "scale_delta": u(k1, (b,), minval=-0.1, maxval=0.1),
             "rot_deg": u(k2, (b,), minval=-180.0, maxval=180.0),
             "tx": u(k3, (b,), minval=-10.0, maxval=10.0),
             "ty": u(k4, (b,), minval=-10.0, maxval=10.0)}
    k1, k2, k3 = jax.random.split(kb, 3)
    draws.update(blur_angle=u(k1, (b,), minval=-np.pi, maxval=np.pi),
                 blur_length=u(k2, (b,), minval=1.5, maxval=tdp.BLUR_K / 2),
                 blur_u=u(k3, (b,)))
    k1, k2, k3 = jax.random.split(kn, 3)
    draws.update(bright=u(k1, (b, 1, 1, 3), minval=0.7, maxval=1.3),
                 offset_u=u(k2, (b, 1, 1, 1), minval=-1, maxval=1),
                 noise=jax.random.normal(k3, (b, *image_shape)))
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_eval_preprocess_matches_jax(env):
    _, (jl, jr), (tl, tr), raw = env
    got = tdp.make_preprocess_fn(tl, tr, train=False, device="cpu")(raw)
    want = jdp.make_preprocess_fn(jl, jr, train=False)(
        {k: jnp.asarray(v) for k, v in raw.items()}, jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _err(got[k], want[k]) <= EVAL_TOL, k
    np.testing.assert_array_equal(got["seg"].numpy(), np.asarray(want["seg"]))


@pytest.mark.parametrize("seed", [1, 11])
def test_train_preprocess_replayed_draws_match_jax(env, seed):
    _, (jl, jr), (tl, tr), raw = env
    key = jax.random.PRNGKey(seed)
    draws = jax_draws(key, B, raw["img"].shape[1:])
    # these keys flip some samples and not others, and blur at least one
    flips = (draws["flip_u"] < 0.5).tolist()
    assert any(flips) and not all(flips)
    assert bool((draws["blur_u"] < 0.3).any())
    got = tdp.make_preprocess_fn(tl, tr, train=True, device="cpu")(
        raw, draws=draws)
    want = jdp.make_preprocess_fn(jl, jr, train=True)(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if k != "seg":
            assert _err(got[k], want[k]) <= TRAIN_TOL.get(k, LABEL_TOL), k
    share = float(np.mean(got["seg"].numpy() != np.asarray(want["seg"])))
    assert share <= SEG_MISMATCH_SHARE


def test_eval_path_matches_host_dataset(env):
    """train=False on the device equals the port's host dataset (the
    device pipeline's own check, as the JAX package's tests do it)."""
    d, _, (tl, tr), raw = env
    got = tdp.make_preprocess_fn(tl, tr, train=False, device="cpu")(raw)
    host = InterHandDataset(d, "test", tl, tr, augment_train=False)
    want = collate([host[i] for i in range(B)])
    np.testing.assert_allclose(got["img"].numpy(), want["img"], atol=1e-5)
    np.testing.assert_array_equal(got["seg"].numpy(), want["seg"])
    np.testing.assert_allclose(got["dense"].numpy(), want["dense"], atol=1e-5)
    for k in ("joint_3d_left", "mesh_3d_right", "joint_2d_left",
              "mesh_2d_right", "center_left", "center_right"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("case", ["identity", "shift_out", "rotate_scale"])
def test_warp_images_matches_jax(case):
    """The four-tap gather with per-tap index clipping, including taps
    past every border."""
    rng = np.random.RandomState(5)
    imgs = (rng.rand(2, 24, 20, 3) * 255).astype(np.float32)
    if case == "identity":
        m = np.tile(np.array([[1.0, 0, 0], [0, 1, 0]], np.float32), (2, 1, 1))
    elif case == "shift_out":
        m = np.array([[[1.0, 0, 7.5], [0, 1, -9.25]],
                      [[1.0, 0, -30.0], [0, 1, 40.0]]], np.float32)
    else:
        m = tdp.affine_mats(torch.tensor([0.1, -0.08]),
                            torch.tensor([37.0, -151.0]),
                            torch.tensor([3.0, -9.0]),
                            torch.tensor([-6.0, 4.5]), 24).numpy()
        m[1, :, :2] *= 1.8      # taps far outside the map
    got = tdp.warp_images(torch.from_numpy(imgs), torch.from_numpy(m))
    want = jdp.warp_images(jnp.asarray(imgs), jnp.asarray(m))
    assert _err(got, want) <= OP_TOL
    if case == "identity":
        np.testing.assert_array_equal(got.numpy(), imgs)


def test_affine_mats_match_jax():
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, 6, (8, 8, 3))
    _, ka, _, _ = jax.random.split(key, 4)
    want, _ = jdp._affine_mats(ka, 6, 256)
    got = tdp.affine_mats(draws["scale_delta"], draws["rot_deg"],
                          draws["tx"], draws["ty"], 256)
    assert _err(got, want) <= 1e-4
    np.testing.assert_allclose(
        tdp.invert_affine(got).numpy(), np.asarray(jdp._invert_affine(want)),
        atol=1e-4)


def test_motion_blur_matches_jax():
    rng = np.random.RandomState(6)
    imgs = (rng.rand(4, 20, 20, 3) * 255).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jdp.motion_blur(key, jnp.asarray(imgs), prob=0.5)
    k1, k2, k3 = jax.random.split(key, 3)
    angle = jax.random.uniform(k1, (4,), minval=-np.pi, maxval=np.pi)
    length = jax.random.uniform(k2, (4,), minval=1.5, maxval=tdp.BLUR_K / 2)
    apply_u = jax.random.uniform(k3, (4,))
    assert 0 < int((np.asarray(apply_u) < 0.5).sum()) < 4
    got = tdp.motion_blur(torch.from_numpy(imgs),
                          *(torch.from_numpy(np.array(a))
                            for a in (angle, length, apply_u)), prob=0.5)
    assert _err(got, want) <= OP_TOL


def test_add_noise_matches_jax():
    rng = np.random.RandomState(7)
    imgs = (rng.rand(3, 16, 16, 3) * 255).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jdp.add_noise(key, jnp.asarray(imgs))
    k1, k2, k3 = jax.random.split(key, 3)
    bright = jax.random.uniform(k1, (3, 1, 1, 3), minval=0.7, maxval=1.3)
    off = jax.random.uniform(k2, (3, 1, 1, 1), minval=-1, maxval=1)
    normal = jax.random.normal(k3, imgs.shape)
    got = tdp.add_noise(torch.from_numpy(imgs),
                        *(torch.from_numpy(np.array(a))
                          for a in (bright, off, normal)))
    assert _err(got, want) <= OP_TOL
    assert float(got.min()) >= 0 and float(got.max()) <= 255


@pytest.mark.parametrize("flip", [False, True])
def test_seg_from_mask_matches_jax(flip):
    rng = np.random.RandomState(8)
    mask = rng.randint(0, 255, (2, 16, 16, 3)).astype(np.float32)
    flipped = np.array([flip, not flip])
    got = tdp.seg_from_mask(torch.from_numpy(mask), torch.from_numpy(flipped))
    want = jdp.seg_from_mask(jnp.asarray(mask), jnp.asarray(flipped))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_draws_follow_the_generator(env):
    """Same generator state, same batch; the train path needs a generator
    or draws; draws lie in their ranges."""
    _, _, (tl, tr), raw = env
    fn = tdp.make_preprocess_fn(tl, tr, train=True, device="cpu")
    a = fn(raw, torch.Generator().manual_seed(1))
    b = fn(raw, torch.Generator().manual_seed(1))
    c = fn(raw, torch.Generator().manual_seed(2))
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), err_msg=k)
    assert not torch.equal(a["img"], c["img"])
    with pytest.raises(ValueError, match="generator"):
        fn(raw)
    d = tdp.draw_augmentation(torch.Generator().manual_seed(3), 64, (4, 4, 3))
    assert float(d["rot_deg"].abs().max()) <= 180
    assert float(d["scale_delta"].abs().max()) <= 0.1
    assert 1.5 <= float(d["blur_length"].min()) <= float(
        d["blur_length"].max()) <= tdp.BLUR_K / 2
    assert d["noise"].shape == (64, 4, 4, 3)


def test_preprocess_refuses_a_missing_card(env):
    _, _, (tl, tr), _ = env
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdp.make_preprocess_fn(tl, tr)
