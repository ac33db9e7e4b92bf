"""The port's evaluation metrics (dir_tpu_torch/train/evaluate.py) against
dir_tpu's on the CPU at fp32: the same seeded vertices, offsets and camera,
with a partial validity mask. Also ``xyz_to_uv``.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.mano import assets as jassets
from dir_tpu.ops import projection as jprojection
from dir_tpu.train import evaluate as jevaluate

from dir_tpu_torch.mano import assets as tassets
from dir_tpu_torch.ops import projection as tprojection
from dir_tpu_torch.train import evaluate as tevaluate

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import max_err  # noqa: E402

T = torch.from_numpy
B = 5
VALID = np.array([1, 1, 0, 1, 0], np.float32)


def _batch(seed):
    """Predicted and GT vertices of both hands (at depth 2 m, so that the
    projection is well defined), a normalized offset and a camera."""
    rng = np.random.RandomState(seed)
    gv_l = rng.randn(B, 778, 3).astype(np.float32) * 0.05
    gv_r = rng.randn(B, 778, 3).astype(np.float32) * 0.05
    pv_l = gv_l + rng.randn(B, 778, 3).astype(np.float32) * 0.01
    pv_r = gv_r + rng.randn(B, 778, 3).astype(np.float32) * 0.01
    for v in (gv_l, gv_r, pv_l, pv_r):
        v[..., 2] += 2.0
    off = rng.randn(B, 3).astype(np.float32) * 0.1
    cam = np.tile(np.array([[500.0, 0, 128], [0, 480, 120], [0, 0, 1]],
                           np.float32), (B, 1, 1))
    return pv_l, pv_r, off, gv_l, gv_r, cam


def _regressors():
    jl = jevaluate.extended_j_regressor(jassets.synthetic_mano("left", seed=1))
    jr = jevaluate.extended_j_regressor(jassets.synthetic_mano("right", seed=1))
    tl = tevaluate.extended_j_regressor(tassets.synthetic_mano("left", seed=1))
    tr = tevaluate.extended_j_regressor(tassets.synthetic_mano("right", seed=1))
    return (jl, jr), (tl, tr)


def test_extended_j_regressor_bit_for_bit():
    (jl, jr), (tl, tr) = _regressors()
    assert tl.shape == (21, 778) and tl.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_xyz_to_uv_parity():
    pv_l, _, _, _, _, cam = _batch(0)
    ref = jprojection.xyz_to_uv(jnp.asarray(pv_l), jnp.asarray(cam))
    out = tprojection.xyz_to_uv(T(pv_l), T(cam))
    assert out.shape == (B, 778, 2)
    # measured max abs err 6.9e-5 px on coordinates up to ~190 px (a few
    # fp32 ulps: XLA fuses the multiply, divide and add)
    assert max_err(out, ref) <= 5e-4


@pytest.mark.parametrize("root_joint,scale_align", [(0, True), (9, True),
                                                    (0, False)])
def test_batch_errors_and_metrics_parity(root_joint, scale_align):
    args = _batch(1)
    (jl, jr), (tl, tr) = _regressors()
    jargs = [jnp.asarray(a) for a in args] + [jl, jr]
    targs = [T(a) for a in args] + [tl, tr]
    kw = dict(root_joint=root_joint, scale_align=scale_align)

    ref = jevaluate.batch_errors(*jargs, **kw)
    out = tevaluate.batch_errors(*targs, **kw)
    assert sorted(out) == sorted(ref)
    for key, r in ref.items():
        assert tuple(out[key].shape) == tuple(r.shape), key
        # measured max abs err over the three cases: 3D errors and joints
        # 1.0e-6 m (a few fp32 ulps of the 2 m depth the vertices sit at),
        # 2D errors 2.1e-4 px (coordinates up to ~190 px)
        tol = 2e-3 if "2d" in key else 5e-6
        assert max_err(out[key], r) <= tol, key

    ref = jevaluate.batch_metrics(*jargs, jnp.asarray(VALID), **kw)
    out = tevaluate.batch_metrics(*targs, T(VALID), **kw)
    assert sorted(out) == sorted(ref)
    assert float(out["count"]) == 3.0
    for key, r in ref.items():
        # sums over 3 valid samples of per-sample means
        tol = 2e-3 if "px" in key else 5e-6
        assert max_err(out[key], r) <= tol, key
    # the mask matters: the full sum differs from the masked one
    full = tevaluate.batch_metrics(*targs, torch.ones(B), **kw)
    assert float(full["joint_left_sum_m"]) > float(out["joint_left_sum_m"])

    jsum = jevaluate.summarize({k: float(v) for k, v in ref.items()})
    tsum = tevaluate.summarize({k: float(v) for k, v in out.items()})
    assert sorted(tsum) == sorted(jsum)
    for key, r in jsum.items():
        assert abs(tsum[key] - r) <= 1e-3, key      # mm and px means


def test_online_batch_metrics_parity():
    rng = np.random.RandomState(2)
    gj = [rng.randn(B, 21, 3).astype(np.float32) * 0.05 for _ in range(2)]
    gv = [rng.randn(B, 778, 3).astype(np.float32) * 0.05 for _ in range(2)]
    pj = [g + rng.randn(B, 21, 3).astype(np.float32) * 0.01 for g in gj]
    pv = [g + rng.randn(B, 778, 3).astype(np.float32) * 0.01 for g in gv]
    args = pj + pv + gj + gv + [VALID]
    ref = jevaluate.online_batch_metrics(*[jnp.asarray(a) for a in args])
    out = tevaluate.online_batch_metrics(*[T(a) for a in args])
    assert sorted(out) == sorted(ref)
    for key, r in ref.items():
        # measured max abs err 3e-8 (sums of ~0.05 m over 3 valid samples)
        assert max_err(out[key], r) <= 1e-6, key
    jsum = jevaluate.summarize_online({k: float(v) for k, v in ref.items()})
    tsum = tevaluate.summarize_online({k: float(v) for k, v in out.items()})
    assert sorted(tsum) == sorted(jsum)
    for key, r in jsum.items():
        assert abs(tsum[key] - r) <= 1e-3, key      # mm means
