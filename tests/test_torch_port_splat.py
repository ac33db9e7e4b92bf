"""Kernel K5 (the bone splat) of the port against dir_tpu, on the CPU.

The port's plain version is held against the jnp reference
(dir_tpu.ops.bone_splat) and against the Pallas kernel in interpret mode
(as tests/test_pallas_kernels.py runs it), at fp32 and bf16; the wrapper's
gradient against jax.grad of the Pallas function. The CUDA kernel itself
is held against the plain version by tests/test_torch_port_gpu.py, on the
card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dir_tpu.ops import pallas_bone_splat as jpallas
from dir_tpu.ops.bone_splat import bone_splat as jbone_splat

from dir_tpu_torch.ops import bone_splat as bs

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import max_err  # noqa: E402

T = torch.from_numpy


def _inputs(seed, b, c):
    """Seeded joints and features; the last sample has a zero-length bone
    (joint 2 on joint 1)."""
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-0.9, 0.9, (b, 21, 2)).astype(np.float32)
    uv[-1, 2] = uv[-1, 1]
    feat = rng.randn(b, 21, c).astype(np.float32)
    return uv, feat


@pytest.mark.parametrize("size,distance", [(8, 1.0), (8, 2.0), (16, 1.0),
                                           (16, 2.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_and_pallas_interpret(size, distance, dtype):
    uv, feat = _inputs(0, 3, 16)
    jf = jnp.asarray(feat).astype(dtype)
    ref = jbone_splat(jnp.asarray(uv), jf, size, distance)
    with pltpu.force_tpu_interpret_mode():
        ref_kernel = jpallas.bone_splat_pallas(jnp.asarray(uv), jf, size,
                                               distance)
    out = bs.bone_splat_plain(T(uv), T(feat).to(getattr(torch, dtype)), size,
                              distance)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == (3, size, size, 20 * 16)
    assert torch.isfinite(out).all()        # the zero-length bone gives 0
    assert float(out[-1, :, :, 16:32].abs().max()) == 0.0
    err_kernel = max_err(out.float(), np.asarray(ref_kernel, np.float32))
    err_ref = max_err(out.float(), np.asarray(ref, np.float32))
    if dtype == "float32":
        # measured max abs err 4.8e-7 (Pallas kernel) and 0 (jnp), |out| up
        # to 3.1; the JAX kernel test's own bound is 1e-4
        assert err_kernel <= 2e-6 and err_ref <= 2e-6
    else:
        # same rounding points as the Pallas kernel: measured 0 (bit-equal);
        # one bf16 ulp at |out| < 4 allowed. The jnp reference rounds each
        # product to bf16 before the sum: measured 0.0156 (one ulp at
        # |out| up to 3.1), two ulps allowed
        assert err_kernel <= 2 ** -6 and err_ref <= 2 ** -5


def test_wrapper_gradient_matches_jax_pallas():
    """d sum(out^2) / d (uv, feat) through the port's wrapper (CPU route)
    against jax.grad of the Pallas function, whose backward is the jnp
    reference's VJP."""
    rng = np.random.RandomState(1)
    b, c, size, dist = 1, 8, 8, 1.5
    uv = rng.uniform(-0.8, 0.8, (b, 21, 2)).astype(np.float32)
    feat = rng.randn(b, 21, c).astype(np.float32)

    def f(u, f_):
        return jnp.sum(jpallas.bone_splat_pallas(u, f_, size, dist) ** 2)

    with pltpu.force_tpu_interpret_mode():
        g_uv, g_feat = jax.grad(f, argnums=(0, 1))(jnp.asarray(uv),
                                                   jnp.asarray(feat))
    tu = T(uv).requires_grad_(True)
    tf = T(feat).requires_grad_(True)
    runs = bs.bone_splat.plain_runs
    (bs.bone_splat(tu, tf, size, dist) ** 2).sum().backward()
    assert bs.bone_splat.plain_runs == runs + 1
    # measured max abs err: uv 7.6e-6 on gradients up to 68, feat 7.6e-6 on
    # gradients up to 73; the JAX test's own bound is 1e-3
    assert max_err(tu.grad, g_uv) <= 1e-4
    assert max_err(tf.grad, g_feat) <= 1e-4


def test_wrapper_routes_cpu_to_plain_and_counts():
    uv, feat = _inputs(2, 2, 8)
    before = (bs.bone_splat.launches, bs.bone_splat.plain_runs)
    out = bs.bone_splat(T(uv), T(feat), 8, 2.0)
    # the plain version ran in the kernel's place: no launch is counted
    assert (bs.bone_splat.launches, bs.bone_splat.plain_runs) == (
        before[0], before[1] + 1)
    assert torch.equal(out, bs.bone_splat_plain(T(uv), T(feat), 8, 2.0))


def test_wrapper_refuses_other_devices():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    before = (bs.bone_splat.launches, bs.bone_splat.plain_runs)
    with pytest.raises(ValueError):
        bs.bone_splat(torch.zeros(1, 21, 2, device="meta"),
                      torch.zeros(1, 21, 8, device="meta"), 8, 1.0)
    assert (bs.bone_splat.launches, bs.bone_splat.plain_runs) == before


def test_threshold_pairs_marks_the_step():
    """A joint pair placed so that a pixel centre is exactly `distance`
    from the bone is reported; far pixels are not."""
    uv = np.zeros((1, 21, 2), np.float32)
    # size 8: the bone 0 -> 1 runs along y = 3.5 px from x = 1.5 to x = 5.5;
    # pixel centres on rows y = 2.5 and y = 4.5 are exactly 1 px away
    uv[0, 0] = (1.5 / 4 - 1, 3.5 / 4 - 1)
    uv[0, 1] = (5.5 / 4 - 1, 3.5 / 4 - 1)
    near = bs.threshold_pairs(T(uv), 8, 1.0)
    assert near.shape == (1, 8, 8, 20)
    assert bool(near[0, 2, 3, 0]) and bool(near[0, 4, 3, 0])
    assert not bool(near[0, 3, 3, 0]) and not bool(near[0, 0, 3, 0])


def test_mismatch_outside_threshold_leaves_only_the_step_out():
    """The comparison the card's checks use: a whole-feature difference at
    a (pixel, bone) pair on the threshold is left out, any other counts;
    the tolerance is one ulp of the dtype at the reference's max."""
    uv = np.zeros((1, 21, 2), np.float32)
    uv[0, 0] = (1.5 / 4 - 1, 3.5 / 4 - 1)       # as in the test above
    uv[0, 1] = (5.5 / 4 - 1, 3.5 / 4 - 1)
    feat = np.random.RandomState(3).randn(1, 21, 8).astype(np.float32)
    for dtype, ulp in ((torch.float32, 2.0 ** -23), (torch.bfloat16, 2.0 ** -7)):
        ref = bs.bone_splat_plain(T(uv), T(feat).to(dtype), 8, 1.0)
        near = bs.threshold_pairs(T(uv), 8, 1.0)
        out = ref.clone()
        out[0, 2, 3, 0:8] += 1.0                # bone 0 at a threshold pixel
        err, tol, share = bs.mismatch_outside_threshold(out, ref, near)
        scale = float(ref.float().abs().max())
        assert err == 0.0 and 0 < share < 0.02
        assert tol == ulp * 2.0 ** np.floor(np.log2(scale))
        out[0, 3, 3, 0] += 0.5                  # bone 0 on the bone itself
        err, _, _ = bs.mismatch_outside_threshold(out, ref, near)
        assert abs(err - 0.5) < 0.01            # bf16 rounds the sum
