"""Parity of the port's geometry, MANO and building blocks with dir_tpu.

The same numpy inputs (and the same weights, carried over through the
JAX package's torch-layout export) go through the JAX function and its
port, both on the CPU in fp32; the JAX side runs matmuls at "highest"
precision (tests/conftest.py). Each tolerance sits a few times above the
max abs error measured on these seeded inputs, noted beside it.
"""

import contextlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.mano import assets as jassets
from dir_tpu.mano import layer as jlayer
from dir_tpu.models import gcn as jgcn
from dir_tpu.models import layers as jlayers
from dir_tpu.models import transformer as jtransformer
from dir_tpu.ops import projection as jprojection
from dir_tpu.ops import rotation as jrotation
from dir_tpu.ops import sampling as jsampling
from dir_tpu.ops import splat_conv as jsplat
from dir_tpu.train import checkpoint as ck

from dir_tpu_torch.mano import assets as tassets
from dir_tpu_torch.mano import layer as tlayer
from dir_tpu_torch.models import gcn as tgcn
from dir_tpu_torch.models import layers as tlayers
from dir_tpu_torch.models import transformer as ttransformer
from dir_tpu_torch.ops import projection as tprojection
from dir_tpu_torch.ops import rotation as trotation
from dir_tpu_torch.ops import sampling as tsampling
from dir_tpu_torch.ops import splat_conv as tsplat

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (load_into, max_err,  # noqa: E402
                                rand_variables)

T = torch.from_numpy


class _X64:
    """JAX 64-bit mode for one test, restored afterwards."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("bits", [32, 64])
def test_rotation_parity(bits):
    rng = np.random.RandomState(0)
    dt = np.float32 if bits == 32 else np.float64
    axis = (rng.randn(64, 3) * 1.5).astype(dt)
    axis[0] = 0.0  # the epsilon placement decides this row
    six = rng.randn(64, 6).astype(dt)
    # measured max abs err: fp32 2.4e-7, fp64 6.7e-16
    tol = 2e-6 if bits == 32 else 1e-14
    with _X64() if bits == 64 else contextlib.nullcontext():
        pairs = [
            (jrotation.batch_rodrigues(jnp.asarray(axis)),
             trotation.batch_rodrigues(T(axis))),
            (jrotation.rot6d_to_rotmat(jnp.asarray(six)),
             trotation.rot6d_to_rotmat(T(six))),
            (jrotation.robust_rot6d_to_rotmat(jnp.asarray(six)),
             trotation.robust_rot6d_to_rotmat(T(six))),
        ]
        for ref, out in pairs:
            assert out.dtype == (torch.float32 if bits == 32
                                 else torch.float64)
            assert max_err(out, ref) < tol


def test_synthetic_mano_bit_identical():
    """Both packages draw the same numpy random numbers from one seed."""
    jr = jassets.synthetic_mano("right", seed=3)
    jl = jassets.fix_left_shapedirs(jassets.synthetic_mano("left", seed=3), jr)
    tr = tassets.synthetic_mano("right", seed=3)
    tl = tassets.fix_left_shapedirs(tassets.synthetic_mano("left", seed=3), tr)
    for jm, tm in ((jl, tl), (jr, tr)):
        for name in tassets.ManoModel._fields:
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))


def test_load_mano_npz_roundtrip(tmp_path):
    """load_mano_pair reads the .npz assets the JAX package converts to."""
    for side in ("left", "right"):
        m = jassets.synthetic_mano(side, seed=1)
        np.savez(tmp_path / f"MANO_{side.upper()}.npz",
                 v_template=m.v_template, shapedirs=m.shapedirs,
                 posedirs=m.posedirs, J_regressor=m.j_regressor,
                 weights=m.weights, hands_components=m.hands_components,
                 hands_mean=m.hands_mean, faces=m.faces)
    jl, jr = jassets.load_mano_pair(str(tmp_path))
    tl, tr = tassets.load_mano_pair(str(tmp_path))
    for jm, tm in ((jl, tl), (jr, tr)):
        for name in tassets.ManoModel._fields:
            np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                          np.asarray(getattr(jm, name)))


def test_kinematic_order_constants():
    """The port's MANO layer walks the chain with strided slices and a
    finger-major stack instead of the index lists; both name the same
    joints as LEV1-3 and KIN_REORDER."""
    joints = np.arange(1, 16)
    for lev, want in enumerate((tassets.LEV1, tassets.LEV2, tassets.LEV3)):
        assert tuple(joints[lev::3]) == want
    concat = np.concatenate([[0], tassets.LEV1, tassets.LEV2, tassets.LEV3])
    stacked = np.concatenate(
        [[0], np.stack([tassets.LEV1, tassets.LEV2, tassets.LEV3], 1).ravel()])
    assert tuple(concat[list(tassets.KIN_REORDER)]) == tuple(stacked)
    assert tassets.KIN_REORDER == jassets.KIN_REORDER
    assert tassets.JOINT_REORDER == jassets.JOINT_REORDER


@pytest.mark.parametrize("bits", [32, 64])
def test_mano_pair_forward_parity(bits):
    rng = np.random.RandomState(1)
    dt = np.float32 if bits == 32 else np.float64
    pose = (rng.randn(2, 4, 51) * 0.7).astype(dt)
    betas = rng.randn(2, 4, 10).astype(dt)
    jr = jassets.synthetic_mano("right", seed=0)
    jl = jassets.fix_left_shapedirs(jassets.synthetic_mano("left", seed=0), jr)
    tr = tassets.synthetic_mano("right", seed=0)
    tl = tassets.fix_left_shapedirs(tassets.synthetic_mano("left", seed=0), tr)
    tpair = tassets.stack_mano_pair(tl, tr)
    # measured max abs err (meters): fp32 4.5e-8, fp64 9e-17
    tol = 5e-7 if bits == 32 else 1e-15
    with _X64() if bits == 64 else contextlib.nullcontext():
        jpair = jlayer.stack_mano_pair(jl, jr)
        if bits == 64:
            jpair = jax.tree.map(
                lambda a: a.astype(jnp.float64)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, jpair)
            tpair = tassets.ManoModel(
                *(t.double() if t.is_floating_point() else t for t in tpair))
        jv, jj = jlayer.mano_forward_pca6d_pair(jpair, jnp.asarray(pose),
                                                jnp.asarray(betas))
        tv, tj = tlayer.mano_forward_pca6d_pair(tpair, T(pose), T(betas))
        assert tv.shape == (2, 4, 778, 3) and tj.shape == (2, 4, 21, 3)
        assert max_err(tv, jv) < tol
        assert max_err(tj, jj) < tol
        # one hand through the single-hand API agrees with JAX's, too
        jv1, jj1 = jlayer.mano_forward_pca6d(
            jax.tree.map(lambda a: a[1], jpair), jnp.asarray(pose[1]),
            jnp.asarray(betas[1]))
        one = tassets.ManoModel(*(t[1] for t in tpair))
        sv, sj = tlayer.mano_forward_pca6d(one, T(pose[1]), T(betas[1]))
        assert max_err(sv, jv1) < tol and max_err(sj, jj1) < tol


def test_ortho_project_parity():
    rng = np.random.RandomState(2)
    s = rng.randn(3).astype(np.float32)
    t = rng.randn(3, 2).astype(np.float32)
    p = rng.randn(3, 21, 3).astype(np.float32)
    ref = jprojection.ortho_project(jnp.asarray(s), jnp.asarray(t),
                                    jnp.asarray(p))
    out = tprojection.ortho_project(T(s), T(t), T(p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_grid_sample_parity():
    rng = np.random.RandomState(3)
    feat = rng.randn(2, 8, 8, 16).astype(np.float32)
    # includes points outside [-1, 1], whose taps fall off the map
    coords = rng.uniform(-1.2, 1.2, (2, 42, 2)).astype(np.float32)
    out = tsampling.grid_sample_nhwc(T(feat), T(coords))
    assert out.shape == (2, 42, 16)
    # measured max abs err: 1.8e-7 and 2.4e-7 against the two JAX samplers
    for fn in (jsampling.grid_sample_nhwc, jsampling.grid_sample_nhwc_mm):
        assert max_err(out, fn(jnp.asarray(feat), jnp.asarray(coords))) < 2e-6


def test_fused_splat_conv_parity():
    rng = np.random.RandomState(4)
    c, o, size = 8, 16, 16
    uv_l = rng.uniform(-0.9, 0.9, (2, 21, 2)).astype(np.float32)
    uv_r = rng.uniform(-0.9, 0.9, (2, 21, 2)).astype(np.float32)
    f_l = rng.randn(2, 21, c).astype(np.float32)
    f_r = rng.randn(2, 21, c).astype(np.float32)
    kernel = (rng.randn(3, 3, 40 * c, o) / np.sqrt(9 * 40 * c)).astype(
        np.float32)
    bias = rng.randn(o).astype(np.float32)
    args = (uv_l, uv_r, f_l, f_r, kernel, bias)
    ref = jsplat.fused_splat_conv(*map(jnp.asarray, args), size, 2.0)
    out = tsplat.fused_splat_conv(*map(T, args), size, 2.0)
    assert out.shape == (2, size, size, o)
    # measured max abs err: 4.8e-7 (outputs of order 1)
    assert max_err(out, ref) < 5e-6
    wa_j, wb_j = jsplat.splat_weights(jnp.asarray(uv_l), size, 2.0)
    wa_t, wb_t = tsplat.splat_weights(T(uv_l), size, 2.0)
    # measured max abs err: 0 (bit-equal); the bound allows one fp32 ulp
    assert max_err(wa_t, wa_j) < 1e-7 and max_err(wb_t, wb_j) < 1e-7


@pytest.mark.parametrize("cx,cp,features", [(12, 4, 16), (12, 8, 16)])
def test_residual_pair_parity(cx, cp, features):
    """Residual(x, pair=p) == the JAX block's concat-free pair path; the
    second case has a skip conv (input width 20 != 16)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, 8, cx).astype(np.float32)
    p = rng.randn(2, 8, 8, cp).astype(np.float32)
    jmod = jlayers.Residual(features)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          pair=jnp.asarray(p))
    variables = rand_variables(rng, variables)
    ref = jmod.apply(variables, jnp.asarray(x), train=False,
                     pair=jnp.asarray(p))

    tmod = tlayers.Residual(cx + cp, features).eval()
    assert (tmod.skip_layer is None) == (cx + cp == features)
    load_into(tmod, variables, ck._entries_residual("", ()))
    with torch.no_grad():
        out = tmod(T(x).permute(0, 3, 1, 2), pair=T(p).permute(0, 3, 1, 2))
    # measured max abs err: 4.8e-7 in both cases
    assert max_err(out.permute(0, 2, 3, 1), ref) < 5e-6


def test_mlp1d_parity():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 21, 5).astype(np.float32)
    jmod = jlayers.MLP1d(16, 8)
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod = tlayers.MLP1d(5, 16, 8).eval()
    load_into(tmod, variables, ck._entries_mlp1d("", ()))
    with torch.no_grad():
        out = tmod(T(x))
    # measured max abs err: 2.4e-7
    assert max_err(out, ref) < 2e-6


def test_upsample2x_parity():
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    out = tlayers.upsample2x(T(x))
    assert out.shape == (2, 10, 14, 3)
    # measured max abs err: 1.2e-7
    assert max_err(out, jlayers.upsample2x(jnp.asarray(x))) < 1e-6


def test_gcn_parity():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 21, 16).astype(np.float32)
    adj = tuple(map(tuple, jgcn.hand_adjacency(21)))
    jmod = jgcn.ResSimplePGCN(16, 4, adj)
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod = tgcn.ResSimplePGCN(16, 4).eval()
    np.testing.assert_array_equal(tgcn.hand_adjacency(21),
                                  jgcn.hand_adjacency(21))
    load_into(tmod, variables, ck._entries_gcn("", (), num_layers=4))
    with torch.no_grad():
        out = tmod(T(x))
    # measured max abs err: 1.2e-7
    assert max_err(out, ref) < 1e-6


def test_ste_parity():
    rng = np.random.RandomState(9)
    x = rng.randn(2, 42, 32).astype(np.float32)
    jmod = jtransformer.STE(num_joints=42, in_chans=32, out_dim=16, depth=4,
                            num_heads=4)
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x))
    tmod = ttransformer.STE(42, 32, 16, depth=4, num_heads=4).eval()
    assert "0" not in tmod.STEblocks  # block 0 is never executed
    load_into(tmod, variables, ck._entries_ste("", (), depth=4))
    with torch.no_grad():
        out = tmod(T(x))
    # measured max abs err: 6e-7
    assert max_err(out, ref) < 5e-6
