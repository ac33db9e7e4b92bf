"""The port's losses (dir_tpu_torch/models/losses.py) against dir_tpu's.

Synthetic predictions and targets made with numpy from a seed go through
both packages: every term and its gradient at fp64 (JAX with x64 enabled
for the test alone), the assembled ``dir_losses`` with ``fused_stages``
both ways, key for key, and ``total_loss`` at fp64 and fp32. The faces are
the synthetic MANO pair's, the same in both packages.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models import losses as jl

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models import losses as tl
from dir_tpu_torch.serve import flagship_mano

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import torch_threads, x64  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield

B, MAP, IMG = 2, 8, 64           # batch, head map size, target image size
FACES_LEFT, FACES = (m.faces for m in flagship_mano("/nonexistent"))


def _pred_target(rng, nv, scale=0.05):
    """A prediction near its target and the target, (B, nv, 3)."""
    gt = rng.randn(B, nv, 3) * scale
    return gt + rng.randn(B, nv, 3) * scale * 0.3, gt


# term name -> (JAX function, port function, inputs maker, number of leading
# inputs that are differentiated)
def _coords(rng):
    return _pred_target(rng, 778)


def _smooth(rng):
    # residuals on both sides of the 0.01 threshold
    y = rng.randn(B, 21, 3) * 0.05
    return y + rng.randn(B, 21, 3) * 0.01, y


def _seg(rng, present=3):
    logits = rng.randn(B, MAP, MAP, 3) * 2.0
    labels = rng.randint(0, present, (B, MAP, MAP))
    return logits, labels


TERMS = {
    "smooth_l1": (jl.smooth_l1, tl.smooth_l1, _smooth, 1),
    "normal": (lambda a, b: jl.normal_vector_loss(a, b, jnp.asarray(FACES)),
               lambda a, b: tl.normal_vector_loss(a, b, FACES), _coords, 1),
    "edge": (lambda a, b: jl.edge_length_loss(a, b, jnp.asarray(FACES)),
             lambda a, b: tl.edge_length_loss(a, b, FACES), _coords, 1),
    "cross_entropy": (
        lambda lg, lab: jl.weighted_cross_entropy(lg, lab, (0.1, 0.45, 0.45)),
        lambda lg, lab: tl.weighted_cross_entropy(lg, lab, (0.1, 0.45, 0.45)),
        _seg, 1),
    "lovasz": (jl.lovasz_softmax, tl.lovasz_softmax, _seg, 1),
    "lovasz_class_absent": (jl.lovasz_softmax, tl.lovasz_softmax,
                            lambda rng: _seg(rng, present=2), 1),
}


def _jax_value_and_grad(fn, args, n_diff):
    """fn's value and gradient with respect to its first n_diff arguments,
    fp64 (the caller enables x64)."""
    jargs = [jnp.asarray(a) for a in args]

    def f(*diff):
        return fn(*diff, *jargs[n_diff:])

    val, grads = jax.value_and_grad(f, argnums=tuple(range(n_diff)))(
        *jargs[:n_diff])
    return float(val), [np.asarray(g) for g in grads]


def _torch_value_and_grad(fn, args, n_diff, dtype=torch.float64):
    targs = [torch.tensor(a, dtype=dtype, requires_grad=i < n_diff)
             if np.issubdtype(np.asarray(a).dtype, np.floating)
             else torch.from_numpy(np.asarray(a)) for i, a in enumerate(args)]
    val = fn(*targs)
    grads = torch.autograd.grad(val, targs[:n_diff])
    return float(val.detach()), [g.numpy() for g in grads]


# Measured at fp64 over these inputs: values agree to 1.8e-16 relative (0
# for all but smooth_l1), gradients to 3.2e-16 of the gradient's max |value|
# (summation order only). Bound: 1e-12 relative.
@pytest.mark.parametrize("term", sorted(TERMS))
def test_term_and_gradient_match_jax_fp64(term):
    jfn, tfn, make, n_diff = TERMS[term]
    args = make(np.random.RandomState(sorted(TERMS).index(term)))
    with x64():
        jval, jgrads = _jax_value_and_grad(jfn, args, n_diff)
    tval, tgrads = _torch_value_and_grad(tfn, args, n_diff)
    assert np.isfinite(tval) and tval > 0
    np.testing.assert_allclose(tval, jval, rtol=1e-12, atol=0)
    for tg, jg in zip(tgrads, jgrads):
        assert tg.shape == jg.shape
        scale = np.abs(jg).max()
        assert scale > 0
        assert np.abs(tg - jg).max() <= 1e-12 * scale


def test_lovasz_masks_an_absent_class():
    """Without class 2 in the labels, its errors do not count: the loss is
    the mean over the two present classes."""
    logits, labels = _seg(np.random.RandomState(7), present=2)
    t = torch.from_numpy(logits)
    full = tl.lovasz_softmax(t, torch.from_numpy(labels))
    # class 2 alone as if it were present: the mean of the three minus it
    per_class = []
    for c in range(3):
        fg = torch.from_numpy((labels == c).reshape(-1).astype(np.float64))
        err = (fg - t[..., c].reshape(-1)).abs()
        order = torch.argsort(-err, stable=True)
        w = torch.empty_like(err).scatter_(0, order,
                                           tl._lovasz_grad(fg[order]))
        per_class.append(float((err * w).sum()))
    np.testing.assert_allclose(float(full), np.mean(per_class[:2]),
                               rtol=1e-12)


def test_normal_loss_is_zero_for_a_planar_gt():
    """A planar gt mesh predicted exactly: every predicted edge lies in the
    plane, normal to the gt face normals."""
    rng = np.random.RandomState(8)
    gt = rng.randn(B, 778, 3) * 0.05
    gt[..., 2] = 0.0
    t = torch.from_numpy(gt)
    assert float(tl.normal_vector_loss(t, t, FACES)) == 0.0
    with x64():
        assert float(jl.normal_vector_loss(jnp.asarray(gt), jnp.asarray(gt),
                                           jnp.asarray(FACES))) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weighted_cross_entropy_is_torch_cross_entropy(dtype):
    logits, labels = _seg(np.random.RandomState(9))
    w = (0.1, 0.45, 0.45)
    lg = torch.tensor(logits, dtype=dtype, requires_grad=True)
    lab = torch.from_numpy(labels)
    got = tl.weighted_cross_entropy(lg, lab, w)
    (g_got,) = torch.autograd.grad(got, lg)
    want = F.cross_entropy(lg.permute(0, 3, 1, 2), lab,
                           weight=torch.tensor(w, dtype=dtype))
    (g_want,) = torch.autograd.grad(want, lg)
    # measured: 0 at fp64, 1 ulp at fp32 (another summation order)
    eps = torch.finfo(dtype).eps
    got, want = float(got.detach()), float(want.detach())
    assert abs(got - want) <= 4 * eps * abs(want)
    assert float((g_got - g_want).abs().max()) <= (
        4 * eps * float(g_want.abs().max()))


def _outputs_targets(rng):
    """Synthetic model outputs (three stages) and targets at B, MAP, IMG."""
    def stage():
        return {
            "pd_joint_uv_left": rng.uniform(-1, 1, (B, 21, 2)),
            "pd_joint_uv_right": rng.uniform(-1, 1, (B, 21, 2)),
            "pd_mesh_uv_left": rng.uniform(-1, 1, (B, 778, 2)),
            "pd_mesh_uv_right": rng.uniform(-1, 1, (B, 778, 2)),
            "pd_joint_xyz_left": rng.randn(B, 21, 3) * 0.05,
            "pd_joint_xyz_right": rng.randn(B, 21, 3) * 0.05,
            "pd_mesh_xyz_left": rng.randn(B, 778, 3) * 0.05,
            "pd_mesh_xyz_right": rng.randn(B, 778, 3) * 0.05,
            "pd_offset": rng.randn(B, 3) * 0.3,
        }

    outputs = {"stages": [stage() for _ in range(3)],
               "seg": rng.randn(B, MAP, MAP, 3),
               "dense": rng.rand(B, MAP, MAP, 3)}
    targets = {
        "joint_2d_left": rng.uniform(-1, 1, (B, 21, 3)),
        "joint_2d_right": rng.uniform(-1, 1, (B, 21, 3)),
        "mesh_2d_left": rng.uniform(-1, 1, (B, 778, 3)),
        "mesh_2d_right": rng.uniform(-1, 1, (B, 778, 3)),
        "joint_3d_left": rng.randn(B, 21, 3) * 0.05,
        "joint_3d_right": rng.randn(B, 21, 3) * 0.05,
        "mesh_3d_left": rng.randn(B, 778, 3) * 0.05,
        "mesh_3d_right": rng.randn(B, 778, 3) * 0.05,
        "center_left": rng.randn(B, 1, 3) * 0.05,
        "center_right": rng.randn(B, 1, 3) * 0.05,
        "seg": rng.randint(0, 3, (B, IMG, IMG)).astype(np.int32),
        "dense": rng.rand(B, IMG, IMG, 3),
    }
    return outputs, targets


def _tree(x, leaf):
    if isinstance(x, dict):
        return {k: _tree(v, leaf) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(v, leaf) for v in x]
    return leaf(x)


# Measured over this input (keys of order 0.003-1.1): at fp64 keys to
# 5.0e-16 relative, the total equal, gradients to 5.6e-15 of each tensor's
# max |value|; at fp32 keys to 2.0e-7 relative, the total equal, gradients to
# 5.9e-6 of the max (both packages in fp32 end to end; the bilinear resize and
# the sums reassociate). Bounds (values, gradients): about ten times these.
TOL = {"float64": (1e-12, 1e-12), "float32": (2e-6, 5e-5)}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("fused_stages", [False, True])
def test_dir_losses_match_jax(fused_stages, dtype):
    outputs, targets = _outputs_targets(np.random.RandomState(10))
    cfg, jcfg = ModelConfig(), JModelConfig()
    tol, gtol = TOL[dtype]
    tdt = getattr(torch, dtype)

    with x64(dtype == "float64"):
        def jtotal(out):
            d = jl.dir_losses(out, jtargets, jcfg,
                              jnp.asarray(FACES_LEFT.numpy()),
                              jnp.asarray(FACES.numpy()),
                              fused_stages=fused_stages)
            return jl.total_loss(d), d

        jdt = getattr(jnp, dtype)
        jout = _tree(outputs, lambda a: jnp.asarray(a, jdt))
        jtargets = _tree(targets, lambda a: jnp.asarray(
            a, jdt if a.dtype.kind == "f" else a.dtype))
        (jtot, jdict), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
            jout)
        jdict = {k: float(v) for k, v in jdict.items()}
        jtot = float(jtot)
        jgrads = jax.tree.map(np.asarray, jgrads)

    tout = _tree(outputs, lambda a: torch.tensor(a, dtype=tdt,
                                                 requires_grad=True))
    ttargets = _tree(targets, lambda a: torch.tensor(
        a, dtype=tdt if a.dtype.kind == "f" else torch.int64))
    tdict = tl.dir_losses(tout, ttargets, cfg, FACES_LEFT, FACES,
                          fused_stages=fused_stages)
    ttot = tl.total_loss(tdict)
    assert sorted(tdict) == sorted(jdict)     # key for key
    assert all(v.dtype == tdt for v in tdict.values())
    for k, v in tdict.items():
        np.testing.assert_allclose(v.item(), jdict[k], rtol=tol, err_msg=k)
    np.testing.assert_allclose(ttot.item(), jtot, rtol=tol)

    leaves = [tout["seg"], tout["dense"]] + [
        s[k] for s in tout["stages"] for k in sorted(s)]
    jleaves = [jgrads["seg"], jgrads["dense"]] + [
        s[k] for s in jgrads["stages"] for k in sorted(s)]
    for t, g, jg in zip(leaves, torch.autograd.grad(ttot, leaves), jleaves):
        assert np.abs(g.numpy() - jg).max() <= gtol * np.abs(jg).max()
    if fused_stages:
        # the fused dict sums to the per-stage dict's total
        per_stage = tl.total_loss(tl.dir_losses(tout, ttargets, cfg,
                                                FACES_LEFT, FACES))


        np.testing.assert_allclose(ttot.item(), per_stage.item(), rtol=tol)
