"""Kernels K1 and K2 (the fused bottleneck, bands=0 and bands=N) of the port
against dir_tpu.

On the CPU the port's plain version is held against the Pallas kernel in
interpret mode (as tests/test_pallas_bottleneck.py runs it), at fp32 and
bf16, with and without the projection; the port's Bottleneck module is
held against the JAX module. The CUDA kernel itself is held against the
plain version by tests/test_torch_port_gpu.py, on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.models.resnet import Bottleneck as JBottleneck
from dir_tpu.ops.pallas_bottleneck import fold_bn as jfold_bn
from dir_tpu.ops.pallas_bottleneck import fused_bottleneck_infer as jfused
from dir_tpu.train import checkpoint as ck

from dir_tpu_torch.models.resnet import Bottleneck
from dir_tpu_torch.ops import fused_bottleneck as fb

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (load_into, max_err,  # noqa: E402
                                rand_variables)


def _folded(rng, c, mid, o, down):
    """Seeded folded weights in the kernel layout, as numpy fp32."""
    def w(*shape):
        return (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
                ).astype(np.float32)

    def b(n):
        return rng.uniform(-0.5, 0.5, n).astype(np.float32)

    ws = [w(c, mid), b(mid), w(3, 3, mid, mid), b(mid), w(mid, o), b(o)]
    ws += [w(c, o), b(o)] if down else [None, None]
    return ws


def _as(arrs, fn):
    return [None if a is None else fn(a) for a in arrs]


def _counts():
    """(kernel launches of K1 and K2 together, plain-version runs) of the
    wrapper so far."""
    f = fb.fused_bottleneck_infer
    return f.launches + f.streamed_launches, f.plain_runs


@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(down, dtype):
    rng = np.random.RandomState(0)
    c, mid = 32, 8
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    ws = _folded(rng, c, mid, c, down)
    jx = jnp.asarray(x).astype(dtype)
    ref = jfused(jx, *_as(ws, jnp.asarray), interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = fb.fused_bottleneck_infer_plain(tx, *_as(ws, torch.from_numpy))
    assert out.dtype == tx.dtype and out.shape == (2, 8, 8, c)
    err = max_err(out.float(), np.asarray(ref, np.float32))
    if dtype == "float32":
        # the JAX kernel test's own bound; measured 4.8e-7
        assert err <= 2e-5
    else:
        # same rounding points: measured 0 (bit-equal); the bound allows one
        # bf16 ulp at |out| < 4 where a different fp32 summation order
        # rounds the other way
        assert err <= 2 ** -6


@pytest.mark.parametrize("bands", [2, 4])
@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_route_matches_pallas_interpret(down, dtype, bands):
    """fused_bottleneck_infer(bands=N) on the CPU (the plain version: banding
    changes the schedule, not the math) against the row-banded Pallas kernel
    in interpret mode."""
    rng = np.random.RandomState(4)
    c, mid = 32, 8
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    ws = _folded(rng, c, mid, c, down)
    jx = jnp.asarray(x).astype(dtype)
    ref = jfused(jx, *_as(ws, jnp.asarray), interpret=True, bands=bands)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    before = _counts()
    out = fb.fused_bottleneck_infer(tx, *_as(ws, torch.from_numpy),
                                    bands=bands)
    assert _counts() == (before[0], before[1] + 1)
    assert out.dtype == tx.dtype and out.shape == (2, 8, 8, c)
    err = max_err(out.float(), np.asarray(ref, np.float32))
    if dtype == "float32":
        # measured at most 4.8e-7 over the four cases; the JAX kernel
        # test's bound
        assert err <= 2e-5
    else:
        # same rounding points: measured 0 (bit-equal) in all four cases;
        # one bf16 ulp at |out| < 4 allowed
        assert err <= 2 ** -6


def test_bands_must_divide_the_height():
    rng = np.random.RandomState(5)
    ws = _as(_folded(rng, 16, 16, 16, False), torch.from_numpy)
    x = torch.zeros(1, 8, 8, 16)
    before = _counts()
    for bands in (3, -1):
        with pytest.raises(ValueError):
            fb.fused_bottleneck_infer(x, *ws, bands=bands)
    assert _counts() == before


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.randn(3, 3, 8, 16).astype(np.float32)
    s, t, m = (rng.randn(16).astype(np.float32) for _ in range(3))
    v = rng.uniform(0.5, 2, 16).astype(np.float32)
    jw, jb = jfold_bn(*map(jnp.asarray, (k, s, t, m, v)))
    tw, tb = fb.fold_bn(*map(torch.from_numpy, (k, s, t, m, v)))
    # measured max abs err: 0 and 0 (one fp32 op sequence)
    assert max_err(tw, jw) <= 1e-6 and max_err(tb, jb) <= 1e-6


@pytest.mark.parametrize("down", [False, True])
def test_bottleneck_module_matches_jax(down):
    """The port's Bottleneck, fused (guard taken: 128 ch at 64^2) and
    unfused, against the JAX module's unfused eval path at fp32; on the
    CPU the fused path must count one plain run and no kernel launch."""
    rng = np.random.RandomState(2)
    c, mid = 128, 32
    x = rng.randn(1, 64, 64, c).astype(np.float32)
    jmod = JBottleneck(mid, stride=1, downsample=down, expansion=c // mid)
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x), train=False)

    errs = []
    for fused in (False, True):
        tmod = Bottleneck(c, mid, 1, down, fused_eval=fused).eval()
        load_into(tmod, variables,
                  ck._entries_bottleneck("", (), has_down=down))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        launches, runs = _counts()
        with torch.no_grad():
            out = tmod(xt).permute(0, 2, 3, 1)
        assert _counts() == (launches, runs + int(fused))
        errs.append(max_err(out, ref))
    # measured max abs err: unfused 4.8e-7, fused 4.8e-7 (identity) and
    # 1.4e-6 (projection), on outputs of order 1-10
    assert errs[0] < 1e-5 and errs[1] < 1e-5


def test_guard_keeps_other_blocks_unfused():
    """Stride 2, < 128 input channels or < 4096 positions stay unfused."""
    cases = [(Bottleneck(128, 32, 2, True, fused_eval=True), (1, 128, 64, 64)),
             (Bottleneck(64, 32, 1, True, fused_eval=True), (1, 64, 64, 64)),
             (Bottleneck(128, 32, 1, False, fused_eval=True), (1, 128, 32, 32))]
    for mod, shape in cases:
        before = _counts()
        with torch.no_grad():
            mod.eval()(torch.zeros(shape))
        assert _counts() == before


def test_wrapper_routes_cpu_to_plain_and_counts():
    rng = np.random.RandomState(3)
    ws = _as(_folded(rng, 16, 16, 16, False), torch.from_numpy)
    x = torch.from_numpy(rng.randn(1, 4, 4, 16).astype(np.float32))
    launches, runs = _counts()
    out = fb.fused_bottleneck_infer(x, *ws)
    # the plain version ran in the kernel's place: no launch is counted
    assert _counts() == (launches, runs + 1)
    assert torch.equal(out, fb.fused_bottleneck_infer_plain(x, *ws))


def test_wrapper_refuses_other_devices():
    """No silent fallback: a tensor that is neither CPU nor CUDA raises."""
    ws = [torch.zeros(s, device="meta") for s in
          ((16, 16), (16,), (3, 3, 16, 16), (16,), (16, 16), (16,))]
    before = _counts()
    with pytest.raises(ValueError):
        fb.fused_bottleneck_infer(torch.zeros(1, 4, 4, 16, device="meta"), *ws)
    assert _counts() == before
