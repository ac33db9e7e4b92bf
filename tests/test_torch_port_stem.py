"""Kernel K4 of the port (stem BN + ReLU + max pool + layer1_0 as one op)
against dir_tpu on the CPU.

The port's plain version is held against the Pallas kernel in interpret
mode (as tests/test_pallas_bottleneck.py runs it), at fp32 and bf16, at the
JAX test's size and at the stem's own widths (C = 64, mid = 64). No model
calls the op in either package, so there is no module test. The CUDA kernel
itself is held against the plain version by tests/test_torch_port_gpu.py,
on the card.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.ops.pallas_bottleneck import fused_stem_bottleneck as jstem

from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_stem_bottleneck as st

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import max_err  # noqa: E402

T = torch.from_numpy


def _inputs(seed, b, h2, w2, c, mid, o):
    """Seeded raw stem output, BN affine and folded weights, numpy fp32."""
    rng = np.random.RandomState(seed)

    def w(*shape):
        return (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
                ).astype(np.float32)

    def bias(n):
        return rng.uniform(-0.5, 0.5, n).astype(np.float32)

    x = rng.randn(b, h2, w2, c).astype(np.float32)
    g1 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    t1 = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    ws = [w(c, mid), bias(mid), w(3, 3, mid, mid), bias(mid), w(mid, o),
          bias(o), w(c, o), bias(o)]
    return x, g1, t1, ws


def _counts():
    f = st.fused_stem_bottleneck
    return f.launches, f.plain_runs


SIZES = [
    (2, 16, 16, 16, 8, 32),      # the JAX kernel test's size
    (1, 16, 24, 64, 64, 256),    # the stem's widths, a non-square map
]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stem_plain_matches_pallas_interpret(size, dtype):
    x, g1, t1, ws = _inputs(1, *size)
    b, h2, w2, _, _, o = size
    ref = jstem(jnp.asarray(x).astype(dtype), jnp.asarray(g1),
                jnp.asarray(t1), *map(jnp.asarray, ws), interpret=True)
    tx = T(x).to(getattr(torch, dtype))
    before = _counts()
    out = st.fused_stem_bottleneck(tx, T(g1), T(t1), *map(T, ws))
    # on the CPU the wrapper ran the plain version: no launch is counted
    assert _counts() == (before[0], before[1] + 1)
    assert out.dtype == tx.dtype and out.shape == (b, h2 // 2, w2 // 2, o)
    err = max_err(out.float(), np.asarray(ref, np.float32))
    if dtype == "float32":
        # measured 4.8e-7 and 8.3e-7 (outputs up to 3.6): fp32 sums in
        # another order; the JAX kernel test's bound
        assert err <= 2e-5
    else:
        # the affine's product and sum are each rounded to bf16 in the plain
        # version, as the TPU does; XLA's interpret mode on the CPU gave the
        # same bits here: measured 0 at both sizes. One bf16 ulp at
        # |out| < 4 allowed.
        assert err <= 2 ** -6


def test_stem_plain_is_affine_relu_pool_then_the_block():
    """The plain version against its parts written out another way: zero
    padding of the pool is exact after the ReLU."""
    x, g1, t1, ws = _inputs(2, 2, 8, 12, 16, 16, 32)
    out = st.fused_stem_bottleneck_plain(T(x), T(g1), T(t1), *map(T, ws))
    a = np.maximum(x * g1 + t1, 0.0)
    ap = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)))
    pooled = np.max(np.stack(
        [ap[:, dy:dy + 8:2, dx:dx + 12:2] for dy in range(3)
         for dx in range(3)]), axis=0)
    want = fb.fused_bottleneck_infer_plain(T(pooled), *map(T, ws))
    # the same fp32 operations: measured 0
    assert max_err(out, want.numpy()) <= 1e-6


def test_stem_wrapper_refuses_bad_shapes_and_devices():
    x, g1, t1, ws = _inputs(3, 1, 16, 16, 16, 16, 32)
    args = (T(g1), T(t1), *map(T, ws))
    before = _counts()
    with pytest.raises(ValueError):       # pooled height 6: no multiple of 4
        st.fused_stem_bottleneck(torch.zeros(1, 12, 16, 16), *args)
    with pytest.raises(ValueError):       # odd width
        st.fused_stem_bottleneck(torch.zeros(1, 16, 15, 16), *args)
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        st.fused_stem_bottleneck(torch.zeros(1, 16, 16, 16, device="meta"),
                                 *args)
    assert _counts() == before
