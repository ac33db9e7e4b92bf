"""The port's backbone options against dir_tpu on the CPU: the layer2 guard
of the fused bottleneck (``fused_l2_bands``, the JAX package's
``FUSED_L2_BANDS``), the space-to-depth stem, and the int8 backbone.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.models import resnet as jresnet
from dir_tpu.train import checkpoint as ck

from dir_tpu_torch import weights as tweights
from dir_tpu_torch.models import resnet as tresnet
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import quant as tquant

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (load_into, max_err,  # noqa: E402
                                rand_variables)

T = torch.from_numpy
LAYERS = (1, 2, 1, 1)


@pytest.fixture(scope="module")
def backbone():
    """A seeded (1, 2, 1, 1) JAX backbone at 256^2, its variables and its
    unfused fp32 pyramid."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 256, 256, 3).astype(np.float32)
    jmod = jresnet.ResNetPyramid(layers=LAYERS)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = rand_variables(rng, shapes)
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    return x, variables, ref


def _port_pyramid(x, variables, **kw):
    tmod = tresnet.ResNetPyramid(LAYERS, **kw).eval()
    load_into(tmod, variables, ck.resnet_mapping("", (), LAYERS))
    f = fb.fused_bottleneck_infer
    before = (f.launches + f.streamed_launches, f.plain_runs)
    with torch.no_grad():
        feats = tmod(T(x).permute(0, 3, 1, 2))
    counts = (f.launches + f.streamed_launches - before[0],
              f.plain_runs - before[1])
    return [t.permute(0, 2, 3, 1) for t in feats], counts


@pytest.mark.parametrize("bands,fused_blocks", [(0, []), (4, [4])])
def test_layer2_guard_matches_jax(backbone, monkeypatch, bands, fused_blocks):
    """With fused_l2_bands=4, layer2_1 (32x32, 512 channels, stride 1) goes
    through the fused route with bands=4, in the port as in the JAX backbone
    with _FUSED_L2_BANDS patched to 4; with 0 it does not. (layer1 has one
    block, whose 64-channel input the guard never takes.)"""
    x, variables, ref = backbone
    seen = []
    real = tresnet.fused_bottleneck_infer
    monkeypatch.setattr(
        tresnet, "fused_bottleneck_infer",
        lambda *a, **k: seen.append(k.get("bands", 0)) or real(*a, **k))
    feats, counts = _port_pyramid(x, variables, fused_eval=True,
                                  fused_l2_bands=bands)
    assert seen == fused_blocks
    assert counts == (0, len(fused_blocks))   # the CPU route, never a launch

    monkeypatch.setattr(jresnet, "_FUSED_L2_BANDS", bands)
    jmod = jresnet.ResNetPyramid(layers=LAYERS, fused_eval=True)
    jfeats = jmod.apply(variables, jnp.asarray(x), train=False)
    # measured max abs err over c1..c4: 1.7e-6 against the JAX backbone with
    # the same guard and against its unfused pyramid (maps of order 1)
    for out, jf, r in zip(feats, jfeats, ref):
        assert max_err(out, jf) < 1e-5
        assert max_err(out, r) < 1e-5


def test_space_to_depth_and_stem_rewrite_bit_for_bit():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tresnet.space_to_depth(T(x)).numpy(),
        np.asarray(jresnet.space_to_depth(jnp.asarray(x))))
    w7 = rng.randn(7, 7, 3, 64).astype(np.float32)
    w4 = tresnet.stem_weights_to_s2d(T(w7))
    assert w4.shape == (4, 4, 12, 64)
    np.testing.assert_array_equal(
        w4.numpy(), np.asarray(jresnet.stem_weights_to_s2d(jnp.asarray(w7))))


def test_s2d_pyramid_equals_conv7_on_carried_weights(backbone):
    """conv7 weights carried across from the JAX package load into an s2d
    model through weights.adapt_stem_s2d, and the two pyramids agree; the
    s2d JAX pyramid on adapt_stem_s2d's weights agrees as well."""
    x, variables, ref = backbone
    conv7, _ = _port_pyramid(x, variables)

    sd = ck.export_torch_state(
        jax.tree.map(np.asarray, variables["params"]),
        jax.tree.map(np.asarray, variables["batch_stats"]),
        ck.resnet_mapping("", (), LAYERS))
    sd = tweights.adapt_stem_s2d({k: T(np.array(v)) for k, v in sd.items()})
    assert tuple(sd["conv1.weight"].shape) == (64, 12, 4, 4)
    tmod = tresnet.ResNetPyramid(LAYERS, stem="s2d").eval()
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        s2d = [t.permute(0, 2, 3, 1) for t in tmod(T(x).permute(0, 3, 1, 2))]

    jparams = ck.adapt_stem_s2d(jax.tree.map(np.asarray, variables["params"]))
    np.testing.assert_array_equal(
        sd["conv1.weight"].permute(2, 3, 1, 0).numpy(),
        np.asarray(jparams["conv1"]["kernel"]))
    jfeats = jresnet.ResNetPyramid(layers=LAYERS, stem="s2d").apply(
        {"params": jparams, "batch_stats": variables["batch_stats"]},
        jnp.asarray(x), train=False)
    # measured max abs err over c1..c4: s2d vs conv7 in the port 8.3e-7,
    # s2d port vs s2d JAX 1.7e-6, s2d port vs the JAX conv7 pyramid 1.8e-6
    for a, b, jf, r in zip(s2d, conv7, jfeats, ref):
        assert max_err(a, b) < 1e-5
        assert max_err(a, jf) < 1e-5
        assert max_err(a, r) < 1e-5


def test_int8_pyramid_matches_jax(backbone):
    """``quant_eval`` on the whole backbone, dynamic scales: every bottleneck
    conv runs int8 (5 blocks x 3 convs + 4 projections; the stem stays
    floating point), against the JAX pyramid with the same flag."""
    x, variables, ref = backbone
    jfeats = jresnet.ResNetPyramid(layers=LAYERS, quant_eval=True).apply(
        variables, jnp.asarray(x), train=False)
    calls = []
    real = tquant.conv_int8
    try:
        tquant.conv_int8 = lambda *a, **k: calls.append(1) or real(*a, **k)
        feats, counts = _port_pyramid(x, variables, quant_eval=True)
    finally:
        tquant.conv_int8 = real
    assert len(calls) == 19 and counts == (0, 0)
    # c1 (one block) agrees to fp32 rounding: measured 4.8e-7. From layer2
    # on, an fp32 ulp upstream has moved int8 values by one step (about 1e-2
    # of a conv input's range, rescaled by the next batch's own |max|) and
    # the difference is carried along: measured 3.4e-3, 6.4e-3 and 7.9e-3 on
    # c2..c4 (maps up to 1.8), beside int8's own error against the
    # floating-point pyramid of 2.5e-2, 1.9e-2, 1.4e-2 and 1.2e-2. Block by
    # block on equal inputs the two agree to fp32 rounding
    # (tests/test_torch_port_quant.py).
    bounds = (1e-5, 3e-2, 3e-2, 3e-2)
    for out, jf, r, bound in zip(feats, jfeats, ref, bounds):
        assert max_err(out, jf) < bound
        assert max_err(out, r) < 0.1
