"""Int8 serving of the port against dir_tpu on the CPU: ``ops/quant.py``
function by function (integers bit-equal), kernel K3's plain version
against the Pallas kernel in interpret mode and against the port's own
unfused int8 block, every int8 module against its JAX module on the same
weights (dynamic and static scales), calibration through the
``quant_stats`` bridge, and the K3 guard.

The CUDA kernel itself is held against the plain version by
tests/test_torch_port_gpu.py, on the card.

Tolerances of int8 outputs at fp32: both packages walk the same int8 grid
with the same scales, so they agree to fp32 rounding unless an upstream
difference of one fp32 ulp lands on a rounding boundary and moves one int8
value by one step; a bound is therefore stated beside its measured error
and, where a step could show, in steps of the scale.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.models import dir as jdir
from dir_tpu.models import layers as jlayers
from dir_tpu.models import resnet as jresnet
from dir_tpu.ops import quant as jquant
from dir_tpu.ops.pallas_bottleneck import fused_bottleneck_int8_infer as jq8
from dir_tpu.train import checkpoint as ck

from dir_tpu_torch import weights as tweights
from dir_tpu_torch.models import dir as tdir
from dir_tpu_torch.models import layers as tlayers
from dir_tpu_torch.models import resnet as tresnet
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops import quant as tquant

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (load_into, max_err,  # noqa: E402
                                numpy_tree, rand_variables)

T = torch.from_numpy


def _nchw(x: np.ndarray) -> torch.Tensor:
    return T(x).permute(0, 3, 1, 2)


# ---------------------------------------------------------------- ops/quant


def test_weight_quant_bit_equal():
    rng = np.random.RandomState(0)
    w = rng.randn(3, 3, 8, 16).astype(np.float32)
    w[..., 5] = 0.0                       # an all-zero channel: scale 1
    jq, js = jquant.quantize_weight_per_channel(jnp.asarray(w))
    tq, ts = tquant.quantize_weight_per_channel(T(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[5]) == 1.0 and int(tq[..., 5].abs().max()) == 0


@pytest.mark.parametrize("static", [False, True])
def test_act_quant_bit_equal(static):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 4, 8).astype(np.float32) * 3
    if static:
        scale = np.float32(0.013)         # |x| beyond 127 * scale saturates
        jq = jquant.quantize_act(jnp.asarray(x), jnp.asarray(scale))
        tq = tquant.quantize_act(T(x), torch.tensor(scale))
        assert int(tq.max()) == 127 and int(tq.min()) == -127
    else:
        jq, js = jquant.quantize_act_dynamic(jnp.asarray(x))
        tq, ts = tquant.quantize_act_dynamic(T(x))
        assert float(ts) == float(js)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        tquant.scale_from_amax(T(np.float32([0.0, 2.54]))).numpy(),
        np.asarray(jquant.scale_from_amax(jnp.asarray([0.0, 2.54]))))


CONVS = [
    # shape, kernel, out channels, stride, padding
    ((2, 8, 8, 16), 3, 8, (1, 1), ((1, 1), (1, 1))),
    ((2, 8, 8, 16), 1, 12, (2, 2), "SAME"),
    ((2, 9, 9, 16), 3, 8, (2, 2), "SAME"),
    ((1, 8, 8, 12), 4, 8, (1, 1), ((2, 1), (2, 1))),     # the s2d stem's
    ((1, 16, 16, 3), 7, 8, (2, 2), ((3, 3), (3, 3))),    # the conv7 stem's
]


@pytest.mark.parametrize("shape,k,o,stride,padding", CONVS)
def test_quant_conv_grid_exact(shape, k, o, stride, padding):
    """Inputs already on the int8 grid (power-of-two scales): the s32 sums
    are bit-equal to XLA's integer conv, and the quantized conv equals the
    JAX package's and the float conv."""
    rng = np.random.RandomState(2)
    sx, sw = 0.5, 0.25
    xi = rng.randint(-127, 128, shape).astype(np.float32)
    xi.flat[0] = 127.0                    # pins the dynamic scale
    wi = rng.randint(-127, 128, (k, k, shape[-1], o)).astype(np.float32)
    wi[0, 0, 0, :] = 127.0                # pins every per-channel scale
    x, w = xi * sx, wi * sw
    bias = rng.randn(o).astype(np.float32)

    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    want_s32 = jax.lax.conv_general_dilated(
        jnp.asarray(xi.astype(np.int8)), jnp.asarray(wi.astype(np.int8)),
        stride, padding, dimension_numbers=dn,
        preferred_element_type=jnp.int32)
    got_s32 = tquant.conv_s32(T(xi.astype(np.int8)), T(wi.astype(np.int8)),
                              stride, padding)
    assert got_s32.dtype == torch.int32
    np.testing.assert_array_equal(got_s32.numpy(), np.asarray(want_s32))

    jgot = jquant.quant_conv(jnp.asarray(x), jnp.asarray(w), stride, padding,
                             jnp.asarray(bias), out_dtype=jnp.float32)
    tgot = tquant.quant_conv(T(x), T(w), stride, padding, T(bias),
                             out_dtype=torch.float32)
    # same integers, the same two fp32 operations after them: measured 0
    np.testing.assert_array_equal(tgot.numpy(), np.asarray(jgot))
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, padding,
        dimension_numbers=dn) + bias
    # the recipe's own bound (tests/test_quant.py)
    np.testing.assert_allclose(tgot.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


def test_conv_int8_static_scale_and_cast():
    """``conv_int8`` with a calibrated scale and a bf16 result, and
    ``quant_conv`` with ``act_scale``, bit-equal to the JAX package."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    w = (rng.randn(3, 3, 16, 8) * 0.1).astype(np.float32)
    bias = rng.randn(8).astype(np.float32)
    sc = np.float32(0.02)
    jout = jquant.quant_conv(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME",
                             jnp.asarray(bias), jnp.bfloat16, jnp.asarray(sc))
    tout = tquant.quant_conv(T(x), T(w), (1, 1), "SAME", T(bias),
                             torch.bfloat16, torch.tensor(sc))
    assert tout.dtype == torch.bfloat16
    np.testing.assert_array_equal(tout.float().numpy(),
                                  np.asarray(jout, np.float32))


# ------------------------------------------------------------- kernel K3


def _folded(rng, c, mid, o, down):
    def w(*shape):
        return (rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
                ).astype(np.float32)

    def b(n):
        return rng.uniform(-0.5, 0.5, n).astype(np.float32)

    ws = [w(c, mid), b(mid), w(3, 3, mid, mid), b(mid), w(mid, o), b(o)]
    return ws + ([w(c, o), b(o)] if down else [None, None])


def _as(arrs, fn):
    return [None if a is None else fn(a) for a in arrs]


@pytest.mark.parametrize("down,bands", [(False, 1), (True, 1), (False, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_plain_matches_pallas_interpret(down, bands, dtype):
    rng = np.random.RandomState(0)
    c, mid = 32, 8
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    ws = _folded(rng, c, mid, c, down)
    scales = [np.float32(np.abs(x).max() / 127), np.float32(0.02),
              np.float32(0.015)]
    jws = _as(ws, jnp.asarray)
    ref = jq8(jnp.asarray(x).astype(dtype), *jws[:6],
              *map(jnp.asarray, scales), jws[6], jws[7], interpret=True,
              bands=bands)
    tws = _as(ws, T)
    tx = T(x).to(getattr(torch, dtype))
    before = (q8.fused_bottleneck_int8_infer.launches,
              q8.fused_bottleneck_int8_infer.plain_runs)
    out = q8.fused_bottleneck_int8_infer(
        tx, *tws[:6], *[torch.tensor(s) for s in scales], tws[6], tws[7],
        bands=bands)
    # on the CPU the wrapper ran the plain version: no launch is counted
    assert (q8.fused_bottleneck_int8_infer.launches,
            q8.fused_bottleneck_int8_infer.plain_runs) == (before[0],
                                                           before[1] + 1)
    assert out.dtype == tx.dtype and out.shape == (2, 8, 8, c)
    err = max_err(out.float(), np.asarray(ref, np.float32))
    if dtype == "float32":
        # measured at most 2.4e-7 (outputs up to 3.9); the JAX kernel test's
        # bound. No int8 value moved: a step of conv3's input is 0.015 wide
        # and would show as about 1e-3.
        assert err <= 2e-5
    else:
        # the same rounding points: measured 0 (bit-equal) in all three
        # cases; one bf16 ulp at |out| < 4 allowed
        assert err <= 2 ** -6


def test_int8_wrapper_refuses_bad_bands_and_dynamic_scales():
    rng = np.random.RandomState(1)
    ws = _as(_folded(rng, 32, 32, 32, False), T)
    x = torch.zeros(1, 8, 8, 32)
    s = torch.tensor(0.1)
    f = q8.fused_bottleneck_int8_infer
    before = (f.launches, f.plain_runs)
    for bands in (3, 0):
        with pytest.raises(ValueError):
            f(x, *ws[:6], s, s, s, bands=bands)
    with pytest.raises(TypeError):        # a dynamic scale: none given
        f(x, *ws[:6], None, s, s)
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        f(x.to("meta"), *ws[:6], s, s, s)
    assert (f.launches, f.plain_runs) == before


# ------------------------------------------------------ modules against JAX


def _calibrate(tmod, *args, **kw):
    with torch.no_grad(), tquant.calibrating(tmod):
        return tmod(*args, **kw)


def _assert_stats_equal(tmod, jstats, names=None):
    """The port's calibrated maxes against a flat JAX quant_stats dict."""
    filled = tmod.quant_stats.filled
    assert filled == set(jstats) if names is None else set(names)
    for name in filled:
        # one reduction over the same fp32 values: measured equal; where the
        # input itself differs by an ulp so may the max
        np.testing.assert_allclose(float(getattr(tmod.quant_stats, name)),
                                   float(jstats[name]), rtol=1e-6)


@pytest.mark.parametrize("down,stride", [(False, 1), (True, 2)])
def test_bottleneck_int8_matches_jax(down, stride):
    """Dynamic, calibrating and static forwards of the int8 Bottleneck on
    the JAX module's weights."""
    rng = np.random.RandomState(4)
    c, mid = 32, 8
    x = rng.randn(2, 16, 16, c).astype(np.float32)
    kw = dict(stride=stride, downsample=down, expansion=c // mid)
    jdyn = jresnet.Bottleneck(mid, quant_eval=True, **kw)
    jsta = jresnet.Bottleneck(mid, quant_eval=True, quant_static=True, **kw)
    variables = rand_variables(rng, jdyn.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    jx = jnp.asarray(x)
    ref_dyn = jdyn.apply(variables, jx, train=False)
    ref_cal, ups = jsta.apply(variables, jx, train=False,
                              mutable=["quant_stats"])
    ref_sta = jsta.apply(jquant.merge_calibration(variables, ups), jx * 1.5,
                         train=False)

    entries = ck._entries_bottleneck("", (), has_down=down)
    tdyn = tresnet.Bottleneck(c, mid, stride, down, quant_eval=True).eval()
    tsta = tresnet.Bottleneck(c, mid, stride, down, quant_eval=True,
                              quant_static=True).eval()
    load_into(tdyn, variables, entries)
    load_into(tsta, variables, entries)
    with torch.no_grad():
        out_dyn = tdyn(_nchw(x)).permute(0, 2, 3, 1)
        assert not tdyn.quant_stats.filled      # dynamic touches no buffer
        with pytest.raises(RuntimeError, match="never calibrated"):
            tsta(_nchw(x))
        out_cal = _calibrate(tsta, _nchw(x)).permute(0, 2, 3, 1)
        out_sta = tsta(_nchw(x * 1.5)).permute(0, 2, 3, 1)
    _assert_stats_equal(tsta, numpy_tree(ups["quant_stats"]))
    # measured max abs err 2.4e-7 (identity) and 1.2e-7 (projection) in all
    # three modes; static serves inputs 1.5x beyond the calibrated range
    # (saturation on both sides); outputs up to 6.3. One moved int8 step of
    # conv3's input would show as about 1e-2.
    assert max_err(out_dyn, ref_dyn) < 5e-6
    assert max_err(out_cal, ref_cal) < 5e-6
    assert max_err(out_sta, ref_sta) < 5e-6


@pytest.mark.parametrize("with_pair,channels", [(False, 64), (False, 32),
                                                (True, 32)])
def test_residual_int8_matches_jax(with_pair, channels):
    """The int8 Residual with and without ``pair``, equal (64) and unequal
    (32, 48) input widths: dynamic and static against the JAX block, and a
    second calibration pass that only widens the ranges."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, channels).astype(np.float32)
    pair = rng.randn(2, 8, 8, 16).astype(np.float32) if with_pair else None
    jkw = {"pair": jnp.asarray(pair)} if with_pair else {}
    tkw = {"pair": _nchw(pair)} if with_pair else {}
    in_dim = channels + (16 if with_pair else 0)
    jdyn = jlayers.Residual(64, quant_eval=True)
    jsta = jlayers.Residual(64, quant_eval=True, quant_static=True)
    variables = rand_variables(rng, jdyn.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x), **jkw))
    ref_dyn = jdyn.apply(variables, jnp.asarray(x), train=False, **jkw)
    _, ups = jsta.apply(variables, jnp.asarray(x), train=False,
                        mutable=["quant_stats"], **jkw)
    calibrated = jquant.merge_calibration(variables, ups)
    ref_sta = jsta.apply(calibrated, jnp.asarray(x), train=False, **jkw)

    entries = ck._entries_residual("", ())
    tdyn = tlayers.Residual(in_dim, 64, quant_eval=True).eval()
    tsta = tlayers.Residual(in_dim, 64, quant_eval=True,
                            quant_static=True).eval()
    load_into(tdyn, variables, entries)
    load_into(tsta, variables, entries)
    with torch.no_grad():
        out_dyn = tdyn(_nchw(x), **tkw).permute(0, 2, 3, 1)
        _calibrate(tsta, _nchw(x), **tkw)
        out_sta = tsta(_nchw(x), **tkw).permute(0, 2, 3, 1)
    jstats = numpy_tree(ups["quant_stats"])
    assert ("skip_in" in jstats) == (in_dim != 64)
    _assert_stats_equal(tsta, jstats)
    # measured max abs err 0, 0 and 4.8e-7 over the three cases, dynamic and
    # static alike (outputs up to 5.1); static on the calibration batch
    # equals dynamic (measured 0)
    assert max_err(out_dyn, ref_dyn) < 5e-6
    assert max_err(out_sta, ref_sta) < 5e-6
    assert max_err(out_sta, out_dyn) < 5e-6

    # a second, smaller batch cannot lower a stored max; a larger one raises
    # it, as in the JAX package
    before = {n: float(getattr(tsta.quant_stats, n)) for n in jstats}
    small = {k: v * 0.5 for k, v in tkw.items()}
    _calibrate(tsta, _nchw(x * 0.5), **small)
    assert {n: float(getattr(tsta.quant_stats, n)) for n in jstats} == before
    big = {k: v * 4 for k, v in tkw.items()}
    jbig = {k: v * 4 for k, v in jkw.items()}
    _calibrate(tsta, _nchw(x * 4), **big)
    _, ups2 = jsta.apply(calibrated, jnp.asarray(x * 4), train=False,
                         mutable=["quant_stats"], **jbig)
    _assert_stats_equal(tsta, numpy_tree(ups2["quant_stats"]))
    assert all(float(getattr(tsta.quant_stats, n)) > before[n]
               for n in jstats)


def test_static_serving_saturates_beyond_the_range():
    """Calibrated on a batch, served on one four times larger: finite,
    saturated, and equal to the JAX block's output."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    jsta = jlayers.Residual(64, quant_eval=True, quant_static=True)
    variables = rand_variables(rng, jsta.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    _, ups = jsta.apply(variables, jnp.asarray(x), train=False,
                        mutable=["quant_stats"])
    ref = jsta.apply(jquant.merge_calibration(variables, ups),
                     jnp.asarray(x * 4), train=False)
    tsta = tlayers.Residual(64, 64, quant_eval=True, quant_static=True).eval()
    load_into(tsta, variables, ck._entries_residual("", ()))
    # the scales arrive through the bridge, not through a calibration here
    tweights.load_amax(tsta, {f"quant_stats.{k}": torch.tensor(float(v))
                              for k, v in
                              numpy_tree(ups["quant_stats"]).items()})
    with torch.no_grad():
        out = tsta(_nchw(x * 4)).permute(0, 2, 3, 1)
    assert torch.isfinite(out).all()
    # measured 0 (outputs up to 15)
    assert max_err(out, ref) < 5e-6
    unsat = tlayers.Residual(64, 64, quant_eval=True).eval()
    load_into(unsat, variables, ck._entries_residual("", ()))
    with torch.no_grad():
        dyn = unsat(_nchw(x * 4)).permute(0, 2, 3, 1)
    assert max_err(out, dyn) > 0.1          # saturation shows: measured 0.46


@pytest.mark.parametrize("module", ["attention", "segdense"])
def test_head_int8_matches_jax(module):
    """AttentionPool and SegDenseHead: conv1 int8 with the following BN
    folded in (a conv with a bias of its own), conv2 floating point."""
    rng = np.random.RandomState(9)
    c = 64 if module == "attention" else 32
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    if module == "attention":
        jmod = jdir.AttentionPool(quant_eval=True)
        tmod = tdir.AttentionPool(c, quant_eval=True).eval()
    else:
        jmod = jdir.SegDenseHead(quant_eval=True)
        tmod = tlayers.ConvHead(c, c // 2, 3, quant_eval=True).eval()
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    load_into(tmod, variables, ck._entries_head("", ()))
    calls = []
    real = tquant.conv_int8
    try:
        tquant.conv_int8 = lambda *a, **k: calls.append(1) or real(*a, **k)
        with torch.no_grad():
            out = tmod(_nchw(x))
    finally:
        tquant.conv_int8 = real
    assert len(calls) == 1                  # conv1 only
    assert tmod.quant_stats.names == ("conv1_in",)
    if module == "segdense":
        out = out.permute(0, 2, 3, 1)
    # measured max abs err: attention 1.2e-7 (weighted means up to 0.37),
    # segdense 2.4e-7 (logits up to 1.9)
    assert max_err(out, ref) < 5e-6


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("static", [False, True])
def test_stem_int8_matches_jax(stem, static):
    """``quant_stem``: the stem conv int8 with bn1 folded in, the block
    convs floating point; both stems, dynamic and static."""
    rng = np.random.RandomState(11)
    layers = (1, 1, 1, 1)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jmod = jresnet.ResNetPyramid(layers=layers, stem=stem, quant_stem=True,
                                 quant_static=static)
    variables = rand_variables(rng, jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))
    tmod = tresnet.ResNetPyramid(layers, stem=stem, quant_stem=True,
                                 quant_static=static).eval()
    load_into(tmod, variables, ck.resnet_mapping("", (), layers))
    if static:
        _, ups = jmod.apply(variables, jnp.asarray(x), train=False,
                            mutable=["quant_stats"])
        variables = jquant.merge_calibration(variables, ups)
        _calibrate(tmod, _nchw(x))
        _assert_stats_equal(tmod, numpy_tree(ups["quant_stats"]))
    ref = jmod.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        feats = tmod(_nchw(x))
    # measured max abs err over c1..c4: 7.8e-7 at most over the four cases
    # (maps up to 2.6)
    for out, r in zip(feats, ref):
        assert max_err(out.permute(0, 2, 3, 1), r) < 1e-5


# ------------------------------------------------------------ the K3 guard


def _k3_counts():
    f = q8.fused_bottleneck_int8_infer
    g = fb.fused_bottleneck_infer
    return (f.launches, f.plain_runs, g.launches + g.streamed_launches,
            g.plain_runs)


@pytest.mark.parametrize("down", [False, True])
def test_k3_route_matches_unfused_and_jax(down, monkeypatch):
    """A block the K3 guard takes (128 channels at 64x64, stride 1): the
    fused route engages only with static scales, ``quant_fused`` and outside
    calibration; it agrees with the port's unfused int8 block on the same
    calibrated scales and with the JAX block with ``_QUANT_FUSED`` set."""
    rng = np.random.RandomState(13)
    c, mid = 128, 32
    x = rng.randn(1, 64, 64, c).astype(np.float32)
    jblock = jresnet.Bottleneck(mid, stride=1, downsample=down,
                                expansion=c // mid, quant_eval=True,
                                quant_static=True)
    variables = rand_variables(rng, jblock.init(jax.random.PRNGKey(0),
                                                jnp.asarray(x)))
    monkeypatch.setattr(jresnet, "_QUANT_FUSED", 1)
    _, ups = jblock.apply(variables, jnp.asarray(x), train=False,
                          mutable=["quant_stats"])
    ref = jblock.apply(jquant.merge_calibration(variables, ups),
                       jnp.asarray(x), train=False)

    entries = ck._entries_bottleneck("", (), has_down=down)
    blocks = {}
    for name, kw in (("unfused", {}), ("fused", {"quant_fused": True}),
                     ("dynamic", {"quant_fused": True, "static": False})):
        static = kw.pop("static", True)
        blk = tresnet.Bottleneck(c, mid, 1, down, quant_eval=True,
                                 quant_static=static, **kw).eval()
        load_into(blk, variables, entries)
        blocks[name] = blk
    xt = _nchw(x).contiguous(memory_format=torch.channels_last)
    outs = {}
    with torch.no_grad():
        for name in ("unfused", "fused"):
            before = _k3_counts()
            _calibrate(blocks[name], xt)
            assert _k3_counts() == before, "calibration must not reach K3"
            _assert_stats_equal(blocks[name], numpy_tree(ups["quant_stats"]))
            outs[name] = blocks[name](xt).permute(0, 2, 3, 1)
            # K3's route, on the CPU its plain version, once; never K1/K2
            assert _k3_counts() == (before[0], before[1] + (name == "fused"),
                                    before[2], before[3])
        before = _k3_counts()
        blocks["dynamic"](xt)
        assert _k3_counts() == before, "dynamic scales must not reach K3"
    # K3 multiplies by 1/s where the unfused route divides by s: measured max
    # abs err 0 between the port's two routes and 4.8e-7 against the JAX
    # block, in both residual forms (outputs up to 5); the JAX test's bound
    # (2e-5). One moved int8 step would show as about 1e-2.
    assert max_err(outs["fused"], outs["unfused"]) < 2e-5
    assert max_err(outs["fused"], ref) < 2e-5


def test_fused_bf16_guard_takes_precedence_over_int8():
    """With both flags, a block the bf16 guard accepts runs K1's route, not
    the int8 path; a block it rejects (small spatial) runs int8."""
    blk = tresnet.Bottleneck(256, 64, fused_eval=True, quant_eval=True).eval()
    calls = []
    real = tquant.conv_int8
    try:
        tquant.conv_int8 = lambda *a, **k: calls.append(1) or real(*a, **k)
        with torch.no_grad():
            before = _k3_counts()
            blk(torch.zeros(1, 256, 64, 64))
            assert _k3_counts() == (before[0], before[1], before[2],
                                    before[3] + 1)
            assert calls == []
            blk(torch.zeros(1, 256, 16, 16))
            assert len(calls) == 3 and _k3_counts()[3] == before[3] + 1
    finally:
        tquant.conv_int8 = real


def test_k3_guard_keeps_other_blocks_unfused():
    """Stride 2, < 128 input channels, or the layer2 shape without
    ``quant_fused_l2_bands`` stay on the unfused int8 route; with it the
    layer2 shape is taken as bands=N."""
    cases = [
        (dict(inplanes=128, planes=32, stride=2, downsample=True),
         (1, 128, 64, 64), 0),
        (dict(inplanes=64, planes=32, stride=1, downsample=True),
         (1, 64, 64, 64), 0),
        (dict(inplanes=128, planes=32), (1, 128, 32, 32), 0),
        (dict(inplanes=128, planes=32, quant_fused_l2_bands=4),
         (1, 128, 32, 32), 1),
        (dict(inplanes=128, planes=32, quant_fused_l2_bands=4),
         (1, 128, 16, 16), 0),
    ]
    for kw, shape, fused in cases:
        blk = tresnet.Bottleneck(quant_eval=True, quant_static=True,
                                 quant_fused=True, **kw).eval()
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            _calibrate(blk, x)
            before = _k3_counts()
            blk(x)
        assert _k3_counts()[1] - before[1] == fused, (kw, shape)


def test_k3_operands_are_kept_until_a_source_changes():
    """``Bottleneck.k3_operands`` on CPU tensors: made once and kept; made
    anew after an in-place change of a BN statistic, a conv weight or a
    recalibrated scale, and of the projection's weight; always equal to a
    fresh ``kernel_operands``; refused while calibrating."""
    torch.manual_seed(0)
    blk = tresnet.Bottleneck(128, 32, 1, True, quant_eval=True,
                             quant_static=True, quant_fused=True).eval()
    x = torch.randn(1, 128, 8, 8)
    with torch.no_grad():
        _calibrate(blk, x)
    calls = []
    real = tresnet.kernel_operands
    try:
        tresnet.kernel_operands = (
            lambda *a, **k: calls.append(1) or real(*a, **k))

        def fresh():
            w = blk.folded_weights()
            scales = [tquant.scale_from_amax(getattr(blk.quant_stats, n))
                      for n in ("conv1_in", "conv2_in", "conv3_in")]
            return q8.kernel_operands(*w[:6], *scales, *w[6:])

        def same(a, b):
            return all(torch.equal(s, t) if isinstance(s, torch.Tensor)
                       else s == t for s, t in zip(a, b))

        first = blk.k3_operands()
        assert blk.k3_operands() is first and len(calls) == 1
        assert same(first, fresh())
        changes = [
            lambda: blk.bn2.running_var.mul_(1.5),
            lambda: blk.conv1.weight.mul_(-1.0),
            lambda: _calibrate(blk, x * 3),          # a wider scale
            lambda: blk.downsample[0].weight.add_(0.25),
        ]
        with torch.no_grad():
            for n, change in enumerate(changes, start=2):
                before = blk.k3_operands()
                change()
                now = blk.k3_operands()
                assert len(calls) == n and not same(now, before)
                assert same(now, fresh())
                assert blk.k3_operands() is now and len(calls) == n
        with torch.no_grad(), tquant.calibrating(blk):
            with pytest.raises(RuntimeError, match="calibrating"):
                blk.k3_operands()
    finally:
        tresnet.kernel_operands = real
