"""The constructor surface that dir_tpu has and DIR never reaches, against
dir_tpu at fp32 with the weights carried across by ``weights.py``'s tables:
``BasicBlock`` and the ResNet-18/34 (and -50) constructors, ``ConvBNRelu``,
``Hourglass``, ``SimplePGCN``, ``SimplePoolGCN`` with the hierarchy
tables, the perspective projections and ``default_config``.

Each module runs in eval mode (running statistics) and in train mode (the
batch's statistics, and the running statistics it leaves).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu import config as jconfig
from dir_tpu.models import gcn as jgcn
from dir_tpu.models import layers as jlayers
from dir_tpu.models import resnet as jresnet
from dir_tpu.ops import projection as jprojection

from dir_tpu_torch import config as tconfig
from dir_tpu_torch import weights
from dir_tpu_torch.models import gcn as tgcn
from dir_tpu_torch.models import layers as tlayers
from dir_tpu_torch.models import resnet as tresnet
from dir_tpu_torch.ops import projection as tprojection

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                rand_variables, torch_threads)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


# Measured max abs error of each module against dir_tpu at fp32 on these
# inputs, of the compared tensor's max |value|, over the outputs and (train
# mode) the running statistics, eval / train: resnet18 5.8e-7 / 7.2e-6 (at
# layer4 train-mode BN normalizes 8 values a channel, as
# test_torch_port_train_forward.py notes), resnet34 6.2e-7, resnet50
# 9.9e-7, ConvBNRelu 1.3e-7 / 2.4e-7, Hourglass 1.6e-7 / 1.3e-6,
# SimplePGCN 1.2e-7 / 4.4e-7, SimplePoolGCN 1.2e-7 / 2.2e-7. The bound is
# about seven times the worst.
RTOL = 5e-5


def _to_torch(x: np.ndarray, nchw: bool) -> torch.Tensor:
    t = torch.from_numpy(x)
    return t.permute(0, 3, 1, 2) if nchw else t


def _check(jmod, tmod, entries, x, train, nchw=True, out_nchw=None):
    """``jmod`` initialized to seeded random variables, carried into
    ``tmod`` by ``entries``; both applied to ``x`` (NHWC numpy) in eval or
    train mode; the outputs (a list for the pyramids) and, in train mode,
    the running statistics compared."""
    out_nchw = nchw if out_nchw is None else out_nchw
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = rand_variables(np.random.RandomState(7), shapes)
    params = numpy_tree(variables["params"])
    stats = numpy_tree(variables.get("batch_stats", {}))
    tmod.load_state_dict(weights.entries_to_state_dict(entries, params,
                                                       stats), strict=True)
    tmod.train(train)
    got = tmod(_to_torch(x, nchw))
    if train:
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        new_stats = numpy_tree(updates["batch_stats"])
        sd = tmod.state_dict()
        for e in entries:
            if e.collection == "batch_stats" and e.torch_key in sd:
                w = weights.entries_to_state_dict([e], {}, new_stats)
                w = w[e.torch_key]
                assert max_err(sd[e.torch_key], w) <= RTOL * float(
                    w.abs().max()), e.torch_key
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    gots = got if isinstance(got, list) else [got]
    wants = want if isinstance(want, list) else [want]
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        g = g.detach()
        if out_nchw:
            g = g.permute(0, 2, 3, 1)
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        assert max_err(g, w) <= RTOL * float(np.abs(w).max())


@pytest.mark.parametrize("name,train", [("resnet18", False),
                                        ("resnet18", True),
                                        ("resnet34", False),
                                        ("resnet50", False)])
def test_resnet_constructors_match_jax(name, train):
    jmod = getattr(jresnet, name)()
    tmod = getattr(tresnet, name)()
    block = "basic" if name != "resnet50" else "bottleneck"
    assert jmod.block == block and jmod.layers == tuple(
        len(getattr(tmod, f"layer{i}")) for i in range(1, 5))
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    _check(jmod, tmod, weights.resnet_mapping(jmod.layers, block), x, train)


def test_basic_block_has_no_fused_path():
    """The fused and int8 flags stay on Bottleneck: a basic pyramid takes
    none (BasicBlock has no such attribute), a bottleneck one keeps them."""
    basic = tresnet.ResNetPyramid((1, 1, 1, 1), block="basic")
    assert isinstance(basic.layer1[0], tresnet.BasicBlock)
    assert not hasattr(basic.layer1[0], "fused_eval")
    assert basic.layer1[0].downsample is None       # 64 in, 64 out
    assert basic.layer2[0].downsample is not None
    fused = tresnet.ResNetPyramid((1, 1, 1, 1), fused_eval=True)
    assert fused.layer1[0].fused_eval
    with pytest.raises(ValueError):
        tresnet.ResNetPyramid((1, 1, 1, 1), block="wide")


@pytest.mark.parametrize("kernel,stride,use_bn,use_relu,use_bias", [
    (3, 1, True, True, True),
    (3, 2, True, True, True),       # flax's SAME pads (0, 1) here
    (4, 2, True, False, False),
    (1, 1, False, True, True),
    (5, 2, False, False, True),
])
@pytest.mark.parametrize("train", [False, True])
def test_conv_bn_relu_matches_jax(kernel, stride, use_bn, use_relu,
                                  use_bias, train):
    x = np.random.RandomState(2).randn(2, 10, 9, 6).astype(np.float32)
    jmod = jlayers.ConvBNRelu(8, kernel, stride, use_bn, use_relu, use_bias)
    tmod = tlayers.ConvBNRelu(6, 8, kernel, stride, use_bn, use_relu,
                              use_bias)
    _check(jmod, tmod, weights.conv_bn_relu_mapping(use_bn, use_bias), x,
           train and use_bn)


@pytest.mark.parametrize("train", [False, True])
def test_hourglass_matches_jax(train):
    x = np.random.RandomState(3).randn(2, 16, 16, 16).astype(np.float32)
    jmod = jlayers.Hourglass(depth=2, features=16, increase=8)
    tmod = tlayers.Hourglass(2, 16, increase=8)
    _check(jmod, tmod, weights.hourglass_mapping(2), x, train)


@pytest.mark.parametrize("train", [False, True])
def test_simple_pgcn_matches_jax(train):
    x = np.random.RandomState(4).randn(3, 21, 8).astype(np.float32)
    jmod = jgcn.SimplePGCN(8, 16, 4, num_layers=2)
    tmod = tgcn.SimplePGCN(8, 16, 4, num_layers=2)
    _check(jmod, tmod, weights.simple_pgcn_mapping(2), x, train, nchw=False)


@pytest.mark.parametrize("train", [False, True])
def test_simple_pool_gcn_matches_jax(train):
    x = np.random.RandomState(5).randn(3, 21, 8).astype(np.float32)
    jmod = jgcn.SimplePoolGCN(hid_dims=(16, 12, 10), out_dim=4)
    tmod = tgcn.SimplePoolGCN(8, (16, 12, 10), 4)
    _check(jmod, tmod, weights.simple_pool_gcn_mapping(3), x, train,
           nchw=False)


def test_hierarchy_tables_match_jax():
    assert tgcn.get_hierarchy_sketch() == jgcn.get_hierarchy_sketch()
    assert tgcn.get_hierarchy_mapping() == jgcn.get_hierarchy_mapping()
    for n, edges in zip((21, 11, 6, 1), tgcn.get_hierarchy_sketch()):
        np.testing.assert_array_equal(tgcn.adjacency_from_edges(n, edges),
                                      jgcn.adjacency_from_edges(n, edges))
    for node_map in tgcn.get_hierarchy_mapping():
        np.testing.assert_array_equal(
            tgcn.pool_matrix(node_map),
            jgcn.SimplePoolGCN.pool_matrix(node_map))
    np.testing.assert_array_equal(tgcn.hand_adjacency(),
                                  jgcn.hand_adjacency())


def test_projection_matches_jax():
    """``uvd_to_xyz``, ``xyz_to_uvd`` and ``xyz_to_uv`` on a batch of
    intrinsics, and the round trip (tests/test_projection.py's)."""
    rng = np.random.RandomState(6)
    cam = np.tile(np.array([[600.0, 0, 128.0], [0, 610.0, 130.0],
                            [0, 0, 1.0]], np.float32), (4, 1, 1))
    cam[:, 0, 0] += rng.uniform(-50, 50, 4).astype(np.float32)
    xyz = rng.randn(4, 21, 3).astype(np.float32)
    xyz[..., 2] += 5.0
    uvd = np.asarray(jprojection.xyz_to_uvd(jnp.asarray(xyz),
                                            jnp.asarray(cam)))
    tc, tx = torch.from_numpy(cam), torch.from_numpy(xyz)
    for fn, arg in (("xyz_to_uvd", xyz), ("xyz_to_uv", xyz),
                    ("uvd_to_xyz", uvd)):
        want = np.asarray(getattr(jprojection, fn)(jnp.asarray(arg),
                                                   jnp.asarray(cam)))
        got = getattr(tprojection, fn)(torch.from_numpy(arg), tc)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=fn)
    for a, c in zip(tprojection._cam_params(tc),
                    jprojection._cam_params(jnp.asarray(cam))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    back = tprojection.uvd_to_xyz(tprojection.xyz_to_uvd(tx, tc), tc)
    np.testing.assert_allclose(back.numpy(), xyz, atol=1e-4)


# The port's model config holds three kernel fields that dir_tpu reads from
# environment variables (QUANT_FUSED, QUANT_FUSED_L2, the K2 bands); off by
# default, as those variables are.
PORT_ONLY = {"model": {"fused_l2_bands": 0, "quant_fused": False,
                       "quant_fused_l2_bands": 0}}


def test_default_config_matches_jax():
    want = jconfig._to_dict(jconfig.default_config())
    got = tconfig._to_dict(tconfig.default_config())
    assert tconfig.default_config() == tconfig.Config()
    assert set(got) == set(want)
    for section, fields in want.items():
        if not isinstance(fields, dict):
            assert got[section] == fields, section
            continue
        extra = {k: v for k, v in got[section].items() if k not in fields}
        assert extra == PORT_ONLY.get(section, {}), section
        for k, v in fields.items():
            assert got[section][k] == v, (section, k)
    assert [f.name for f in dataclasses.fields(tconfig.Config)] == [
        f.name for f in dataclasses.fields(jconfig.Config)]
