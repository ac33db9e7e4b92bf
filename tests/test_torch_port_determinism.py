"""The port's deterministic train path against dir_tpu's formulations.

The decoder samples its joints with ``ops/sampling.py:grid_sample_nhwc_mm``
(one selection-matrix product, as ``dir_tpu``'s decoder does in train and
eval) and upsamples with ``models/layers.py:upsample2x`` (``dir_tpu``'s
transposed-conv algebra as slices and weighted adds): neither backward
accumulates with atomics. Both are held against ``dir_tpu`` forward at fp32
and bf16 and in their gradients at fp64. A walk of one train step's
autograd graph shows that neither ``F.grid_sample``'s nor
``F.interpolate``'s backward is left in it, which catches a regression
without a card. The train step runs under ``device.deterministic()``: two
runs of the same steps are bit-equal, and the context restores what it
found.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.models.layers import _upsample2x_tconv
from dir_tpu.ops.sampling import grid_sample_nhwc_mm as jgrid_sample_mm

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.device import deterministic
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.models.layers import upsample2x
from dir_tpu_torch.models.losses import dir_losses, total_loss
from dir_tpu_torch.ops.sampling import grid_sample_nhwc, grid_sample_nhwc_mm

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import max_err, torch_threads, x64  # noqa: E402
from torch_port_train_helpers import (LAYERS, make_batch,  # noqa: E402
                                      port_manos, port_train)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


DECODERS = {"factored": {},
            "k5_route": dict(fused_splat_conv=False, use_pallas_splat=True)}
# Backward nodes whose CUDA kernels accumulate with atomics (and raise under
# deterministic algorithms): none may be left in a train step's graph.
ATOMIC_BACKWARDS = ("GridSampler2DBackward0", "UpsampleBilinear2DBackward0")

# Measured max abs errors against dir_tpu on these inputs (values up to
# 2.6): the sampler 1.2e-7 at fp32 and with bf16 features (bf16 values are
# exact in fp32, so both sum the same four products; F.grid_sample gives
# the port's value exactly), the upsample 2.4e-7 at fp32 (the separable sum
# rounds in another order than the 4x4 conv) and 0 at bf16 (both round the
# fp32 sum once). The fp64 gradients differ by 4.4e-16 (sampler) and
# 8.9e-16 (upsample). Bounds about four times each.
SAMPLE_TOL = 5e-7
UPSAMPLE_TOL = {"float32": 1e-6, "bfloat16": 0.0}
GRAD_TOL = 4e-15


def _sample_inputs(dtype=np.float32):
    """(2, 8, 8, 16) maps and 42 points a map, some outside it and some on
    its edges and cell corners."""
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 8, 8, 16).astype(dtype)
    coords = rng.uniform(-1.3, 1.3, (2, 42, 2)).astype(dtype)
    coords[:, :4] = np.array([[-1, -1], [1, 1], [-1.0625, 0.0],
                              [0.125, -0.125]], dtype)
    return feats, coords


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_mm_matches_jax(dtype):
    feats, coords = _sample_inputs()
    jf = jnp.asarray(feats).astype(dtype)
    want = jgrid_sample_mm(jf, jnp.asarray(coords))
    got = grid_sample_nhwc_mm(
        torch.from_numpy(feats).to(getattr(torch, dtype)),
        torch.from_numpy(coords))
    # bf16 features sample to fp32 in both packages
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (2, 42, 16)
    assert max_err(got, want) <= SAMPLE_TOL
    if dtype == "float32":
        # the points outside the map take zeros from their outside taps,
        # as F.grid_sample does
        ref = grid_sample_nhwc(torch.from_numpy(feats),
                               torch.from_numpy(coords))
        assert max_err(got, ref) <= SAMPLE_TOL


def test_grid_sample_mm_gradient_matches_jax_fp64():
    feats, coords = _sample_inputs(np.float64)
    g = np.random.RandomState(4).randn(2, 42, 16)
    with x64():
        want = jax.grad(lambda f: jnp.sum(
            jgrid_sample_mm(f, jnp.asarray(coords)) * g))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    (grid_sample_nhwc_mm(f, torch.from_numpy(coords))
     * torch.from_numpy(g)).sum().backward()
    assert max_err(f.grad, want) <= GRAD_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample2x_matches_jax_tconv(dtype):
    x = np.random.RandomState(5).randn(2, 5, 7, 6).astype(np.float32)
    want = _upsample2x_tconv(jnp.asarray(x).astype(dtype))
    got = upsample2x(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 10, 14, 6)
    assert max_err(got.float(), jnp.asarray(want, jnp.float32)) <= \
        UPSAMPLE_TOL[dtype]


def test_upsample2x_gradient_matches_jax_fp64():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 7, 6)
    g = rng.randn(2, 10, 14, 6)
    with x64():
        want = jax.grad(lambda v: jnp.sum(_upsample2x_tconv(v) * g))(
            jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (upsample2x(t) * torch.from_numpy(g)).sum().backward()
    assert max_err(t.grad, want) <= GRAD_TOL


def _backward_nodes(root) -> set:
    """The names of every node of the autograd graph below ``root``."""
    seen, names, todo = set(), set(), [root]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("decoder", sorted(DECODERS))
def test_train_step_graph_has_no_atomic_backward(decoder):
    """One train-mode forward and loss of the tiny DIR: the graph the
    step's backward walks holds the selection-matrix product and no
    ``F.grid_sample`` or bilinear ``F.interpolate`` backward."""
    torch.manual_seed(0)
    model = DIR(ModelConfig(backbone_layers=LAYERS, **DECODERS[decoder]))
    ml, mr = port_manos()
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch(np.random.RandomState(1)).items()}
    model.train()
    out = model(batch["img"], ml, mr)
    loss = total_loss(dir_losses(out, batch, model.cfg, ml.faces, mr.faces,
                                 fused_stages=True))
    names = _backward_nodes(loss.grad_fn)
    assert not names & set(ATOMIC_BACKWARDS), names & set(ATOMIC_BACKWARDS)
    assert "BmmBackward0" in names


def test_deterministic_train_steps_repeat_bit_for_bit():
    """Two train steps of the tiny DIR (the K5 route's decoder), run twice
    from one state_dict through the port's step, which enters
    ``deterministic()``: every loss and every tensor of the state equal."""
    torch.manual_seed(0)
    first = DIR(ModelConfig(backbone_layers=LAYERS, **DECODERS["k5_route"]))
    init = {k: v.clone() for k, v in first.state_dict().items()}
    rng = np.random.RandomState(2)
    batches = [make_batch(rng) for _ in range(2)]
    runs = []
    for model in (first, DIR(first.cfg)):
        model.load_state_dict(init, strict=True)
        _, losses = port_train(model, batches)
        runs.append((losses, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    assert not torch.are_deterministic_algorithms_enabled()


def test_deterministic_sets_and_restores():
    # importing the package fixed cuBLAS's workspace, unless it was set
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] in (":4096:8", ":16:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.benchmark = True
        with deterministic():
            assert torch.are_deterministic_algorithms_enabled()
            assert not torch.is_deterministic_algorithms_warn_only_enabled()
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.is_deterministic_algorithms_warn_only_enabled()
        assert not torch.backends.cudnn.deterministic
        assert torch.backends.cudnn.benchmark
        with pytest.raises(RuntimeError):
            with deterministic():
                raise RuntimeError("inside")
        assert torch.backends.cudnn.benchmark
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved[2:]
