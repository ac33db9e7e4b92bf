"""Shared helpers of the port's parity tests (tests/test_torch_port_*.py):
seeded random flax variables and their transfer into a torch module
through the JAX package's own torch-layout export."""

from __future__ import annotations

import contextlib

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dir_tpu.train import checkpoint as ck


def rand_variables(rng: np.random.RandomState, variables):
    """Random params and non-trivial BN stats with a fan-in scale, as
    tests/test_pallas_bottleneck.py:_rand_variables makes them: 1-D
    leaves U(0.5, 1), others U(-1, 1) / sqrt(fan_in)."""
    leaves, treedef = jax.tree.flatten(variables)
    new = []
    for leaf in leaves:
        if leaf.ndim == 1:
            arr = rng.uniform(0.5, 1.0, size=leaf.shape)
        else:
            fan_in = int(np.prod(leaf.shape[:-1]))
            arr = rng.uniform(-1.0, 1.0, size=leaf.shape) / np.sqrt(fan_in)
        new.append(jnp.asarray(arr.astype(leaf.dtype)))
    return jax.tree.unflatten(treedef, new)


def numpy_tree(tree) -> dict:
    return jax.tree.map(np.asarray, flax.core.unfreeze(tree))


def load_into(module: torch.nn.Module, variables, entries) -> None:
    """Export flax ``variables`` with the mapping ``entries`` and load them
    into the torch ``module`` with ``strict=True``."""
    params = numpy_tree(variables["params"])
    stats = numpy_tree(variables.get("batch_stats", {}))
    sd = ck.export_torch_state(params, stats, entries)
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
        strict=True)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@contextlib.contextmanager
def x64(on: bool = True):
    """JAX's 64-bit mode set to ``on`` for the block, restored afterwards."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@contextlib.contextmanager
def torch_threads(n: int):
    """PyTorch's intra-op threads set to ``n`` for the block, restored
    afterwards. The test workers share the host's cores: a worker that
    trains on every core spins its threads against the other workers'."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)
