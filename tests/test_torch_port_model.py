"""The port's whole slice (the DIR eval forward) against dir_tpu, the weight
bridge, and the port's isolation from JAX.

One seeded JAX DIR with ``backbone_layers=(3, 1, 1, 1)`` at 256x256 and
``fused_bottleneck_eval=True``: the smallest config in which the fused
guard takes two blocks (layer1_1 and layer1_2), as in the flagship. Its
random params and BN stats reach the port through ``weights.py``; both
forwards run at fp32 on the CPU.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.train.checkpoint import export_torch_dir_state

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.serve import build_flagship, flagship_mano, make_infer
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                rand_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (3, 1, 1, 1)


@pytest.fixture(scope="module")
def slice_run():
    """JAX variables, the JAX outputs and the port's outputs for one seeded
    image; the port's K1 counts (kernel launches, plain-version runs) over
    its forward."""
    rng = np.random.RandomState(0)
    img = rng.randn(1, 256, 256, 3).astype(np.float32)
    mano_r = jsynthetic("right", seed=0)
    mano_l = jfix(jsynthetic("left", seed=0), mano_r)
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS,
                               fused_bottleneck_eval=True))
    # random params and BN stats with a fan-in scale; only the tree's
    # shapes are needed, so the init itself is never run
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(img), mano_l, mano_r)
    variables = rand_variables(rng, shapes)
    ref = jmodel.apply(variables, jnp.asarray(img), mano_l, mano_r,
                       train=False)

    params = numpy_tree(variables["params"])
    stats = numpy_tree(variables["batch_stats"])
    model = DIR(ModelConfig(backbone_layers=LAYERS,
                            fused_bottleneck_eval=True)).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, LAYERS),
                          strict=True)
    tl, tr = flagship_mano("/nonexistent")  # the synthetic pair
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.plain_runs)
    out = make_infer(model, tl, tr)(img)
    counts = (f.launches - before[0], f.plain_runs - before[1])
    return params, stats, ref, out, counts


def test_weight_bridge_matches_checkpoint_export(slice_run):
    """Key for key and bit for bit against the JAX package's export."""
    params, stats, *_ = slice_run
    want = export_torch_dir_state(params, stats, LAYERS)
    got = jax_to_state_dict(params, stats, LAYERS)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the bridge's keys are exactly the port's state_dict keys, apart from
    # BatchNorm's step counters, which the table (like the reference
    # converter) leaves out and load_state_dict fills in
    model = DIR(ModelConfig(backbone_layers=LAYERS))
    keys = [k for k in model.state_dict()
            if not k.endswith("num_batches_tracked")]
    assert sorted(keys) == sorted(got)
    model.load_state_dict(got, strict=True)


# Measured max abs error of the port against dir_tpu on this input, over
# all three stages (joint/mesh xyz in meters, uv in [-1, 1] units); each
# tolerance is about ten times the measurement.
TOLERANCES = {
    "xyz": 5e-6,      # measured 3.5e-7 (stage 2 left mesh), values ~0.15
    "uv": 1e-5,       # measured 6.6e-7, values ~1.5
    "other": 2e-5,    # offset, MANO parameters, projection: measured 1.6e-6
    "head": 2e-5,     # seg/dense logits: measured 1.3e-6, values ~2
}


def test_slice_matches_jax(slice_run):
    _, _, ref, out, counts = slice_run
    # on the CPU the wrapper runs K1's plain version in the kernel's place
    assert counts == (0, 2), "the fused bottleneck must run layer1_1 and 1_2"
    assert len(out["stages"]) == 3
    for stage, (r, o) in enumerate(zip(ref["stages"], out["stages"])):
        assert sorted(o) == sorted(r)
        for key, r_val in r.items():
            o_val = o[key]
            assert tuple(o_val.shape) == tuple(r_val.shape), key
            assert o_val.dtype == torch.float32, key
            if "xyz" in key:
                tol = TOLERANCES["xyz"]
            elif "uv" in key:
                tol = TOLERANCES["uv"]
            else:
                tol = TOLERANCES["other"]
            assert max_err(o_val, r_val) < tol, (stage, key)
    for key in ("seg", "dense"):
        assert tuple(out[key].shape) == (1, 32, 32, 3)
        assert max_err(out[key], ref[key]) < TOLERANCES["head"], key


def test_entry_points_refuse_a_cpu_only_box():
    """Without a card and without device="cpu", nothing runs."""
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_flagship()
    # loaded from its path, so that the repository root never enters
    # sys.path of a worker that other test files share
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    with pytest.raises((RuntimeError, SystemExit)) as info:
        chip_smoke.main()
    if info.type is SystemExit:
        assert info.value.code not in (0, None)


def _imports(path: str):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_dir_tpu():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "dir_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "dir_tpu"):
                bad.append((os.path.relpath(f, REPO), mod))
    assert not bad


def test_import_loads_no_jax_module():
    code = ("import sys, dir_tpu_torch, dir_tpu_torch.serve, "
            "dir_tpu_torch.weights\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'dir_tpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
