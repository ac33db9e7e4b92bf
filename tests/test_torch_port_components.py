"""The port's component microbenchmarks (``dir_tpu_torch/tools/
bench_components.py``) against the JAX tool (``tools/bench_components.py``)
on the CPU.

* the JAX tool is run with its ``timeit`` recording ``(name, fn, args)``
  instead of timing, at batch 2: the port's nine entries carry its names
  in its order, and the port's inputs equal its draws bit for bit (the
  image in the port's NCHW layout for the backbones);
* each component at batch 2 against its ``dir_tpu`` counterpart: both
  stems' c4 and the full model's final left mesh on seeded non-zero
  weights carried by the weight bridge, at fp32 and the tiny backbone; the
  full model on zero weights (the tool's) too; ``mano_pair`` and the plain
  splats against the JAX tool's own recorded functions on its draws;
* the tool's ``main`` on the CPU at batch 2: nine lines in the JAX tool's
  format, in order; the two ``full_bf16_pallas`` entries run one program
  (equal outputs, no splat);
* with no card and no CPU request the tool exits non-zero with one error
  line.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models import resnet as jresnet
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.train import checkpoint as ck

from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.tools import bench_components as tool
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (load_into, max_err,  # noqa: E402
                                numpy_tree, rand_variables, torch_threads)
from torch_port_train_helpers import jax_manos, jax_variables  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (1, 1, 1, 1)
B = 2
CPU = torch.device("cpu")
# Measured max abs error of the port against dir_tpu at batch 2 (seed 0);
# each bound is about ten times the measurement.
TOL_C4 = 1e-5           # c4, fp32: measured 1.1e-6 (conv7), 1.3e-6 (s2d)
TOL_MESH = 2e-6         # final left mesh (m), fp32: measured 1.3e-7
TOL_MESH_ZERO = 1e-7    # the same on zero weights: measured 7.5e-9
TOL_MANO = 5e-7         # mano_pair vertices (m): measured 5.2e-8
TOL_SPLAT_FP32 = 1e-6   # plain splat, fp32 features: measured 0.0
# Plain splat, the tool's bf16 features: the JAX version rounds each
# product to bf16 before the sum, the port sums in fp32 and rounds once
# (as tests/test_torch_port_splat.py bounds it): measured 0.015625, one
# bf16 ulp at |out| < 4, at both sizes; two ulps of the max |value| allowed.
SPLAT_BF16_ULPS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def jax_tool():
    """``{name: (fn, args)}`` in the JAX tool's order, recorded by its
    ``main`` at batch 2 (its backbones and models on its zero variables,
    never applied)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tools_bench_components",
        os.path.join(REPO, "tools", "bench_components.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.BATCH = B
    seen = {}
    mod.timeit = lambda name, fn, *args: seen.setdefault(name, (fn, args))
    mod.main()
    return seen


def test_entries_match_the_jax_tool(jax_tool):
    """Names and order, and every input bit for bit (the features in bf16,
    the image NCHW for the backbones); the full models are built at the
    tiny depth only to reach their entries."""
    assert tool.NAMES == tuple(jax_tool)
    got = list(tool.entries(CPU, tool.draws(B), backbone_layers=TINY))
    assert [name for name, _, _ in got] == list(jax_tool)
    for name, _, args in got:
        want = jax_tool[name][1]
        assert len(args) == len(want), name
        for a, w in zip(args, want):
            assert a.dtype == getattr(torch, str(w.dtype)), name
            if name.startswith("backbone"):
                a = a.permute(0, 2, 3, 1)
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(w).astype(np.float32),
                err_msg=name)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_backbone_c4_matches_jax(stem):
    img = tool.draws(B)["img"]
    jmod = jresnet.ResNetPyramid(layers=TINY, stem=stem)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(img[:1]))
    variables = rand_variables(np.random.RandomState(0), shapes)
    want = jmod.apply(variables, jnp.asarray(img), train=False)[-1]
    model = tool.backbone(stem, CPU, torch.float32, TINY)
    load_into(model, variables, ck.resnet_mapping("", (), TINY))
    with torch.inference_mode():
        got = tool.c4(model)(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (B, 2048, 8, 8)
    assert max_err(got.permute(0, 2, 3, 1), want) < TOL_C4


def test_mano_pair_matches_the_jax_tool(jax_tool):
    fn, (pose, betas) = jax_tool["mano_pair"]
    want = fn(pose, betas)
    left, right = tool.manos(CPU)
    with torch.inference_mode():
        got = tool.mano_pair(left, right)(
            torch.from_numpy(np.array(pose)),
            torch.from_numpy(np.array(betas)))
    assert tuple(got.shape) == (B, 778, 3)
    assert max_err(got, want) <= TOL_MANO


@pytest.mark.parametrize("size", [32, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_splat_matches_the_jax_tool(jax_tool, size, dtype):
    """The ``_jnp`` entry against the JAX tool's (``dir_tpu.ops.bone_splat.
    bone_splat``) on its draws; the ``_pallas`` entry runs the same plain
    version on the CPU (no launch), bit-equal."""
    fn, (uv, feat) = jax_tool[f"splat{size}_jnp"]
    if dtype == "float32":
        feat = jnp.asarray(tool.draws(B)["feat"])
    want = fn(uv, feat)
    distance = dict(tool.SPLATS)[size]
    tuv = torch.from_numpy(np.array(uv))
    tfeat = torch.from_numpy(tool.draws(B)["feat"]).to(getattr(torch, dtype))
    with torch.inference_mode():
        got = tool.splat(size, distance, False)(tuv, tfeat)
        runs, launches = bs.bone_splat.plain_runs, bs.bone_splat.launches
        via_op = tool.splat(size, distance, True)(tuv, tfeat)
    assert bs.bone_splat.plain_runs == runs + 1
    assert bs.bone_splat.launches == launches
    assert got.dtype == tfeat.dtype and tuple(got.shape) == tuple(want.shape)
    want = np.asarray(want.astype(jnp.float32))
    tol = (TOL_SPLAT_FP32 if dtype == "float32" else SPLAT_BF16_ULPS
           * 2.0 ** -7 * 2.0 ** np.floor(np.log2(np.abs(want).max())))
    assert max_err(got.float(), want) <= tol
    assert torch.equal(via_op, got)


@pytest.fixture(scope="module")
def jax_full():
    """The JAX DIR's final left mesh at the tiny depth, fp32, on seeded
    variables and on zeros; the seeded variables."""
    img = jnp.asarray(tool.draws(B)["img"])
    model = JDIR(JModelConfig(backbone_layers=TINY, dtype="float32"))
    variables = jax_variables(model, img[:1])
    ml, mr = jax_manos()
    fn = jax.jit(lambda v, x: model.apply(v, x, ml, mr, train=False)[
        "stages"][-1]["pd_mesh_xyz_left"])
    zeros = jax.tree.map(jnp.zeros_like, variables)
    return variables, fn(variables, img), fn(zeros, img)


@pytest.mark.parametrize("weights", ["seeded", "zero"])
def test_full_model_matches_jax(jax_full, weights):
    variables, want_seeded, want_zero = jax_full
    model = tool.full_model(False, CPU, "float32", backbone_layers=TINY)
    if weights == "seeded":
        model.load_state_dict(jax_to_state_dict(
            numpy_tree(variables["params"]),
            numpy_tree(variables["batch_stats"]), TINY), strict=True)
    img = torch.from_numpy(tool.draws(B)["img"])
    with torch.inference_mode():
        got = tool.final_mesh_left(model, *tool.manos(CPU))(img)
    want = want_seeded if weights == "seeded" else want_zero
    assert tuple(got.shape) == (B, 778, 3)
    assert torch.isfinite(got).all()
    assert max_err(got, want) <= (TOL_MESH if weights == "seeded"
                                  else TOL_MESH_ZERO)


def test_main_prints_nine_lines_on_the_cpu(monkeypatch, capsys):
    """Nine lines in the JAX tool's format (``tools/bench_components.py:
    30-31``), in order, finite; the two full entries give equal outputs and
    neither runs the splat."""
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    real = tool.timeit
    seen = {}

    def spy(name, fn, *args, **kw):
        runs = bs.bone_splat.plain_runs
        rec = real(name, fn, *args, **kw)
        seen[name] = (rec["out"].clone(), bs.bone_splat.plain_runs - runs)
        return rec

    monkeypatch.setattr(tool, "timeit", spy)
    records = tool.main(batch=B, iters=1, backbone_layers=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(records) == 9
    for line, rec, name in zip(lines, records, tool.NAMES):
        m = re.fullmatch(r"(\S+): ([\d.]+) ms/iter \((\d+) img/s\)", line)
        assert m and m.group(1) == name == rec["name"], line
        assert np.isfinite(rec["ms"]) and rec["ms"] > 0
        assert "out" not in rec
    # the untimed call and one timed call of each _pallas entry
    assert [seen[n][1] for n in tool.NAMES] == [0, 0, 0, 0, 2, 0, 2, 0, 0]
    off, on = (seen[f"full_bf16_pallas={p}"][0] for p in (False, True))
    assert off.dtype == torch.float32 and tuple(off.shape) == (B, 778, 3)
    assert torch.equal(off, on)


def test_without_a_card_one_error_line():
    env = {k: v for k, v in os.environ.items() if k != "BENCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-m", "dir_tpu_torch.tools.bench_components"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    err = proc.stderr.strip().splitlines()
    assert len(err) == 1 and "CUDA" in err[0], proc.stderr[-2000:]
