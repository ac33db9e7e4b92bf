"""The port's whole slice (the DIR eval forward) against dir_tpu, the weight
bridge, and the port's isolation from JAX.

One seeded JAX DIR with ``backbone_layers=(3, 1, 1, 1)`` at 256x256 and
``fused_bottleneck_eval=True``: the smallest config in which the fused
guard takes two blocks (layer1_1 and layer1_2), as in the flagship. Its
random params and BN stats reach the port through ``weights.py``; both
forwards run at fp32 on the CPU. The same variables run in configuration A
(the factored splat conv) and in configuration B (the materialized bone
splat through its kernel's route, Pallas in interpret mode on the JAX
side); a ``(1, 2, 1, 1)`` backbone adds B's layer2 guard. Configuration C (int8
static serving with the fused int8 bottleneck) runs on a ``(2, 2, 1, 1)``
backbone, where K3's route fires once at each of its two shapes, with both
packages serving on the same calibrated scales through the ``quant_stats``
bridge.
"""

import ast
import contextlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic
from dir_tpu.models import resnet as jresnet
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.ops import pallas_bone_splat as jsplat
from dir_tpu.ops import pallas_bottleneck as jbottleneck
from dir_tpu.ops import quant as jquant
from dir_tpu.train.checkpoint import export_torch_dir_state

from dir_tpu_torch import serve
from dir_tpu_torch import weights as tweights
from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops import quant as tquant
from dir_tpu_torch.serve import build_flagship, flagship_mano, make_infer
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                rand_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (3, 1, 1, 1)


# The fields that make configuration B, in both packages.
CONFIG_B = dict(fused_splat_conv=False, use_pallas_splat=True)


def _counts():
    """(kernel launches, plain-version runs) of the fused bottleneck and of
    the bone splat so far."""
    f = fb.fused_bottleneck_infer
    return (f.launches + f.streamed_launches, f.plain_runs,
            bs.bone_splat.launches, bs.bone_splat.plain_runs)


@contextlib.contextmanager
def _tpu_interpret_mode():
    """Pallas kernels in TPU interpret mode, each call awaited with its
    effects before the eager forward goes on. In that mode a kernel runs
    Python callbacks that dispatch JAX operations of their own; when the
    forward has meanwhile queued further operations behind the kernel on
    the CPU client, the callback's operation waits for the queue and the
    queue for the kernel: a deadlock, seen on a loaded host (the main thread
    in a later block's BatchNorm, the callback in
    ``update_clocks_for_device_barrier``)."""
    def awaited(fn):
        def call(*args, **kwargs):
            out = jax.block_until_ready(fn(*args, **kwargs))
            jax.effects_barrier()
            return out
        return call

    targets = [(jbottleneck, "fused_bottleneck_infer"),
               (jbottleneck, "fused_bottleneck_int8_infer"),
               (jsplat, "bone_splat_pallas")]
    saved = [getattr(mod, name) for mod, name in targets]
    for (mod, name), fn in zip(targets, saved):
        setattr(mod, name, awaited(fn))
    try:
        with pltpu.force_tpu_interpret_mode():
            yield
    finally:
        for (mod, name), fn in zip(targets, saved):
            setattr(mod, name, fn)


def _jax_forward(layers, img, variables=None, **cfg):
    """The JAX DIR's eval forward on seeded random variables (made here
    unless given), with Pallas kernels in interpret mode; returns the
    variables, the outputs and the decoder's ``proj_feat``."""
    mano_r = jsynthetic("right", seed=0)
    mano_l = jfix(jsynthetic("left", seed=0), mano_r)
    jmodel = JDIR(JModelConfig(backbone_layers=layers,
                               fused_bottleneck_eval=True, **cfg))
    if variables is None:
        # random params and BN stats with a fan-in scale; only the tree's
        # shapes are needed, so the init itself is never run
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.asarray(img), mano_l, mano_r)
        variables = rand_variables(np.random.RandomState(0), shapes)
    with _tpu_interpret_mode():
        ref, state = jmodel.apply(
            variables, jnp.asarray(img), mano_l, mano_r, train=False,
            capture_intermediates=lambda mdl, _: mdl.name == "decoder",
            mutable=["intermediates"])
    decoder_out = state["intermediates"]["decoder"]["__call__"][0]
    return variables, ref, decoder_out["proj_feat"]


def _port_forward(layers, img, variables, want_vis=False, **cfg):
    """The port's DIR on the same variables, carried across by the weight
    bridge; returns the outputs and the kernels' counts over the forward."""
    params = numpy_tree(variables["params"])
    stats = numpy_tree(variables["batch_stats"])
    model = DIR(ModelConfig(backbone_layers=layers,
                            fused_bottleneck_eval=True, **cfg)).eval()
    model.load_state_dict(jax_to_state_dict(params, stats, layers),
                          strict=True)
    tl, tr = flagship_mano("/nonexistent")  # the synthetic pair
    before = _counts()
    if want_vis:
        with torch.inference_mode():
            out = model(torch.from_numpy(img), tl, tr, want_vis=True)
    else:
        out = make_infer(model, tl, tr)(img)
    return out, tuple(a - b for a, b in zip(_counts(), before))


def _image():
    return np.random.RandomState(0).randn(1, 256, 256, 3).astype(np.float32)


@pytest.fixture(scope="module")
def slice_run():
    """JAX variables, the JAX outputs and the port's outputs for one seeded
    image in configuration A; the port's kernel counts over its forward."""
    img = _image()
    variables, ref, _ = _jax_forward(LAYERS, img)
    out, counts = _port_forward(LAYERS, img, variables)
    params = numpy_tree(variables["params"])
    stats = numpy_tree(variables["batch_stats"])
    return params, stats, ref, out, counts, variables


def test_weight_bridge_matches_checkpoint_export(slice_run):
    """Key for key and bit for bit against the JAX package's export."""
    params, stats = slice_run[:2]
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


def _assert_matches(ref: dict, out: dict) -> None:
    """All three stages, seg and dense of the port against the JAX outputs,
    within TOLERANCES."""
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


def test_slice_matches_jax(slice_run):
    _, _, ref, out, counts, _ = slice_run
    # on the CPU the wrapper runs K1's plain version in the kernel's place
    assert counts == (0, 2, 0, 0), \
        "the fused bottleneck must run layer1_1 and 1_2"
    assert "vis_img_feat" not in out
    _assert_matches(ref, out)


def test_config_b_matches_jax_and_config_a(slice_run):
    """Configuration B (materialized splat through K5's route) on A's
    variables: against the JAX DIR with fused_splat_conv=False and
    use_pallas_splat=True in interpret mode, and against the port's A."""
    _, _, _, out_a, _, variables = slice_run
    img = _image()
    _, ref, ref_vis = _jax_forward(LAYERS, img, variables, **CONFIG_B)
    out, counts = _port_forward(LAYERS, img, variables, want_vis=True,
                                **CONFIG_B)
    # K1's route twice, K5's route for 2 hands x 2 stages, all plain here
    assert counts == (0, 2, 0, 4)
    _assert_matches(ref, out)
    assert tuple(out["vis_img_feat"].shape) == (1, 32, 32, 20 * 64)
    # measured max abs err 9.5e-7 (map values of order 1)
    assert max_err(out["vis_img_feat"], ref_vis) < 5e-6
    # B against A in the port: the factorization is exact up to the fp32
    # summation order. Measured max abs err over all outputs: 8.9e-7 (a seg
    # logit); B against the JAX package: 1.4e-6 (a MANO parameter)
    _assert_matches({k: [{kk: vv.numpy() for kk, vv in st.items()}
                         for st in v] if k == "stages" else v.numpy()
                     for k, v in out_a.items()}, out)
    # without want_vis, or in configuration A, the map is never built
    plain, _ = _port_forward(LAYERS, img, variables, **CONFIG_B)
    assert "vis_img_feat" not in plain


def test_config_b_layer2_guard_matches_jax(monkeypatch):
    """Configuration B with fused_l2_bands=4 on a (1, 2, 1, 1) backbone:
    layer2_1 goes through the fused route with bands=4 (K2's), the splats
    through K5's; against the JAX DIR with _FUSED_L2_BANDS patched to 4."""
    layers = (1, 2, 1, 1)
    img = _image()
    monkeypatch.setattr(jresnet, "_FUSED_L2_BANDS", 4)
    variables, ref, _ = _jax_forward(layers, img, **CONFIG_B)
    out, counts = _port_forward(layers, img, variables, fused_l2_bands=4,
                                **CONFIG_B)
    assert counts == (0, 1, 0, 4)     # layer2_1; 2 hands x 2 stages
    _assert_matches(ref, out)
    # with the field at 0 layer2 stays unfused (and layer1 has one block)
    _, counts = _port_forward(layers, img, variables, **CONFIG_B)
    assert counts == (0, 0, 0, 4)


def _jax_manos():
    mano_r = jsynthetic("right", seed=0)
    return jfix(jsynthetic("left", seed=0), mano_r), mano_r


def _leaves(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# The int8 fields of configuration C that both packages have; the JAX
# package takes the two fused-kernel switches from module globals.
CONFIG_C_SHARED = dict(fused_bottleneck_eval=False, quant_backbone_eval=True,
                       quant_decoder_eval=True, quant_aux_eval=True,
                       quant_static=True)


def test_config_c_matches_jax(monkeypatch):
    """Configuration C at cut depth, fp32: calibration gives the JAX
    package's ``quant_stats`` leaf for leaf; with those scales carried across
    by the bridge, the int8 static forward agrees with the JAX DIR with
    ``_QUANT_FUSED`` and ``_QUANT_FUSED_L2`` set (Pallas in interpret mode);
    K3's route runs once at the layer1 and once at the layer2 shape."""
    layers = (2, 2, 1, 1)
    img = _image()
    mano_l, mano_r = _jax_manos()
    monkeypatch.setattr(jresnet, "_QUANT_FUSED", 1)
    monkeypatch.setattr(jresnet, "_QUANT_FUSED_L2", 4)
    jmodel = JDIR(JModelConfig(backbone_layers=layers, **CONFIG_C_SHARED))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(img), mano_l, mano_r)
    variables = rand_variables(np.random.RandomState(0), shapes)
    assert "quant_stats" not in variables     # int8 adds no parameter
    with _tpu_interpret_mode():
        _, ups = jmodel.apply(variables, jnp.asarray(img), mano_l, mano_r,
                              train=False, mutable=["quant_stats"])
        ref = jmodel.apply(jquant.merge_calibration(variables, ups),
                           jnp.asarray(img), mano_l, mano_r, train=False)
    jstats = numpy_tree(ups["quant_stats"])

    assert {k: v for k, v in serve.CONFIG_C.items()
            if k in CONFIG_C_SHARED} == CONFIG_C_SHARED
    model = DIR(ModelConfig(backbone_layers=layers, **serve.CONFIG_C)).eval()
    model.load_state_dict(
        jax_to_state_dict(numpy_tree(variables["params"]),
                          numpy_tree(variables["batch_stats"]), layers),
        strict=True)
    tl, tr = flagship_mano("/nonexistent")
    k3 = q8.fused_bottleneck_int8_infer
    infer = make_infer(model, tl, tr)
    with pytest.raises(RuntimeError, match="never calibrated"):
        infer(img)

    # the port's own calibration against the JAX package's, leaf for leaf;
    # it must not reach K3's route
    before = (k3.launches, k3.plain_runs)
    serve.calibrate_static_scales(model, img, tl, tr)
    assert (k3.launches, k3.plain_runs) == before
    got = _leaves(tweights.amax_to_quant_stats(model, layers))
    want = _leaves(jstats)
    assert sorted(got) == sorted(want)
    assert len(want) == len([n for n, _ in model.named_buffers()
                             if ".quant_stats." in n])
    # A calibration forward quantizes on live scales, so an upstream fp32
    # ulp can move an int8 value one step there too, and a later max with
    # it. Measured: 39 of the 55 maxes bit-equal, 9 within 1.4e-7 relative,
    # 7 (all downstream of fusion_layer3) within 1.6e-3 relative, which is
    # 0.2 int8 steps of the tensor's own range; the bound is one step.
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1 / 127,
                                   err_msg=str(path))

    # both packages on the same scales: the bridge there and back, bit-equal
    tweights.load_amax(model, tweights.quant_stats_to_amax(jstats, layers))
    back = _leaves(tweights.amax_to_quant_stats(model, layers))
    assert all(back[p] == want[p] and back[p].dtype == np.float32
               for p in want)

    counts = _counts()
    out = infer(img)
    assert (k3.launches, k3.plain_runs) == (before[0], before[1] + 2), \
        "K3's route must run layer1_1 and layer2_1"
    assert _counts() == counts                # never K1, K2 or K5
    _assert_matches_int8(ref, out)


# Configuration C against dir_tpu on the same static scales, this input:
# the two walk the same int8 grid, so most outputs agree to fp32 rounding,
# but an upstream difference of one fp32 ulp that lands on a rounding
# boundary moves an int8 value by one step (1/127 of that conv input's
# range), and 70 int8 convs give it room. Measured max abs errors: joints
# and meshes 6.5e-6 m, uv 3.6e-5, MANO parameters, offset and projection
# 3.1e-5, seg/dense logits 6.8e-3 (one step of the last int8 conv's input,
# 2.9 / 127 = 0.023, through the floating-point 1x1 head; logits up to 1.4).
INT8_TOLERANCES = {
    "xyz": 1e-4,      # meters
    "uv": 5e-4,
    "other": 5e-4,
    "head": 3e-2,
}


def _assert_matches_int8(ref: dict, out: dict, tol=None) -> None:
    tol = tol or INT8_TOLERANCES
    for stage, (r, o) in enumerate(zip(ref["stages"], out["stages"])):
        assert sorted(o) == sorted(r)
        for key, r_val in r.items():
            kind = ("xyz" if "xyz" in key else "uv" if "uv" in key
                    else "other")
            assert tuple(o[key].shape) == tuple(r_val.shape), key
            assert max_err(o[key], r_val) < tol[kind], (stage, key)
    for key in ("seg", "dense"):
        assert max_err(out[key], ref[key]) < tol["head"], key


def test_quant_aux_alone_runs_nine_int8_convs():
    """With ``quant_aux_eval`` alone exactly the nine auxiliary convs run
    int8 (stem, 2 attention pools, 2 fusion convs, the two final convs, the
    seg and dense heads' first convs), dynamic scales; calibration fills one
    max per conv input; against the JAX DIR with the same flag."""
    layers = (1, 1, 1, 1)
    img = np.random.RandomState(12).randn(1, 64, 64, 3).astype(np.float32)
    mano_l, mano_r = _jax_manos()
    jmodel = JDIR(JModelConfig(backbone_layers=layers, quant_aux_eval=True))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.asarray(img), mano_l, mano_r)
    variables = rand_variables(np.random.RandomState(0), shapes)
    ref = jmodel.apply(variables, jnp.asarray(img), mano_l, mano_r,
                       train=False)

    sd = jax_to_state_dict(numpy_tree(variables["params"]),
                           numpy_tree(variables["batch_stats"]), layers)
    model = DIR(ModelConfig(backbone_layers=layers,
                            quant_aux_eval=True)).eval()
    model.load_state_dict(sd, strict=True)
    tl, tr = flagship_mano("/nonexistent")
    calls = []
    real = tquant.conv_int8
    try:
        tquant.conv_int8 = lambda *a, **k: calls.append(1) or real(*a, **k)
        out = make_infer(model, tl, tr)(img)
    finally:
        tquant.conv_int8 = real
    assert len(calls) == 9
    # no int8 value moved here: measured 9.5e-7 at most over all outputs,
    # inside the floating-point slice's bounds
    _assert_matches_int8(ref, out, TOLERANCES)
    serve.calibrate_static_scales(model, img, tl, tr)
    assert len(_leaves(tweights.amax_to_quant_stats(model, layers))) == 9


def test_one_state_dict_loads_into_a_b_and_c():
    """The int8 paths add no parameter and no persistent buffer."""
    layers = (1, 1, 1, 1)
    a = DIR(ModelConfig(backbone_layers=layers, fused_bottleneck_eval=True))
    sd = a.state_dict()
    for cfg in (serve.CONFIG_B, serve.CONFIG_C):
        m = DIR(ModelConfig(backbone_layers=layers, **cfg))
        assert sorted(m.state_dict()) == sorted(sd)
        m.load_state_dict(sd, strict=True)
    model, cfg, _, _ = build_flagship(device="cpu", dtype="float32",
                                      **serve.CONFIG_C)
    assert cfg.quant_fused and cfg.quant_fused_l2_bands == 4
    assert not cfg.fused_bottleneck_eval and cfg.quant_static
    # the bridge's table names exactly the model's scale buffers
    names = {n for n, _ in model.named_buffers() if ".quant_stats." in n}
    assert names == {e.torch_key for e in tweights.quant_mapping()}
    with pytest.raises(KeyError):
        tweights.load_amax(model, {"backbone.quant_stats.nope":
                                   torch.tensor(1.0)})


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
