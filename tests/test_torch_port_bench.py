"""The port's measurement entry points on the CPU: ``dir_tpu_torch/bench.py``
(the counterpart of ``bench.py``) and ``dir_tpu_torch/tools/*`` (of
``tools/*``), at tiny sizes.

* the bench's error contract (``tests/test_bench_outage.py``'s): with no
  card and no CPU request, one JSON line with ``"error"``, value 0.0, rc 1;
* the bench's three measurements in process on the CPU with the tiny
  ``(1, 1, 1, 1)`` backbone: the line has ``bench.py``'s keys and
  ``device``, every number finite;
* the bench's train batch is ``bench.py:169-183``'s draw, array for array
  (the dict literal is read out of ``bench.py`` itself);
* the arrays the bench's eval times equal ``bench.py``'s ``one`` (the
  jitted final-stage triple of the JAX DIR) at fp32 on the same weights,
  with a ``(3, 1, 1, 1)`` backbone so that the fused guard takes layer1_1
  and layer1_2 (K1's plain route twice a forward here; ``dir_tpu`` runs its
  Pallas kernel in interpret mode off the TPU);
* the tools print their JAX counterparts' lines: the serving latency per
  batch, the train step, the loaders, the input pipelines, the int8
  accuracy table (the same ``MODES``), the concurrent server's two modes;
  ``profile_serve --batches``.

The train step's ``unroll`` against ``dir_tpu``'s is held elsewhere
(``test_torch_port_parallel.py``'s "unroll" case, ``test_torch_port_
checkpoint.py:test_unroll_runs_consecutive_steps``).
"""

import ast
import importlib.util
import json
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
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic
from dir_tpu.models.dir import DIR as JDIR

from dir_tpu_torch import bench
from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.serve import flagship_mano, make_infer
from dir_tpu_torch.tools import (bench_input_pipeline, bench_serve_concurrent,
                                 bench_serve_latency, bench_train,
                                 bench_train_pipeline, quant_accuracy)
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_model import LAYERS, TOLERANCES  # noqa: E402
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                rand_variables, torch_threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = (1, 1, 1, 1)
# bench.py's line (bench.py:283-301, 320): every key the port's line has too
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "train_step_ms_b64",
              "train_img_per_sec", "serving_int8_static_img_per_sec")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _load_jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_without_a_card_prints_one_error_line():
    env = {k: v for k, v in os.environ.items() if k != "BENCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "dir_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, proc.stdout
    rec = json.loads(lines[0])
    assert rec["metric"] == "dir_eval_images_per_sec"
    assert rec["value"] == 0.0 and "CUDA" in rec["error"]


def test_bench_line_on_the_cpu(monkeypatch, capsys):
    """``bench.main``'s three measurements at batch 2, unroll 2, one
    warm-up and one timed call, on the tiny backbone (through the model
    keyword ``measure`` passes to every model)."""
    source = open(os.path.join(REPO, "bench.py")).read()
    for key in BENCH_KEYS:
        assert f'"{key}"' in source, key
    for var, val in (("BENCH_DEVICE", "cpu"), ("EVAL_UNROLL", "2"),
                     ("UNROLL", "2")):
        monkeypatch.setenv(var, val)
    for var in ("BENCH_EVAL", "BENCH_TRAIN", "BENCH_INT8", "QUANT"):
        monkeypatch.delenv(var, raising=False)
    for attr, val in (("BATCH", 2), ("TRAIN_BATCH", 2), ("WARMUP", 1),
                      ("ITERS", 1)):
        monkeypatch.setattr(bench, attr, val)
    measure = bench.measure
    monkeypatch.setattr(bench, "measure",
                        lambda: measure(backbone_layers=TINY))
    bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert sum(ln.lstrip().startswith("{") for ln in lines) == 1
    assert "error" not in rec and "serving_int8_static_error" not in rec
    assert set(BENCH_KEYS) | {"device"} <= set(rec)
    assert rec["metric"] == "dir_eval_images_per_sec"
    assert rec["unit"] == "img/s" and rec["device"] == "cpu"
    for key in BENCH_KEYS[1:]:
        if key != "unit":
            assert np.isfinite(rec[key]) and rec[key] > 0, key
    assert rec["vs_baseline"] == round(rec["value"] / 1000.0, 4)


def _bench_py_batch(b: int) -> dict:
    """``bench.py:bench_train``'s batch literal, evaluated as written."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_train")
    assign = next(n for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and isinstance(n.value, ast.Dict)
                  and getattr(n.targets[0], "id", "") == "batch")
    code = compile(ast.Expression(assign.value), "bench.py", "eval")
    return eval(code, {"np": np, "rng": np.random.RandomState(0), "b": b})


def test_train_batch_is_bench_py_draw():
    want = _bench_py_batch(2)
    got = bench.train_batch(2)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _bench_py_one(img: np.ndarray):
    """``bench.py``'s ``one`` (``bench.py:110-114``), jitted as it is there,
    on the JAX DIR with its eval flags at fp32 and seeded random variables
    (params and BN statistics); K1 runs in the JAX package's interpret mode
    off the TPU (``dir_tpu/models/resnet.py:163``). Returns the variables
    and the triple."""
    mano_r = jsynthetic("right", seed=0)
    mano_l = jfix(jsynthetic("left", seed=0), mano_r)
    model = JDIR(JModelConfig(backbone_layers=LAYERS, dtype="float32",
                              fused_bottleneck_eval=True,
                              backbone_stem="conv7"))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(img), mano_l, mano_r)
    variables = rand_variables(np.random.RandomState(0), shapes)

    def one(image):
        out = model.apply(variables, image, mano_l, mano_r, train=False)
        final = out["stages"][-1]
        return (final["pd_mesh_xyz_left"], final["pd_mesh_xyz_right"],
                final["pd_offset"])

    return variables, jax.jit(one)(jnp.asarray(img))


def test_eval_call_matches_bench_py_one():
    """The bench's unrolled eval call at fp32 (its other flags: the fused
    bottleneck, the conv7 stem) against ``bench.py``'s ``one`` on the JAX
    DIR with the same variables."""
    img = np.random.RandomState(0).randn(1, 256, 256, 3).astype(np.float32)
    variables, want = _bench_py_one(img)
    flags = dict(bench.eval_flags(0, False, True), dtype="float32",
                 backbone_layers=LAYERS)
    assert flags["fused_bottleneck_eval"] and flags["backbone_stem"] == "conv7"
    model = DIR(ModelConfig(**flags)).eval()
    model.load_state_dict(jax_to_state_dict(
        numpy_tree(variables["params"]), numpy_tree(variables["batch_stats"]),
        LAYERS), strict=True)
    tl, tr = flagship_mano("/nonexistent")
    call = bench.eval_call(model, tl, tr, unroll=2)
    before = fb.fused_bottleneck_infer.plain_runs
    outs = call(torch.from_numpy(np.stack([img, img])))
    assert fb.fused_bottleneck_infer.plain_runs - before == 4
    assert len(outs) == 2
    for triple in outs:
        for got, w, tol in zip(triple, want, (TOLERANCES["xyz"],
                                              TOLERANCES["xyz"],
                                              TOLERANCES["other"])):
            assert tuple(got.shape) == tuple(w.shape)
            assert max_err(got, w) < tol


def test_serve_latency_prints_a_line_per_batch(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.delenv("QUANT", raising=False)
    monkeypatch.setattr(bench_serve_latency, "BATCHES", (1, 2))
    monkeypatch.setattr(bench_serve_latency, "ITERS", 2)
    lines = bench_serve_latency.main(backbone_layers=TINY)
    assert capsys.readouterr().out.strip().splitlines() == lines
    pattern = (r"batch +(\d+): p50 +([\d.]+) ms  p99 +([\d.]+) ms  \( *[\d.]+"
               r" img/s at p50\)  upload p50 +[\d.]+ ms \([\d.]+%\)$")
    assert [int(re.match(pattern, ln).group(1)) for ln in lines] == [1, 2]


def test_bench_train_tool_line(monkeypatch):
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.delenv("UNROLL", raising=False)
    monkeypatch.setattr(bench_train, "BATCH", 2)
    monkeypatch.setattr(bench_train, "ITERS", 1)
    line = bench_train.main(backbone_layers=TINY)
    m = re.match(r"train_step: ([\d.]+) ms \((\d+) img/s\), unroll=1, "
                 r"loss=([-\d.]+)$", line)
    assert m and float(m.group(1)) > 0 and np.isfinite(float(m.group(3)))


def test_quant_accuracy_rows():
    """Six rows named as ``tools/quant_accuracy.py``'s ``MODES``, with the
    same eval flags; every metric finite; the fp row is the delta base."""
    jax_modes = _load_jax_tool("quant_accuracy").MODES
    assert quant_accuracy.MODES == jax_modes
    rows = quant_accuracy.main(["--samples", "2", "--bs", "2",
                                "--backbone_layers", "1,1,1,1",
                                "--device", "cpu"])
    assert [name for name, _ in rows] == [name for name, _ in jax_modes]
    base = rows[0][1]
    for _, s in rows:
        assert set(s) == set(quant_accuracy.KEYS)
        assert all(np.isfinite(v) for v in s.values())
    assert all(base[k] - base[k] == 0.0 for k in quant_accuracy.KEYS)
    # the int8 rows differ from fp: the modes took effect
    assert rows[2][1] != base


def test_train_pipeline_host_only(capsys):
    rates = bench_train_pipeline.main(["--samples", "4", "--batch", "2",
                                       "--threads", "2"])
    out = capsys.readouterr().out
    assert set(rates["host"]) == {"jpg", "cached"} and not rates["fed"]
    for path in ("jpg", "cached"):
        assert re.search(rf"host-only  {path} *: +[\d.]+ img/s", out)
    assert "packed cache built in" in out


def test_input_pipeline_with_the_device_path_on_the_cpu(capsys):
    out = bench_input_pipeline.main(["--n", "4", "--batch", "2",
                                     "--device", "cpu"])
    text = capsys.readouterr().out
    assert set(out) == {"cv2", "native", "device"}
    assert all(v > 0 for v in out.values())
    for label in ("host cv2 warp:", "host native warp:", "device pipeline:"):
        assert re.search(rf"{label} +[\d.]+ ms/sample", text), label


def test_concurrent_server_modes(monkeypatch, capsys):
    """Both modes of the concurrent tool over HTTP on the live tiny model
    (the artifact's export is held elsewhere: test_torch_port_artifact)."""
    for attr, val in (("CLIENTS", 2), ("REQS", 2), ("MB", 2),
                      ("BUCKETS", (1, 2))):
        monkeypatch.setattr(bench_serve_concurrent, attr, val)
    model = DIR(ModelConfig(backbone_layers=TINY)).eval()
    infer = make_infer(model, *flagship_mano("/nonexistent"))
    infer.device = torch.device("cpu")
    results = bench_serve_concurrent.serve_both(infer)
    out = capsys.readouterr().out
    assert [r["mode"] for r in results] == ["single-flight", "micro-batched"]
    assert results[0]["avg_batch"] == 1.0 and results[0]["dispatches"] == 4
    assert 1.0 <= results[1]["avg_batch"] <= 2.0
    for r in results:
        assert r["reqs"] == 4 and r["p50_ms"] > 0 and r["img_per_sec"] > 0
        assert re.search(rf"{r['mode']} *: p50 +[\d.]+ ms  p99 +[\d.]+ ms  "
                         r"+[\d.]+ img/s  avg_batch [\d.]+ \(\d+ dispatches\)",
                         out)
    assert json.loads(out.strip().splitlines()[-1][len("RESULTS "):]) == \
        results


def test_profile_serve_batches_option():
    from dir_tpu_torch import profile_serve

    args = profile_serve.parse_args(["--batches", "256"])
    assert args.batches == "256" and args.config == "A"
    assert profile_serve.parse_args([]).batches == "1,8,64"
