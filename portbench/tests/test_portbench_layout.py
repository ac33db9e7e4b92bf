"""The benchmark is driven by data: every name in BENCHMARK.json resolves
to its files, and a new cell and a new metric come as new files alone."""

import json
import os
import shutil

import pytest

from portbench import build, harness
from portbench.rooflines import k1, k5
from portbench.tests import tiny

BENCH = build.benchmark()


def test_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        reported = [n for n, m in e2e.items()
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(w):
    entry, cfg, traffic = build.cell(w)
    assert cfg["name"] == entry["config"]
    assert os.path.exists(os.path.join(
        build.ROOT, "portbench", "drivers", f"{traffic['driver']}.py"))
    assert traffic["reports"] in {m["name"] for m in BENCH["end_to_end"]}
    assert set(harness.limits(w))


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["per_layer"]])
def test_metric_resolves_by_name(m):
    meta = [x for x in BENCH["per_layer"] if x["name"] == m][0]
    assert callable(harness.load_reader(m))
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    assert all(w in e2e[meta["moves"]]["workloads"]
               for w in meta["workloads"])


def test_new_cell_and_metric_are_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark with one more cell (a traffic file and a
    limits file) and one more per-layer metric (its reader), and only
    entries added to BENCHMARK.json: the new cell runs and reports the
    new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(build.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "a_eval_b2_dummy", "config":
                               "dir_r50_a", "traffic": "eval_b2_dummy",
                               "chips": 1, "why": "a test's cell"})
    bench["end_to_end"][0]["workloads"].append("a_eval_b2_dummy")
    bench["per_layer"].append({
        "name": "dummy_calls.eval", "unit": "calls", "better": "lower",
        "source": "program_counter", "layer": "serve: a test's layer",
        "moves": "eval_img_per_s", "workloads": ["a_eval_b2_dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((root / "portbench/traffic/eval_b1024.json")
                         .read_text())
    (root / "portbench/traffic/eval_b2_dummy.json").write_text(json.dumps(
        dict(traffic, batch=2, pool=2, compare=1, compare_from=2,
             trace_units=2)))
    (root / "portbench/limits/a_eval_b2_dummy.json").write_text(
        (root / "portbench/limits/a_eval_b1024.json").read_text())
    (root / "portbench/metrics/dummy_calls.eval.py").write_text(
        "def read(found):\n    return found['units']\n")
    monkeypatch.setattr(build, "ROOT", str(root))
    entry, cfg, traffic = build.cell("a_eval_b2_dummy")
    cfg = dict(cfg, backbone_layers=[1, 1, 1, 1], image_size=64,
               program=dict(cfg["program"], dtype="float32"))
    line = tiny.tiny_run("a_eval_b2_dummy", trace=True, seconds=4.0,
                         cell=(entry, cfg, traffic))
    assert line["metrics"]["dummy_calls.eval"]["value"] == 2
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_k1_bytes_give_its_bound():
    peaks = harness.peaks()
    flops, nbytes = k1.work(256, 64, 64, 256, 64, 256)
    assert abs(nbytes / 1e9 - 1.074) < 0.001
    assert abs(k1.bound_s(peaks, 256, 64, 64, 256, 64, 256) * 1e3
               - 0.321) < 0.001


def test_k5_bytes_give_its_bound():
    peaks = harness.peaks()
    assert abs(k5.bound_s(peaks, 256, 32, 64) * 1e3 - 0.201) < 0.001


@pytest.mark.parametrize("name", ["dir_r50_a", "dir_r50_b"])
def test_flops_per_image_as_counted(name):
    """The FLOPs of one image that ``mfu.*`` use are those that
    ``flops.per_image`` counts on the reference: A's forward about 22.2
    GFLOP (the factored splat conv), B's 36.8 (the materialized fusion
    conv counts 15.1 where the factored form counts 0.5); a train step's
    image three times its forward."""
    import torch

    from portbench import flops
    from portbench.drivers import train
    from portbench.reference import losses

    torch.set_num_threads(4)
    cfg = build.read_json(f"portbench/configs/{name}.json")
    ref = build.reference(cfg, "cpu")
    _, pair = build.mano(1, "cpu")
    r = harness.Run("b_train_b64", 5, 1.0, False, "cpu",
                    (None, cfg, {"batch": flops.COUNT_BATCH}))
    batch = train.wire_batches(r, 1)[0]
    stored = cfg["flops_per_image"]
    assert flops.per_image(ref, pair, cfg) == stored["forward"]
    assert flops.per_image(ref, pair, cfg, train=True,
                           batch_fn=lambda n: losses.decode(
                               batch, "cpu")) == stored["train_step"]
    want = {"dir_r50_a": 22.2, "dir_r50_b": 36.8}[name]
    assert abs(stored["forward"] / 1e9 - want) < 0.1
