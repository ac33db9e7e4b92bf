"""Tiny CPU runs of each traffic mix end in one last line of the
contract, and nothing a run loads is JAX or the JAX package; the plain
reference loads nothing of the program either."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from portbench import build, harness
from portbench.tests import tiny

WORKLOADS = [w["name"] for w in build.benchmark()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("w", WORKLOADS)
def test_last_line_of_the_contract(w, trace):
    line = tiny.tiny_run(w, trace=trace)
    r = harness.Run(w, 1, 1.0, trace, "cpu", tiny.tiny_cell(w))
    out = io.StringIO()
    with redirect_stdout(out):
        assert harness.finish(r, line) == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert last["device"]["platform"] == "cpu"
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: no device metric is written
        assert not any(k.startswith(("mfu", "device_idle", "launches", "k"))
                       for k in last["metrics"])
    else:
        e2e = {m["name"] for m in build.benchmark()["end_to_end"]
               if w in m.get("workloads", [w])}
        assert set(last["metrics"]) == e2e
        assert last["metrics"]["setup_s"]["value"] > 0


def _python(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=build.ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=build.ROOT,
                          env=env, capture_output=True, text=True,
                          check=True, timeout=600).stdout


def test_a_run_loads_no_jax():
    out = _python(
        "import sys\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        "tiny.tiny_run('a_eval_b1024', seconds=0.5)\n"
        "print(harness.forbidden_modules())\n")
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dir_tpu_torchlike", sys)
    assert "dir_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dir_tpu.models", sys)
    assert "dir_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    out = _python(
        "import sys\n"
        "import portbench.reference.net, portbench.reference.mano\n"
        "import portbench.reference.losses, portbench.reference.compare\n"
        "import portbench.reference.precision\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "      & {'jax', 'jaxlib', 'flax', 'dir_tpu', 'dir_tpu_torch'}))\n")
    assert out.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a CUDA device the command prints no result and fails."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        WORKLOADS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=build.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
