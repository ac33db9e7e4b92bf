"""The port's Trainer, train app and eval app over two gloo CPU ranks
against one rank (``dir_tpu_torch/parallel/``; the units and the train step
against ``dir_tpu`` are in test_torch_port_parallel.py).

On a synthetic split at 64x64 with the tiny ``(1, 1, 1, 1)`` backbone:

* the Trainer with the device pipeline, global batch 4 (2 a rank), one
  epoch of 2 steps with its in-loop eval on a padded test batch: each
  step's loss and the eval summary equal the one-rank Trainer's; rank 0
  alone writes the checkpoints; a resumed two-rank Trainer continues at
  epoch 1 and trains it; both ranks end bit-identical;
* ``apps/train.py --devices 2 --device cpu`` for one epoch;
* ``apps/eval.py --devices 2`` (with ``--unroll 2``, and with dynamic int8)
  writes the per-sample files and SUMMARY of ``--devices 1``, and
  ``--unroll 2`` those of ``--unroll 1``, as tests/test_apps_cli.py holds
  ``dir_tpu``'s sharded eval.

Each rank is a process; every wait is bounded and a run that outlives it
is killed with its ranks.
"""

import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models.dir import DIR as JDIR

from dir_tpu_torch.apps import eval as eval_app
from dir_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from dir_tpu_torch.data import synthetic
from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano
from dir_tpu_torch.train.trainer import Trainer
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree, torch_threads  # noqa: E402
from torch_port_parallel_worker import REPO, run_ranks  # noqa: E402
from torch_port_train_helpers import LAYERS, jax_variables  # noqa: E402

IMG = 64
APP_TIMEOUT = 420
# Two ranks against one at fp32 (relative). Each step's loss: measured
# 7.8e-6 (after an AdamW step the weights differ by the gradients' fp32
# rounding, which Adam's normalized update magnifies near a zero gradient).
# The in-loop summary on the same weights: measured 2.7e-7; of two
# Trainers each trained its own way: measured 9.8e-4, the same
# magnification.
LOSS_RTOL = 1e-4
SUMMARY_RTOL = 3e-6
TRAINED_SUMMARY_RTOL = 1e-2
# The int8 eval's dumps (mm, printed to 3 decimals; measured 0) within one
# int8 step, dir_tpu's bound for its sharded int8 eval; SUMMARY (measured
# 0) relative.
EVAL_INT8_ATOL = 5e-3
EVAL_INT8_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The synthetic split (8 train samples: 2 steps of 4; 3 test samples:
    one batch padded to 4, rank 1's block half padding) and the port's
    state_dict of seeded random weights."""
    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    data = str(tmp_path_factory.mktemp("dp_split"))
    synthetic.generate(data, left, right, split="train", num_samples=8,
                       img_size=IMG)
    synthetic.generate(data, left, right, split="test", num_samples=3,
                       seed=5, img_size=IMG)
    variables = jax_variables(JDIR(JModelConfig(backbone_layers=LAYERS)),
                              np.zeros((1, IMG, IMG, 3), np.float32))
    sd = jax_to_state_dict(numpy_tree(variables["params"]),
                           numpy_tree(variables["batch_stats"]), LAYERS)
    return data, (left, right), sd


def _cfg(data, out, **train) -> Config:
    return Config(model=ModelConfig(backbone_layers=LAYERS),
                  data=DataConfig(data_dir=data, img_size=IMG,
                                  num_workers=2, device_pipeline=True),
                  train=TrainConfig(**dict(dict(
                      batch_size=4, total_epochs=1, print_every=1,
                      draw_every=0, output_dir=str(out)), **train)))


def test_trainer_two_ranks_match_one_and_resume(split, tmp_path):
    data, manos, sd = split
    work = tmp_path / "ranks"
    try:
        ranks = run_ranks([("trainer", "trainer", {
            "cfg": _cfg(data, tmp_path / "two"), "state_dict_of": "w"})],
            2, str(work), threads=2, state_dicts={"w": sd})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ranks = [r["trainer"] for r in ranks]

    one = Trainer(_cfg(data, tmp_path / "one"), *manos, device="cpu")
    one.make_data()
    one.make_model(init_state_dict=sd)
    losses, step = [], one.train_step

    def recording_step(state, batch):
        state, loss_dict = step(state, batch)
        losses.append(float(sum(torch.stack(
            list(loss_dict.values())).double().tolist())))
        return state, loss_dict

    one.train_step = recording_step
    best = one.train()
    trained = one.evaluate()
    # one rank on the two ranks' final weights (their latest checkpoint)
    same = Trainer(_cfg(data, tmp_path / "one", continue_train=True,
                        checkpoint=str(tmp_path / "two" / "checkpoint")),
                   *manos, device="cpu")
    same.make_data()
    same.make_model(init_state_dict=sd)
    assert same.state.step == 4
    on_same = same.evaluate()
    shutil.rmtree(tmp_path / "one", ignore_errors=True)
    shutil.rmtree(tmp_path / "two", ignore_errors=True)

    def worst(pairs):
        return max(abs(a - b) / abs(b) for a, b in pairs)

    loss_err = worst((a, b) for r in ranks
                     for a, b in zip(r["first"]["losses"], losses))
    same_err = worst((r["resumed"]["summaries"][-1][k], v) for r in ranks
                     for k, v in on_same.items())
    trained_err = worst((r["first"]["summaries"][-1][k], v) for r in ranks
                        for k, v in trained.items())
    print(f"two ranks vs one (relative): losses {loss_err}; in-loop "
          f"summary on the same weights {same_err}, of the Trainers each "
          f"trained {trained_err}")
    assert loss_err <= LOSS_RTOL
    assert same_err <= SUMMARY_RTOL
    assert trained_err <= TRAINED_SUMMARY_RTOL
    for r in ranks:
        first = r["first"]
        assert len(first["losses"]) == len(losses) == 2
        assert first["best"] == first["summaries"][-1]["joint_mean_all_mm"]
        np.testing.assert_allclose(first["best"], best,
                                   rtol=TRAINED_SUMMARY_RTOL)
        assert first["start"] == (0, 0, float("inf"))
        # the resumed Trainer starts where the first stopped and trains
        # epoch 1
        resumed = r["resumed"]
        assert resumed["start"] == (1, 2, first["best"])
        assert resumed["step"] == 4 and len(resumed["losses"]) == 2
        assert np.isfinite(resumed["losses"]).all()
    # rank 0 alone wrote the checkpoints: latest and best after the first
    # epoch, latest (and best, if better) after the resumed one
    assert not ranks[1]["written"]
    names = [os.path.basename(p) for p in ranks[0]["written"]]
    assert names[:2] == ["latest.pt.tmp", "best.pt.tmp"]
    assert names.count("latest.pt.tmp") == 2
    assert ranks[0]["digest"] == ranks[1]["digest"]


def _run(module: str, args: list) -> str:
    """``python -m module args`` in its own session; its stdout. A run that
    outlives APP_TIMEOUT is killed with the ranks it started."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")  # a rank
    proc = subprocess.Popen([sys.executable, "-m", module, *args], env=env,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=APP_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-2000:]
    return out


def test_train_app_two_ranks(split, tmp_path):
    """``apps/train.py --devices 2 --device cpu`` starts two gloo ranks and
    trains an epoch of 2 steps with its in-loop eval; rank 0 writes the
    checkpoint and logs."""
    data = split[0]
    out = tmp_path / "out"
    try:
        log = _run("dir_tpu_torch.apps.train", [
            "--device", "cpu", "--devices", "2", "--synthetic_mano",
            "--data_dir", data, "--output", str(out), "--batch_size", "4",
            "--epochs", "1", "--backbone_layers", "1,1,1,1",
            "--img_size", str(IMG), "--num_workers", "2",
            "--device_pipeline"])
        assert os.path.exists(out / "checkpoint" / "latest.pt")
        assert os.path.exists(out / "checkpoint" / "meta.json")
        assert log.count("training done") == 1      # rank 0 logs
        assert log.count("[epoch 0][it 0]") == 1
    finally:
        shutil.rmtree(out, ignore_errors=True)


_DUMPS = ("left_joint.txt", "right_joint.txt", "joint_left_error.txt",
          "joint_right_error.txt", "mesh_left_error.txt",
          "mesh_right_error.txt", "joint_2d_left_error.txt",
          "joint_2d_right_error.txt", "mesh_2d_left_error.txt",
          "mesh_2d_right_error.txt", "root_loss.txt")


def _summary(text: str) -> dict:
    line = next(ln for ln in text.splitlines() if ln.startswith("SUMMARY "))
    return json.loads(line[len("SUMMARY "):])


@pytest.mark.parametrize("quant", [False, True])
def test_eval_app_two_ranks_equal_one(split, tmp_path, capsys, quant):
    """``--devices 2`` writes the dumps and SUMMARY of ``--devices 1``.

    fp32: two ranks at ``--bs 4`` run the forwards that one process runs at
    ``--bs 2`` (blocks of 2), and the dumps and SUMMARY are equal; PyTorch's
    CPU convolutions round differently at another batch size or thread
    count (measured: 0.001 mm, one printed digit), so both sides run the
    same shapes on one thread. ``--unroll 2`` equals ``--unroll 1``, also
    with two ranks.

    Dynamic int8: the activation scales are the global batch's, so both
    sides run ``--bs 4``; a rank's forward of 2 then rounds in fp32 apart
    from one process's forward of 4, which can move an activation on a
    rounding boundary by one int8 step: the dumps within one such step, as
    tests/test_apps_cli.py allows ``dir_tpu``'s sharded int8 eval (5e-3
    mm), measured below it."""
    data = split[0]
    args = ["--model", "random", "--data_path", data, "--backbone_layers",
            "1,1,1,1", "--synthetic_mano", "--device", "cpu",
            "--resume_every", "0"]
    if quant:
        args += ["--quant_backbone", "--quant_decoder", "--quant_aux"]
        runs = {"one": ["--bs", "4"], "two": ["--bs", "4", "--devices", "2"]}
    else:
        runs = {"one": ["--bs", "2"], "unroll": ["--bs", "2", "--unroll", "2"],
                "two": ["--bs", "4", "--devices", "2", "--unroll", "2"]}
    outs = {}
    for name, more in runs.items():
        out = tmp_path / name
        argv = args + ["--out", str(out)] + more
        if "--devices" in more:
            summary = _summary(_run("dir_tpu_torch.apps.eval", argv))
        else:
            with torch_threads(1):
                eval_app.main(argv)
            summary = _summary(capsys.readouterr().out)
        outs[name] = (summary, {f: np.loadtxt(out / f) for f in _DUMPS})
    want_summary, want = outs.pop("one")
    assert want["joint_left_error.txt"].shape == (3, 21)
    for name, (summary, dumps) in outs.items():
        err = max(float(np.abs(dumps[f] - v).max()) for f, v in want.items())
        rel = max(abs(summary[k] - v) / abs(v)
                  for k, v in want_summary.items())
        print(f"eval {name} (int8 {quant}): dumps {err}, SUMMARY {rel}")
        assert sorted(summary) == sorted(want_summary)
        assert err <= (EVAL_INT8_ATOL if quant else 0.0), name
        assert rel <= (EVAL_INT8_RTOL if quant else 0.0), name
