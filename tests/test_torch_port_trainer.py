"""The port's Trainer and eval app on the CPU (``device="cpu"``), with the
tiny ``(1, 1, 1, 1)`` backbone on a synthetic split of 4 train and 3 test
samples at batch 2, as tests/test_train_e2e.py sizes the JAX package's, at
64x64 to keep the CPU steps short:
an epoch with its checkpoints, ``meta.json`` and resume (host path and
device pipeline, where the augmentation generator's state resumes too),
the non-finite-loss abort, the option guards, ``_call_batches`` and the lr
per step against the JAX package's Trainer, ``Trainer.evaluate()`` against
the JAX package's on the same weights (carried across by ``weights.py``),
and the eval app's SUMMARY line and resume file.

Tolerance of the in-loop summaries against the JAX package's: 1e-5
relative (measured 5.2e-7 for the benchmark metric, 1.4e-7 online: fp32
forwards of two frameworks on equal weights).
"""

import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from dir_tpu.config import Config as JConfig
from dir_tpu.config import DataConfig as JDataConfig
from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.config import TrainConfig as JTrainConfig
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic_mano
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.parallel.mesh import make_mesh
from dir_tpu.train import state as jstate
from dir_tpu.train import steps as jsteps
from dir_tpu.train.trainer import Trainer as JTrainer

from dir_tpu_torch.apps import eval as eval_app
from dir_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                  TrainConfig, load_yaml)
from dir_tpu_torch.data import synthetic
from dir_tpu_torch.data.loader import BatchLoader
from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano
from dir_tpu_torch.train import checkpoint as ckpt
from dir_tpu_torch.train.trainer import AUG_STATE_KEY, Trainer
from dir_tpu_torch.weights import jax_to_state_dict

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree, torch_threads  # noqa: E402
from torch_port_train_helpers import jax_variables  # noqa: E402

LAYERS = (1, 1, 1, 1)
IMG = 64
SUMMARY_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def _drop_outputs(tmp_path):
    """A checkpoint of the tiny DIR with AdamW's moments is about 0.9 GB:
    each test's outputs go as it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Network-tip MANO pairs of both packages (one pair serves the data
    and the model, as apps/train.py has it), the synthetic split, and
    seeded random JAX variables of the tiny DIR (from the init's shapes, no
    init run) with the port's state_dict of the same weights."""
    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    jright = jsynthetic_mano("right", seed=0)
    jleft = jfix(jsynthetic_mano("left", seed=0), jright)
    data_dir = str(tmp_path_factory.mktemp("trainer_data"))
    synthetic.generate(data_dir, left, right, split="train", num_samples=4,
                       img_size=IMG)
    synthetic.generate(data_dir, left, right, split="test", num_samples=3,
                       seed=5, img_size=IMG)
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS))
    variables = jax_variables(jmodel, np.zeros((1, IMG, IMG, 3), np.float32))
    sd = jax_to_state_dict(numpy_tree(variables["params"]),
                           numpy_tree(variables["batch_stats"]), LAYERS)
    return data_dir, (left, right), (jleft, jright), variables, sd


def _cfg(env, out_dir, data=None, **train) -> Config:
    data_dir = env[0]
    train = dict(dict(batch_size=2, total_epochs=1, print_every=1,
                      draw_every=0, output_dir=str(out_dir)), **train)
    return Config(model=ModelConfig(backbone_layers=LAYERS),
                  data=DataConfig(data_dir=data_dir, img_size=IMG,
                                  num_workers=2, **(data or {})),
                  train=TrainConfig(**train))


def _jcfg(env, out_dir, **train) -> JConfig:
    train = dict(dict(batch_size=2, total_epochs=1, print_every=1,
                      draw_every=0, output_dir=str(out_dir)), **train)
    return JConfig(model=JModelConfig(backbone_layers=LAYERS),
                   data=JDataConfig(data_dir=env[0], img_size=IMG,
                                    num_workers=2),
                   train=JTrainConfig(**train))


def _trainer(env, cfg) -> Trainer:
    """A CPU Trainer on the module's weights (the seeded random init of
    the full DIR takes seconds on the CPU; its own path is the card's)."""
    trainer = Trainer(cfg, *env[1], device="cpu")
    trainer.make_data()
    trainer.make_model(env[4])
    return trainer


def _resumed(env, cfg, total_epochs: int) -> Trainer:
    ckpt_dir = os.path.join(cfg.train.output_dir, "checkpoint")
    return _trainer(env, dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, continue_train=True, checkpoint=ckpt_dir,
        total_epochs=total_epochs)))


def test_epoch_checkpoints_and_resume(env, tmp_path):
    """Host path with the overlay dumps on: one epoch, the checkpoints,
    meta.json and config.yaml; a resumed Trainer continues at epoch 1 with
    the same weights and best, and trains it."""
    cfg = _cfg(env, tmp_path, draw_every=2)
    trainer = _trainer(env, cfg)
    best = trainer.train()
    assert np.isfinite(best) and best == trainer.best
    assert trainer.state.step == 2          # 4 samples / batch 2, 1 epoch
    assert np.isfinite(trainer.last_loss)
    ckpt_dir = tmp_path / "checkpoint"
    assert sorted(os.listdir(ckpt_dir)) == ["best.pt", "latest.pt",
                                            "meta.json"]
    meta = ckpt.load_meta(str(ckpt_dir))
    assert meta == {"epoch": 1, "best": best}
    assert load_yaml(str(tmp_path / "config.yaml")) == cfg
    assert sorted(os.listdir(tmp_path / "vis")) == ["e0_i0_left.png",
                                                    "e0_i0_right.png"]
    assert trainer.epoch_stats[0]["steps"] == 2

    resumed = _resumed(env, cfg, total_epochs=2)
    assert (resumed.start_epoch, resumed.state.step) == (1, 2)
    assert resumed.best == best
    want = ckpt.model_state_dict(trainer.model)
    got = ckpt.model_state_dict(resumed.model)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    resumed.train()
    assert resumed.state.step == 4
    assert ckpt.load_meta(str(ckpt_dir))["epoch"] == 2


def test_device_pipeline_resumes_the_generator(env, tmp_path):
    cfg = _cfg(env, tmp_path, data={"device_pipeline": True})
    trainer = _trainer(env, cfg)
    trainer.train()
    assert trainer.state.step == 2
    meta = ckpt.load_meta(str(tmp_path / "checkpoint"))
    assert set(meta) == {"epoch", "best", AUG_STATE_KEY}
    state = trainer.aug_generator.get_state()
    assert meta[AUG_STATE_KEY] == state.tolist()
    # the generator moved past its seed: the epoch drew its augmentation
    assert not torch.equal(state, torch.Generator().manual_seed(
        cfg.train.seed).get_state())
    resumed = _resumed(env, cfg, total_epochs=2)
    assert (resumed.start_epoch, resumed.state.step) == (1, 2)
    assert resumed.best == trainer.best
    assert torch.equal(resumed.aug_generator.get_state(), state)


def test_non_finite_loss_aborts(env, tmp_path):
    trainer = _trainer(env, _cfg(env, tmp_path))
    with torch.no_grad():
        trainer.model.backbone.conv1.weight.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        trainer.train()
    assert not os.path.exists(tmp_path / "checkpoint" / "latest.pt")


@pytest.mark.parametrize("data,train,match", [
    ({"device_pipeline": True}, {"steps_per_call": 2}, "host data path"),
    ({"device_pipeline": True}, {"grad_accum": 2}, "host data path"),
    ({}, {"steps_per_call": 2, "grad_accum": 2}, "mutually exclusive")])
def test_option_guards(env, tmp_path, data, train, match):
    trainer = Trainer(_cfg(env, tmp_path, data=data, **train), *env[1],
                      device="cpu")
    trainer.make_data()
    with pytest.raises(ValueError, match=match):
        trainer.make_model()


@pytest.mark.parametrize("option", ["steps_per_call", "grad_accum"])
def test_call_batches_match_jax(env, tmp_path, option):
    trainer = Trainer(_cfg(env, tmp_path / "port", **{option: 2}), *env[1],
                      device="cpu")
    trainer.make_data()
    jtrainer = JTrainer(_jcfg(env, tmp_path / "jax", **{option: 2}),
                        *env[2], mesh=make_mesh(1))
    jtrainer.make_data()
    for epoch in (0, 1):
        trainer.train_loader.set_epoch(epoch)
        jtrainer.train_loader.set_epoch(epoch)
        got = list(trainer._call_batches(trainer.train_loader))
        want = list(jtrainer._call_batches(jtrainer.train_loader))
        assert len(got) == len(want) == 1
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert g[k].shape[0] == 2, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("scheduler,grad_accum", [("cosine", 1),
                                                  ("step", 2)])
def test_lr_per_step_matches_jax(env, tmp_path, scheduler, grad_accum):
    train = dict(lr_scheduler=scheduler, total_epochs=4,
                 step_milestones=(1, 3), grad_accum=grad_accum)
    trainer = _trainer(env, _cfg(env, tmp_path, **train))
    spe = 2 // grad_accum
    want = jstate.lr_schedule(JTrainConfig(batch_size=2, **train), spe)
    got = [trainer.sched(s) for s in range(12)]
    np.testing.assert_allclose(got, [float(want(s)) for s in range(12)],
                               rtol=1e-6)
    assert len(set(got)) > 1


@pytest.fixture(scope="module")
def same_weights(env, tmp_path_factory):
    """A port Trainer on the module's weights and its ``latest``
    checkpoint."""
    out = tmp_path_factory.mktemp("same_weights")
    trainer = _trainer(env, _cfg(env, out / "port"))
    ckpt_dir = str(out / "checkpoint")
    ckpt.save_checkpoint(ckpt_dir, trainer.state, "latest")
    yield trainer, out, ckpt_dir
    shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("metric,all_stages", [("benchmark", False),
                                               ("online", True)])
def test_evaluate_matches_jax(env, same_weights, metric, all_stages):
    variables = env[3]
    trainer, out, _ = same_weights
    jtrainer = JTrainer(_jcfg(env, out / "jax", inloop_metric=metric),
                        *env[2], mesh=make_mesh(1))
    jtrainer.make_data()
    jtrainer.state = types.SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    jtrainer.eval_step = jsteps.make_eval_step(jtrainer.model, *env[2],
                                               mesh=jtrainer.mesh)
    trainer.cfg = dataclasses.replace(trainer.cfg, train=dataclasses.replace(
        trainer.cfg.train, inloop_metric=metric))
    want = jtrainer.evaluate(all_stages=all_stages)
    got = trainer.evaluate(all_stages=all_stages)
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=SUMMARY_RTOL,
                                   err_msg=k)


def _summary(capsys) -> dict:
    out = capsys.readouterr().out
    assert "joint mean error" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("SUMMARY "))
    return json.loads(line[len("SUMMARY "):])


def _app_args(env, model, out_dir, *more):
    return ["--model", model, "--data_path", env[0], "--out",
            str(out_dir), "--bs", "2", "--backbone_layers", "1,1,1,1",
            "--synthetic_mano", "--device", "cpu", *more]


def test_eval_app_summary_and_resume(env, same_weights, tmp_path,
                                     monkeypatch, capsys):
    """An uninterrupted run, then a run that dies after one of two batches
    and resumes from its file: the same SUMMARY and dumps."""
    model = os.path.join(same_weights[2], "latest")
    want = eval_app.main(_app_args(env, model, tmp_path / "full",
                                   "--resume_every", "1"))
    assert _summary(capsys) == want
    errs = np.loadtxt(tmp_path / "full" / "joint_left_error.txt")
    assert errs.shape == (3, 21) and np.isfinite(errs).all()

    real_iter_from = BatchLoader.iter_from

    def dying_iter_from(self, start):
        for i, b in enumerate(real_iter_from(self, start)):
            if start + i >= 1:
                raise RuntimeError("simulated outage")
            yield b

    monkeypatch.setattr(BatchLoader, "iter_from", dying_iter_from)
    out_dir = tmp_path / "resumed"
    with pytest.raises(RuntimeError, match="simulated outage"):
        eval_app.main(_app_args(env, model, out_dir, "--resume_every", "1"))
    capsys.readouterr()
    files = glob.glob(str(out_dir / "eval_resume.*.npz"))
    assert len(files) == 1
    with np.load(files[0]) as saved:
        assert int(saved["_batches_done"]) == 1
    monkeypatch.setattr(BatchLoader, "iter_from", real_iter_from)
    got = eval_app.main(_app_args(env, model, out_dir, "--resume_every",
                                  "1"))
    assert _summary(capsys) == got == want
    assert not os.path.exists(files[0])
    for name in ("joint_left_error.txt", "root_loss.txt", "left_joint.txt",
                 "mesh_2d_right_error.txt"):
        np.testing.assert_array_equal(np.loadtxt(out_dir / name),
                                      np.loadtxt(tmp_path / "full" / name))


def test_eval_app_reads_a_trainer_checkpoint(env, same_weights, tmp_path,
                                             capsys):
    """The app on a Trainer checkpoint, named as ``<dir>/latest``,
    ``<dir>/latest.pt`` or ``<dir>``, gives the Trainer's own benchmark
    summary (per-sample means against sums over the count)."""
    trainer, _, ckpt_dir = same_weights
    trainer.cfg = dataclasses.replace(trainer.cfg, train=dataclasses.replace(
        trainer.cfg.train, inloop_metric="benchmark"))
    want = trainer.evaluate()
    got = None
    for model in (os.path.join(ckpt_dir, "latest"),
                  os.path.join(ckpt_dir, "latest.pt"), ckpt_dir):
        summary = eval_app.main(_app_args(env, model, tmp_path,
                                          "--resume_every", "0"))
        assert _summary(capsys) == summary
        assert got is None or summary == got
        got = summary
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=SUMMARY_RTOL, err_msg=k)


def test_entry_points_need_a_card_unless_told(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg(env, tmp_path), *env[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_app.main(_app_args(env, "random", tmp_path)[:-2])


def test_trainer_import_needs_no_cv2():
    code = ("import sys; sys.modules['cv2'] = None; "
            "import dir_tpu_torch.train.trainer, dir_tpu_torch.apps.eval; "
            "import dir_tpu_torch.data.device_pipeline, "
            "dir_tpu_torch.data.loader")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.slow
def test_two_trainers_train_alike(env, tmp_path):
    """Both packages' whole Trainers on the same weights and data, one
    epoch of two steps on the host path: the logged loss of each step and
    the in-loop summary after the epoch agree."""
    variables = env[3]
    trainer = _trainer(env, _cfg(env, tmp_path / "port"))
    jtrainer = JTrainer(_jcfg(env, tmp_path / "jax"), *env[2],
                        mesh=make_mesh(1))
    jtrainer.make_data()
    jtrainer.make_model(init_params=variables["params"],
                        init_stats=variables["batch_stats"])
    losses = {}
    for name, t in (("port", trainer), ("jax", jtrainer)):
        seen = []
        log = t.logger.info

        def record(msg, *args, seen=seen, log=log):
            if "loss" in msg and args:
                seen.append(float(args[-1]))
            log(msg, *args)

        t.logger.info = record
        try:
            best = t.train()
        finally:
            t.logger.info = log
        losses[name] = seen
        assert np.isfinite(best)
    assert len(losses["port"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    np.testing.assert_allclose(trainer.best, jtrainer.best, rtol=1e-3)
    assert int(jax.device_get(jtrainer.state.step)) == trainer.state.step
