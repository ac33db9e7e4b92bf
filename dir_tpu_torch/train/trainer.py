"""Trainer: the epoch loop, in-loop eval, checkpoints and resume
(counterpart of ``dir_tpu/train/trainer.py``).

Each step takes a batch from the threaded loader (pinned host memory when
the device is CUDA), runs the on-device preprocessing when
``data.device_pipeline`` is set, and the port's train step (forward, the
DIR loss, backward, AdamW). After every epoch the ``latest`` checkpoint is
written, the test split is evaluated with the in-loop metric, a better
metric writes ``best``, and ``meta.json`` records the next epoch, the best
metric and the augmentation generator's state, from which a run resumes.
The data modules are imported in :meth:`Trainer.make_data`, so importing
this module needs no cv2.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from dir_tpu_torch import weights
from dir_tpu_torch.config import Config, save_yaml
from dir_tpu_torch.device import no_tf32, resolve_device
from dir_tpu_torch.mano.assets import ManoModel
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.train import checkpoint as ckpt
from dir_tpu_torch.train import evaluate
from dir_tpu_torch.train.state import create_train_state, make_optimizer
from dir_tpu_torch.train.steps import (decode_wire8, make_eval_step,
                                       make_train_step)
from dir_tpu_torch.utils.logger import setup_logger

_BATCH_KEYS = (
    "img", "joint_2d_left", "joint_2d_right", "mesh_2d_left", "mesh_2d_right",
    "joint_3d_left", "joint_3d_right", "mesh_3d_left", "mesh_3d_right",
    "center_left", "center_right", "seg", "dense",
)
# what the in-loop metrics read besides the image
_EVAL_KEYS = ("img", "joint_3d_left", "joint_3d_right", "mesh_3d_left",
              "mesh_3d_right", "camera")
# meta.json's key of the augmentation generator's state (the JAX package
# stores its augmentation PRNG key there)
AUG_STATE_KEY = "aug_generator_state"


def opt_steps_per_epoch(num_samples: int, batch_size: int,
                        grad_accum: int) -> int:
    """Optimizer steps per epoch, the lr schedule's quantum: with
    ``grad_accum`` N the step count advances once per N loader
    micro-batches, so the micro-batch count is divided by N to keep the
    schedule on the epoch's cadence."""
    return max(1, num_samples // batch_size // max(1, grad_accum))


def _stack(xs):
    """Stack equal-shaped arrays or tensors on a new leading axis; tensors
    in pinned memory stay pinned."""
    if not isinstance(xs[0], torch.Tensor):
        return np.stack(xs)
    out = torch.empty((len(xs),) + tuple(xs[0].shape), dtype=xs[0].dtype,
                      pin_memory=xs[0].is_pinned())
    return torch.stack(xs, out=out)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Trainer:
    """``Trainer(cfg, mano_left, mano_right).make_data(); .make_model();
    .train()``. Runs on ``device``: CUDA unless the caller names another;
    raises when no card is present and none was named. One MANO pair
    serves the data and the model."""

    def __init__(self, cfg: Config, mano_left: ManoModel,
                 mano_right: ManoModel, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mano_left = mano_left.to(self.device)
        self.mano_right = mano_right.to(self.device)
        os.makedirs(cfg.train.output_dir, exist_ok=True)
        self.logger = setup_logger(
            os.path.join(cfg.train.output_dir, "log"),
            name="dir_tpu_torch.train")
        save_yaml(cfg, os.path.join(cfg.train.output_dir, "config.yaml"))
        self.start_epoch = 0
        self.best = float("inf")
        self.last_loss = float("nan")
        # per epoch: steps, seconds of the step loop, seconds of it spent
        # waiting on the loader
        self.epoch_stats = []

    # -- setup -------------------------------------------------------------

    def _host_dataset(self, split: str, **kw):
        c = self.cfg
        if c.data.packed_cache:
            from dir_tpu_torch.data.sample_cache import (
                CachedInterHandDataset as ds_cls)
        else:
            from dir_tpu_torch.data.interhand import (
                InterHandDataset as ds_cls)
        return ds_cls(c.data.data_dir, split, self.mano_left,
                      self.mano_right, img_size=c.data.img_size, **kw)

    def make_data(self):
        from dir_tpu_torch.data.loader import BatchLoader

        c = self.cfg
        if c.data.device_pipeline:
            from dir_tpu_torch.data.device_pipeline import (
                RawInterHandDataset, make_preprocess_fn)
            self.train_ds = RawInterHandDataset(
                c.data.data_dir, "train", img_size=c.data.img_size)
            self.test_ds = RawInterHandDataset(
                c.data.data_dir, "test", img_size=c.data.img_size)
            self.preprocess_train, self.preprocess_test = (
                make_preprocess_fn(self.mano_left, self.mano_right,
                                   img_size=c.data.img_size, train=train,
                                   device=self.device)
                for train in (True, False))
            self.aug_generator = torch.Generator(
                device=self.device).manual_seed(c.train.seed)
        else:
            self.train_ds = self._host_dataset(
                "train", seed=c.train.seed, native_warp=c.data.native_warp,
                wire8=c.data.wire8)
            self.test_ds = self._host_dataset("test", augment_train=False)
            self.preprocess_train = self.preprocess_test = None
        pin = self.device.type == "cuda"
        self.train_loader = BatchLoader(
            self.train_ds, c.train.batch_size, shuffle=True, drop_last=True,
            num_threads=c.data.num_workers, seed=c.train.seed,
            pin_memory=pin)
        self.test_loader = BatchLoader(
            self.test_ds, c.train.batch_size, shuffle=False, drop_last=False,
            pad_last=True, num_threads=c.data.num_workers, pin_memory=pin)
        self.logger.info("datasets: train=%d test=%d", len(self.train_ds),
                         len(self.test_ds))

    def make_model(self,
                   init_state_dict: Dict[str, torch.Tensor] | None = None):
        """Seeded random weights (``train.seed``), or ``init_state_dict``
        (the port's layout; a conv7 stem is rewritten for an s2d model),
        the optimizer and the steps; with ``continue_train`` the
        ``checkpoint`` directory's ``latest`` and ``meta.json`` resume the
        run."""
        c = self.cfg
        if ((c.train.steps_per_call > 1 or c.train.grad_accum > 1)
                and c.data.device_pipeline):
            raise ValueError(
                "steps_per_call / grad_accum > 1 require the host data "
                "path (stacked batches); disable data.device_pipeline")
        if c.train.steps_per_call > 1 and c.train.grad_accum > 1:
            raise ValueError(
                "steps_per_call and grad_accum are mutually exclusive")
        steps_per_epoch = opt_steps_per_epoch(
            len(self.train_ds), c.train.batch_size, c.train.grad_accum)

        model = DIR(c.model)
        if init_state_dict is None:
            weights.random_init_(model, c.train.seed)
        else:
            if c.model.backbone_stem == "s2d":
                init_state_dict = weights.adapt_stem_s2d(init_state_dict)
            model.load_state_dict(init_state_dict, strict=True)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(model, c.train, steps_per_epoch)
        self.sched = self.optimizer.lr_schedule
        self.state = create_train_state(model, self.optimizer)
        self.train_step = make_train_step(
            model, self.optimizer, c.model, self.mano_left, self.mano_right,
            unroll=c.train.steps_per_call, grad_accum=c.train.grad_accum,
            device=self.device)
        self.eval_step = make_eval_step(model, self.mano_left,
                                        self.mano_right, device=self.device)

        if c.train.continue_train and c.train.checkpoint:
            self.state = ckpt.restore_checkpoint(c.train.checkpoint,
                                                 self.state)
            meta = ckpt.load_meta(c.train.checkpoint)
            self.start_epoch = meta.get(
                "epoch", self.state.step // steps_per_epoch)
            self.best = meta.get("best", float("inf"))
            if AUG_STATE_KEY in meta and hasattr(self, "aug_generator"):
                self.aug_generator.set_state(torch.tensor(
                    meta[AUG_STATE_KEY], dtype=torch.uint8))
            self.logger.info("resumed from %s at epoch %d (best %.4f)",
                             c.train.checkpoint, self.start_epoch, self.best)

    # -- loops -------------------------------------------------------------

    def _call_batches(self, loader):
        """The batches of each train-step call: the loader's unchanged at
        steps_per_call = grad_accum = 1, else stacked groups of that many
        consecutive batches (leading axis = step or micro-batch); a trailing
        partial group is dropped, and logged."""
        spc = max(self.cfg.train.steps_per_call, self.cfg.train.grad_accum)
        if spc <= 1:
            yield from loader
            return
        buf = []
        for b in loader:
            buf.append(b)
            if len(buf) == spc:
                yield {k: _stack([x[k] for x in buf]) for k in buf[0]}
                buf = []
        if buf:
            self.logger.info(
                "dropped %d trailing batch(es) not filling a group of %d",
                len(buf), spc)

    def _save_meta(self, ckpt_dir: str, epoch: int):
        meta = {"epoch": epoch + 1, "best": self.best}
        if hasattr(self, "aug_generator"):
            meta[AUG_STATE_KEY] = self.aug_generator.get_state().tolist()
        ckpt.save_meta(ckpt_dir, meta)

    def train(self) -> float:
        c = self.cfg
        ckpt_dir = os.path.join(c.train.output_dir, "checkpoint")
        stacked = c.train.steps_per_call > 1 or c.train.grad_accum > 1
        for epoch in range(self.start_epoch, c.train.total_epochs):
            self.train_loader.set_epoch(epoch)
            t0 = last = time.perf_counter()
            wait, steps = 0.0, 0
            for it, batch in enumerate(self._call_batches(self.train_loader)):
                wait += time.perf_counter() - last
                if self.preprocess_train is not None:
                    dev_batch = self.preprocess_train(batch,
                                                      self.aug_generator)
                    dev_batch = {k: dev_batch[k] for k in _BATCH_KEYS}
                else:
                    dev_batch = {k: batch[k] for k in _BATCH_KEYS}
                self.state, loss_dict = self.train_step(self.state, dev_batch)
                steps += 1
                if it % c.train.print_every == 0:
                    # one device-to-host copy, summed in fp64 in key order
                    total = float(sum(torch.stack(
                        list(loss_dict.values())).double().cpu().tolist()))
                    self.last_loss = total
                    lr = self.sched(self.state.step)
                    self.logger.info("[epoch %d][it %d] lr %.6f loss %.4f",
                                     epoch, it, lr, total)
                    if not np.isfinite(total):
                        # stop before the divergence overwrites good
                        # checkpoints
                        raise FloatingPointError(
                            f"non-finite loss at epoch {epoch} it {it}; "
                            f"resume from {ckpt_dir}")
                if c.train.draw_every and it % c.train.draw_every == 0:
                    vis_batch = (dev_batch if self.preprocess_train is not None
                                 else batch)
                    if stacked:
                        vis_batch = {k: v[-1] for k, v in vis_batch.items()}
                    self._dump_vis(vis_batch, epoch, it)
                last = time.perf_counter()
            seconds = time.perf_counter() - t0
            self.epoch_stats.append({"epoch": epoch, "steps": steps,
                                     "seconds": seconds,
                                     "loader_wait_seconds": wait})
            self.logger.info(
                "epoch %d done in %.1fs (%d steps, loader wait %.1f ms a "
                "step)", epoch, seconds, steps, wait / max(steps, 1) * 1e3)
            ckpt.save_checkpoint(ckpt_dir, self.state, "latest")
            if (c.train.eval_every_epochs
                    and epoch % c.train.eval_every_epochs == 0):
                summary = self.evaluate()
                err = summary["joint_mean_all_mm"]
                if err < self.best:
                    self.best = err
                    ckpt.save_checkpoint(ckpt_dir, self.state, "best")
            self._save_meta(ckpt_dir, epoch)
        return self.best

    def _dump_vis(self, batch, epoch: int, it: int):
        """Skeleton overlays of GT against the prediction for the first
        sample of ``batch``: one eval-mode forward on the current weights."""
        from dir_tpu_torch.utils.visualize import save_prediction_grid

        vis_dir = os.path.join(self.cfg.train.output_dir, "vis")
        os.makedirs(vis_dir, exist_ok=True)
        img = decode_wire8({"img": torch.as_tensor(batch["img"]).to(
            self.device)})["img"]
        final = self.eval_step(self.state, img)["stages"][-1]
        size = self.cfg.data.img_size
        if "img_rgb" in batch:
            rgb = _numpy(batch["img_rgb"][0])
        else:
            rgb = np.full((size, size, 3), 127, np.float32)
        for side in ("left", "right"):
            gt = (_numpy(batch[f"joint_2d_{side}"][0])[:, :2] + 1) / 2 * size
            pd = (_numpy(final[f"pd_joint_uv_{side}"][0]) + 1) / 2 * size
            save_prediction_grid(
                os.path.join(vis_dir, f"e{epoch}_i{it}_{side}.png"),
                rgb.astype(np.uint8), gt, pd)

    def evaluate(self, all_stages: bool = False) -> Dict[str, float]:
        """The in-loop metric (``train.inloop_metric``: "benchmark", the
        offline eval's, or "online", the reference Trainer's) over the test
        split. The final refinement stage by default; with ``all_stages``
        every stage is logged and the final stage's summary returned."""
        dev = self.device
        jreg_l = evaluate.extended_j_regressor(self.mano_left)
        jreg_r = evaluate.extended_j_regressor(self.mano_right)
        online = self.cfg.train.inloop_metric == "online"
        num_stages = 3 if all_stages else 1
        accs = [dict() for _ in range(num_stages)]
        for batch in self.test_loader:
            n_valid = int(batch["_valid"])
            if self.preprocess_test is not None:
                batch = self.preprocess_test(batch)
            else:
                batch = {k: torch.as_tensor(batch[k]).to(dev,
                                                         non_blocking=True)
                         for k in _EVAL_KEYS}
            out = self.eval_step(self.state, batch["img"])
            b = batch["img"].shape[0]
            with torch.inference_mode(), no_tf32():
                valid = (torch.arange(b, device=dev) < n_valid).float()
                for si, stage in enumerate(out["stages"][-num_stages:]):
                    if online:
                        metrics = evaluate.online_batch_metrics(
                            stage["pd_joint_xyz_left"],
                            stage["pd_joint_xyz_right"],
                            stage["pd_mesh_xyz_left"],
                            stage["pd_mesh_xyz_right"],
                            batch["joint_3d_left"], batch["joint_3d_right"],
                            batch["mesh_3d_left"], batch["mesh_3d_right"],
                            valid)
                    else:
                        metrics = evaluate.batch_metrics(
                            stage["pd_mesh_xyz_left"],
                            stage["pd_mesh_xyz_right"], stage["pd_offset"],
                            batch["mesh_3d_left"], batch["mesh_3d_right"],
                            batch["camera"], jreg_l, jreg_r, valid,
                            root_joint=self.cfg.model.root_joint)
                    # one device-to-host copy per batch and stage
                    values = torch.stack(list(metrics.values())).cpu()
                    for k, v in zip(metrics, values.tolist()):
                        accs[si][k] = accs[si].get(k, 0.0) + v
        summ = evaluate.summarize_online if online else evaluate.summarize
        summaries = [summ(a) for a in accs]
        for si, summary in enumerate(summaries):
            tag = f"stage{si}" if all_stages else "final"
            for k, v in summary.items():
                self.logger.info("[%s] %s: %.4f", tag, k, v)
        return summaries[-1]
