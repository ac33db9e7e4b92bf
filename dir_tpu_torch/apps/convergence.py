"""Training convergence of the port on one fixed batch (counterpart of
``tools/convergence_tpu.py``).

Runs ``--steps`` AdamW steps of the flagship train step (bf16 trunk, MANO at
``mano_precision="high"``, the default decoder) on one synthetic
MANO-consistent batch of ``--batch`` samples, written by the port's
synthetic writer and read back through the dataset with augmentation off.
The lr is the constant 5e-4 (``steps_per_epoch=1000`` keeps the
epoch-quantized schedule at epoch 0). Overfitting one batch is the
optimizer's sanity check: a wiring fault shows as a flat or exploding
curve. The weights are seeded random.

Usage:
    python -m dir_tpu_torch.apps.convergence [--steps 320] [--batch 64] \
        [--backbone_layers 3,4,6,3] [--device cpu]

Prints a ``step=... loss=...`` line every 8 steps and a closing JSON line
with ``first_loss``, ``final_loss``, ``ms_per_step_median`` (after the first
two steps, host clock to the loss read) and ``steps``. Runs on CUDA unless
``--device`` names another device; exits 1 on a non-finite loss.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

PRINT_EVERY = 8
WARMUP = 2


def main(argv=None) -> dict:
    """Train and return the closing summary."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=320)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    opt = ap.parse_args(argv)

    import torch

    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.data import synthetic
    from dir_tpu_torch.data.interhand import InterHandDataset
    from dir_tpu_torch.data.loader import collate
    from dir_tpu_torch.device import resolve_device
    from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.models.losses import total_loss
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step
    from dir_tpu_torch.weights import random_init_

    dev = resolve_device(opt.device)
    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    with tempfile.TemporaryDirectory(prefix="dir_tpu_torch_conv_") as tmp:
        synthetic.generate(tmp, left, right, split="train",
                           num_samples=opt.batch)
        ds = InterHandDataset(tmp, "train", left, right,
                              augment_train=False)
        host = collate([ds[i] for i in range(opt.batch)])
    batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()
             if k != "_valid"}

    cfg = ModelConfig(dtype="bfloat16", mano_precision="high",
                      backbone_layers=tuple(
                          int(x) for x in opt.backbone_layers.split(",")))
    model = random_init_(DIR(cfg), seed=0)
    optimizer = make_optimizer(model, TrainConfig(), steps_per_epoch=1000)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer, cfg, left, right, device=dev)

    curve, times = [], []
    for i in range(opt.steps):
        t0 = time.perf_counter()
        state, loss_dict = step(state, batch)
        loss = float(total_loss(loss_dict))     # waits for the step
        times.append((time.perf_counter() - t0) * 1e3)
        curve.append(loss)
        if not np.isfinite(loss):
            print(json.dumps({"ok": False, "error": "non-finite loss",
                              "step": i + 1}), flush=True)
            raise SystemExit(1)
        if (i + 1) % PRINT_EVERY == 0 or i + 1 == opt.steps:
            print(f"step={i + 1:4d} loss={loss:.4f} ({times[-1]:.1f} ms/step)",
                  flush=True)
    timed = times[WARMUP:] or times
    summary = {"ok": bool(curve[-1] < curve[0]), "steps": opt.steps,
               "batch": opt.batch, "device": str(dev),
               "first_loss": curve[0], "final_loss": curve[-1],
               "loss_min": min(curve),
               "ms_per_step_median": float(np.median(timed))}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
