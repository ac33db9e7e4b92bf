"""Sustained end-to-end train throughput of the port through the real
input pipeline (counterpart of ``tools/bench_train_pipeline.py``).

The train step's rate on batches already on the card (``dir_tpu_torch.bench``)
is not what the system sustains when the host loader feeds it. This tool
measures both host paths of ``data/loader.py``:

  a) jpg:    ``InterHandDataset``: JPEG decode, numpy MANO ground truth
             and augmentation per sample, every epoch
  b) cached: ``CachedInterHandDataset``: the packed decode-once cache
             (``data/sample_cache.py``); the hot loop pays augmentation only

and prints the host-only loader rate of each path first (no device in the
loop), so the host budget is explicit: cores_needed = device_img_s /
host_img_s_per_core. The data is synthetic, in the reference's on-disk
layout (``data/synthetic.py``), written to a temporary directory.

Usage:
    python -m dir_tpu_torch.tools.bench_train_pipeline [--device [cpu]] \
        [--steps 20] [--batch 64] [--samples 256] [--threads 4] \
        [--paths jpg,cached]

``--device`` feeds the train step on the card (``--device cpu``: on the
CPU, for the tests): the default flagship of ``Config()`` (fp32, the
default decoder) with seeded random weights, AdamW, ``Trainer``'s pinned
batches. Without it, host-only loader rates.
"""

from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None) -> dict:
    """Print the lines; return ``{"host": {path: img/s}, "fed": {path:
    img/s}}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--samples", type=int, default=256,
                    help="on-disk synthetic dataset size")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    help="feed the real train step (on the card; "
                         "'--device cpu' on the CPU)")
    ap.add_argument("--paths", default="jpg,cached")
    opt = ap.parse_args(argv)

    from dir_tpu_torch.data import synthetic
    from dir_tpu_torch.data.interhand import InterHandDataset
    from dir_tpu_torch.data.loader import BatchLoader
    from dir_tpu_torch.data.sample_cache import (CachedInterHandDataset,
                                                 build_cache)
    from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano

    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    paths = opt.paths.split(",")
    rates = {"host": {}, "fed": {}}
    with tempfile.TemporaryDirectory(prefix="bench_train_pipe_") as tmp:
        t0 = time.perf_counter()
        synthetic.generate(tmp, left, right, split="train",
                           num_samples=opt.samples)
        print(f"synthetic dataset: {opt.samples} samples at {tmp} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        t0 = time.perf_counter()
        build_cache(tmp, "train", left, right, log_every=0)
        t_build = time.perf_counter() - t0
        print(f"packed cache built in {t_build:.1f}s "
              f"({t_build / opt.samples * 1e3:.1f} ms/sample one-time)",
              flush=True)

        def make_loader(path, pin_memory=False):
            cls = (CachedInterHandDataset if path == "cached"
                   else InterHandDataset)
            return BatchLoader(cls(tmp, "train", left, right), opt.batch,
                               shuffle=True, drop_last=True,
                               num_threads=opt.threads,
                               pin_memory=pin_memory)

        # --- host-only loader rate ---------------------------------------
        for path in paths:
            loader = make_loader(path)
            for _ in loader:  # warm-up epoch: page cache, thread pool
                pass
            n = 0
            t0 = time.perf_counter()
            for _ in loader:
                n += opt.batch
            dt = time.perf_counter() - t0
            rates["host"][path] = n / dt
            print(f"host-only  {path:7s}: {n / dt:8.1f} img/s "
                  f"({dt / n * 1e3:6.2f} ms/img, {opt.threads} threads)",
                  flush=True)

        if opt.device is not None:
            rates["fed"] = _loader_fed(opt, paths, make_loader, left, right)
    return rates


def _loader_fed(opt, paths, make_loader, left, right) -> dict:
    """The loader-fed train step on ``opt.device`` for each path."""
    from dir_tpu_torch.bench import synchronize
    from dir_tpu_torch.config import Config
    from dir_tpu_torch.device import resolve_device
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step
    from dir_tpu_torch.weights import random_init_

    dev = resolve_device(opt.device)
    cfg = Config()
    model = random_init_(DIR(cfg.model), seed=0)
    optimizer = make_optimizer(model, cfg.train, steps_per_epoch=1000)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, optimizer, cfg.model, left, right,
                           device=dev)
    drop = ("img_rgb", "camera", "_valid")

    def device_batch(b):
        return {k: v for k, v in b.items() if k not in drop}

    rates = {}
    for path in paths:
        loader = make_loader(path, pin_memory=dev.type == "cuda")
        it = iter(loader)
        state, _ = step(state, device_batch(next(it)))  # cuDNN's choices
        synchronize(dev)
        done = 0
        t0 = time.perf_counter()
        while done < opt.steps:
            try:
                b = device_batch(next(it))
            except StopIteration:
                it = iter(loader)
                continue
            state, _ = step(state, b)
            done += 1
        synchronize(dev)
        dt = time.perf_counter() - t0
        rates[path] = done * opt.batch / dt
        print(f"loader-fed {path:7s}: {rates[path]:8.1f} img/s sustained "
              f"({dt / done * 1e3:6.1f} ms/step, {done} steps, "
              f"backend={dev.type})", flush=True)
    return rates


if __name__ == "__main__":
    main()
