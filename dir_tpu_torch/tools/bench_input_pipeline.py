"""Input-pipeline benchmark of the port: host cv2 warp against the host
native warp against the device pipeline (counterpart of
``tools/bench_input_pipeline.py``).

Measures per-sample latency and samples per second of the three training
input paths on synthetic data in the reference's on-disk layout
(``data/synthetic.py``):

  a) host pipeline, cv2 warp (the default)
  b) host pipeline, native C++ warp (``data.native_warp=True``,
     ``data/native.py``)
  c) the on-device pipeline (``data.device_pipeline=True``,
     ``data/device_pipeline.py``), with ``--device``: on the card
     (``--device cpu``: on the CPU, for the tests)

Usage:
    python -m dir_tpu_torch.tools.bench_input_pipeline [--device [cpu]] \
        [--n 64] [--batch 16]
"""

from __future__ import annotations

import argparse
import tempfile
import time


def main(argv=None) -> dict:
    """Print the lines; return the seconds per sample of each path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64,
                    help="samples per measurement")
    ap.add_argument("--device", nargs="?", const="cuda", default=None,
                    help="also benchmark the on-device pipeline (on the "
                         "card; '--device cpu' on the CPU)")
    ap.add_argument("--batch", type=int, default=16)
    opt = ap.parse_args(argv)

    from dir_tpu_torch.data import synthetic
    from dir_tpu_torch.data.interhand import InterHandDataset
    from dir_tpu_torch.mano.assets import fix_left_shapedirs, synthetic_mano

    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    n_disk = 16
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench_input_") as tmp:
        synthetic.generate(tmp, left, right, split="train",
                           num_samples=n_disk)
        print(f"synthetic dataset: {n_disk} samples at {tmp}", flush=True)

        def bench_host(native_warp: bool) -> float:
            ds = InterHandDataset(tmp, "train", left, right,
                                  native_warp=native_warp)
            for i in range(4):  # warm-up (page cache, library load)
                ds[i % n_disk]
            t0 = time.perf_counter()
            for i in range(opt.n):
                ds[i % n_disk]
            return (time.perf_counter() - t0) / opt.n

        out["cv2"] = bench_host(False)
        out["native"] = bench_host(True)
        print(f"host cv2 warp:    {out['cv2'] * 1e3:7.2f} ms/sample "
              f"({1 / out['cv2']:7.1f} samples/s/worker)", flush=True)
        print(f"host native warp: {out['native'] * 1e3:7.2f} ms/sample "
              f"({1 / out['native']:7.1f} samples/s/worker)", flush=True)

        if opt.device is not None:
            out["device"] = _device_pipeline(opt, tmp, left, right)
    return out


def _device_pipeline(opt, tmp, left, right) -> float:
    import torch

    from dir_tpu_torch.bench import synchronize
    from dir_tpu_torch.data.device_pipeline import (RawInterHandDataset,
                                                    make_preprocess_fn)
    from dir_tpu_torch.data.loader import BatchLoader
    from dir_tpu_torch.device import resolve_device

    dev = resolve_device(opt.device)
    ds = RawInterHandDataset(tmp, "train")
    pre = make_preprocess_fn(left, right, train=True, device=dev)
    loader = BatchLoader(ds, opt.batch, shuffle=False, drop_last=True,
                         num_threads=2)
    raw = {k: v for k, v in next(iter(loader)).items() if k != "_valid"}
    gen = torch.Generator(device=dev).manual_seed(0)
    pre(raw, gen)  # warm-up
    synchronize(dev)
    iters = max(1, opt.n // opt.batch)
    t0 = time.perf_counter()
    for _ in range(iters):
        pre(raw, gen)
    synchronize(dev)
    t_dev = (time.perf_counter() - t0) / (iters * opt.batch)
    print(f"device pipeline:  {t_dev * 1e3:7.2f} ms/sample "
          f"({1 / t_dev:7.1f} samples/s, backend={dev.type}; host JPEG "
          "decode excluded)", flush=True)
    return t_dev


if __name__ == "__main__":
    main()
