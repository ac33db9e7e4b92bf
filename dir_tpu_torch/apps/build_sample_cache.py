"""Build the packed decode-once sample cache of a prepared split
(counterpart of ``tools/build_sample_cache.py``).

One pass of JPEG decode and MANO ground truth over the split, written as
mmap-able arrays under ``<data_path>/<split>/packed/``; train afterwards
with ``data.packed_cache`` (``data/sample_cache.py`` has the layout).

Usage:
    python -m dir_tpu_torch.apps.build_sample_cache --data_path DIR \
        [--split train] [--mano_path DIR | --synthetic_mano] [--img_size 256]
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> str:
    """Build the cache; returns its directory."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--split", default="train",
                    choices=("train", "test", "val"))
    ap.add_argument("--mano_path", default=None,
                    help="directory with MANO_{LEFT,RIGHT}.pkl")
    ap.add_argument("--synthetic_mano", action="store_true")
    ap.add_argument("--img_size", type=int, default=256)
    opt = ap.parse_args(argv)

    import numpy as np

    from dir_tpu_torch.data.sample_cache import build_cache
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)

    if opt.synthetic_mano:
        right = synthetic_mano("right", seed=0)
        left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    else:
        left, right = load_mano_pair(opt.mano_path)
    t0 = time.perf_counter()
    out = build_cache(opt.data_path, opt.split, left, right,
                      img_size=opt.img_size)
    dt = time.perf_counter() - t0
    n = np.load(os.path.join(out, "gt.npy"), mmap_mode="r").shape[0]
    print(f"built {out}: {n} samples in {dt:.1f}s "
          f"({dt / max(n, 1) * 1e3:.1f} ms/sample one-time)")
    return out


if __name__ == "__main__":
    main()
