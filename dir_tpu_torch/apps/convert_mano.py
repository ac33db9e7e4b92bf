"""Convert the official MANO pickles to the ``.npz`` assets the port loads
(counterpart of ``tools/convert_mano.py``).

Usage:
    python -m dir_tpu_torch.apps.convert_mano --mano_dir <dir with MANO_*.pkl> \
        [--out ./assets/mano]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> list:
    """Convert both hands; returns the paths written."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mano_dir", type=str, required=True)
    ap.add_argument("--out", type=str, default="./assets/mano")
    opt = ap.parse_args(argv)

    from dir_tpu_torch.mano.assets import convert_mano_pkl

    os.makedirs(opt.out, exist_ok=True)
    written = []
    for side in ("left", "right"):
        src = os.path.join(opt.mano_dir, f"MANO_{side.upper()}.pkl")
        dst = os.path.join(opt.out, f"MANO_{side.upper()}.npz")
        convert_mano_pkl(src, dst, side)
        print(f"wrote {dst}")
        written.append(dst)
    return written


if __name__ == "__main__":
    main()
