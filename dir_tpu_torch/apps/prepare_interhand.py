"""Convert raw InterHand2.6M splits into the layout the port's data
pipeline reads (counterpart of ``tools/prepare_interhand.py``).

Usage:
    python -m dir_tpu_torch.apps.prepare_interhand \
        --data_path <raw InterHand2.6M root> --save_path ./data/interhand2.6m \
        --mano_path ./assets/mano [--splits train,test,val] \
        [--max_samples N] [--no-render]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Convert each split; returns ``{split: frames written}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_path", type=str, required=True)
    ap.add_argument("--save_path", type=str, default="./data/interhand2.6m")
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--splits", type=str, default="train,test,val")
    ap.add_argument("--max_samples", type=int, default=0)
    ap.add_argument("--no-render", dest="render", action="store_false")
    opt = ap.parse_args(argv)

    from dir_tpu_torch.data.prepare import prepare_split
    from dir_tpu_torch.mano.assets import load_mano_pair

    mano_l, mano_r = load_mano_pair(opt.mano_path, tips_style="data")
    written = {}
    for split in opt.splits.split(","):
        written[split] = prepare_split(
            opt.data_path, opt.save_path, split, mano_l, mano_r,
            max_samples=opt.max_samples or None, render=opt.render)
        print(f"{split}: wrote {written[split]} frames")
    return written


if __name__ == "__main__":
    main()
