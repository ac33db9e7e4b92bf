"""Convert DIR checkpoints between the reference's torch format and the
port's (counterpart of ``tools/convert_checkpoint.py``).

Usage:
    # the reference's released DIR.pth -> a port checkpoint
    python -m dir_tpu_torch.apps.convert_checkpoint --torch DIR.pth \
        --out ./ckpt/dir/latest

    # a port checkpoint -> a .pth the reference loads (its "net" entry)
    python -m dir_tpu_torch.apps.convert_checkpoint --checkpoint ./ckpt/dir \
        --name latest --out DIR_export.pth

A port checkpoint is ``<dir>/<name>.pt`` as the port's Trainer writes it
(``train/checkpoint.py``), already in the reference's parameter layout.
There is no reader for the JAX package's orbax checkpoints here: it would
need JAX. Export those with ``tools/convert_checkpoint.py --orbax`` to a
``.pth`` first, and convert that with ``--torch``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> str:
    """Run one conversion; returns the path written."""
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="No orbax reader: convert a JAX checkpoint to .pth with "
               "tools/convert_checkpoint.py --orbax first, then use --torch.")
    ap.add_argument("--torch", type=str, default="",
                    help="a reference .pth to import")
    ap.add_argument("--checkpoint", type=str, default="",
                    help="a port checkpoint directory to export")
    ap.add_argument("--name", type=str, default="latest",
                    help="the checkpoint's name in --checkpoint")
    ap.add_argument("--out", type=str, required=True,
                    help="--torch: <dir>/<name> of the port checkpoint; "
                         "--checkpoint: the .pth to write")
    ap.add_argument("--mano_path", type=str, default="./assets/mano",
                    help="accepted as tools/convert_checkpoint.py takes it; "
                         "the port builds the model's shapes without MANO")
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3")
    opt = ap.parse_args(argv)
    if bool(opt.torch) == bool(opt.checkpoint):
        ap.error("exactly one of --torch / --checkpoint is required")

    import torch

    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.train import checkpoint as ckpt
    from dir_tpu_torch.train.state import create_train_state, make_optimizer

    cfg = ModelConfig(backbone_layers=tuple(
        int(x) for x in opt.backbone_layers.split(",")))
    if opt.torch:
        model = DIR(cfg)
        model.load_state_dict(ckpt.prune_to_target(
            ckpt.load_torch_dir_checkpoint(opt.torch, cfg.backbone_layers),
            model), strict=True)
        state = create_train_state(model, make_optimizer(
            model, TrainConfig(), steps_per_epoch=1))
        name = os.path.basename(opt.out)
        path = ckpt.save_checkpoint(
            os.path.dirname(opt.out) or ".", state,
            name[:-3] if name.endswith(".pt") else name)
        print(f"wrote port checkpoint {path}")
        return path
    with torch.device("meta"):
        target = DIR(cfg)       # shapes only, for the coverage check
    sd = ckpt.prune_to_target(
        ckpt.load_checkpoint_weights(opt.checkpoint, opt.name), target)
    torch.save({"net": {k: v.contiguous() for k, v in sd.items()}}, opt.out)
    print(f"wrote torch checkpoint {opt.out}")
    return opt.out


if __name__ == "__main__":
    main()
