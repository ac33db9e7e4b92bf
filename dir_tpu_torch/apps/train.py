"""Training entry point of the port (counterpart of ``apps/train.py``;
reference: train.py).

Usage:
    python -m dir_tpu_torch.apps.train --data_dir ./data/interhand2.6m \
        --mano_path ./assets/mano --output ./output/dir_tpu_torch \
        [--batch_size 64] [--epochs 50] [--lr 5e-4] [--dtype bfloat16] \
        [--resume <ckpt_dir>] [--imagenet <resnet50 state-dict .pth>] \
        [--device cpu]

Every knob is a flag over the typed Config, or a YAML file (``--config``).
One process trains on one device: the data-parallel mesh (``--devices``
above 1) is not ported yet.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", type=str, default="./data/interhand2.6m")
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--synthetic_mano", action="store_true",
                    help="use the synthetic MANO pair (smoke runs)")
    ap.add_argument("--output", type=str, default="./output/dir_tpu_torch")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--lr_scheduler", type=str, default="cosine",
                    choices=["cosine", "step"])
    ap.add_argument("--root_joint", type=int, default=0)
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3")
    ap.add_argument("--img_size", type=int, default=256)
    ap.add_argument("--bone_splat", action="store_true",
                    help="the materialized bone splat through its kernel "
                         "(K5) instead of the factored splat conv")
    ap.add_argument("--fused_bottleneck", action="store_true",
                    help="the fused bottleneck kernels (K1, and K2 with "
                         "--fused_l2_bands) in the in-loop eval")
    ap.add_argument("--fused_l2_bands", type=int, default=0)
    ap.add_argument("--seed", type=int, default=25)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--resume", type=str, default="")
    ap.add_argument("--imagenet", type=str, default="",
                    help="torchvision resnet50 state-dict file to seed the "
                         "backbone (models/dir.py:490-498 equivalent)")
    ap.add_argument("--devices", type=int, default=0,
                    help="data-parallel devices (0 or 1: one)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--config", type=str, default="",
                    help="YAML config; the flags above then set nothing")
    ap.add_argument("--phase", type=str, default="train",
                    choices=["train", "test"],
                    help="'test' runs the metric eval only (reference "
                         "Tester, train.py:246-336)")
    ap.add_argument("--device_pipeline", action="store_true",
                    help="fused on-device preprocessing (host decodes only)")
    ap.add_argument("--packed_cache", action="store_true",
                    help="serve samples from the packed decode-once mmap "
                         "cache; the hot loop pays augmentation only")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="micro-batches accumulated into one optimizer "
                         "step (effective batch = batch_size * this)")
    opt = ap.parse_args(argv)
    if opt.devices > 1:
        ap.error(f"--devices {opt.devices}: the port trains on one device; "
                 "data parallelism over a mesh (ROADMAP A12, "
                 "dir_tpu/parallel/mesh.py) is not ported yet")
    return opt


def main(argv=None) -> float:
    """Train (or with ``--phase test`` evaluate); returns the best (or the
    final) MPJPE in mm."""
    opt = parse_args(argv)

    import torch

    from dir_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      TrainConfig, load_yaml)
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)
    from dir_tpu_torch.train import checkpoint as ckpt
    from dir_tpu_torch.train.trainer import Trainer
    from dir_tpu_torch.weights import adapt_stem_s2d

    if opt.config:
        cfg = load_yaml(opt.config)
    else:
        cfg = Config(
            model=ModelConfig(
                root_joint=opt.root_joint, dtype=opt.dtype,
                backbone_layers=tuple(
                    int(x) for x in opt.backbone_layers.split(",")),
                fused_bottleneck_eval=opt.fused_bottleneck,
                fused_l2_bands=opt.fused_l2_bands,
                fused_splat_conv=not opt.bone_splat,
                use_pallas_splat=opt.bone_splat),
            data=DataConfig(data_dir=opt.data_dir, img_size=opt.img_size,
                            num_workers=opt.num_workers,
                            device_pipeline=opt.device_pipeline,
                            packed_cache=opt.packed_cache),
            train=TrainConfig(batch_size=opt.batch_size,
                              total_epochs=opt.epochs, lr=opt.lr,
                              lr_scheduler=opt.lr_scheduler, seed=opt.seed,
                              output_dir=opt.output,
                              checkpoint=opt.resume,
                              continue_train=bool(opt.resume),
                              grad_accum=opt.grad_accum),
            mano_assets=opt.mano_path)
    if opt.synthetic_mano:
        mano_r = synthetic_mano("right", seed=0)
        mano_l = fix_left_shapedirs(synthetic_mano("left", seed=0), mano_r)
    else:
        mano_l, mano_r = load_mano_pair(cfg.mano_assets)

    trainer = Trainer(cfg, mano_l, mano_r, device=opt.device)
    trainer.make_data()
    trainer.make_model()
    if opt.imagenet:
        sd = torch.load(opt.imagenet, map_location="cpu",
                        weights_only=False)
        backbone = trainer.state.model.backbone
        sd = ckpt.import_torch_resnet50(sd)
        if cfg.model.backbone_stem == "s2d":
            sd = adapt_stem_s2d(sd)
        with torch.no_grad():
            backbone.load_state_dict(ckpt.prune_to_target(sd, backbone),
                                     strict=True)
        trainer.logger.info("seeded backbone from %s", opt.imagenet)

    if opt.phase == "test":
        summary = trainer.evaluate(all_stages=True)
        trainer.logger.info("eval done; final MPJPE %.4f mm",
                            summary["joint_mean_all_mm"])
        return summary["joint_mean_all_mm"]
    best = trainer.train()
    trainer.logger.info("training done; best MPJPE %.4f mm", best)
    return best


if __name__ == "__main__":
    main()
