"""Export the port's inference model as a serving artifact
(counterpart of ``apps/export.py``).

The eval forward is traced once with ``torch.export`` (weights and MANO
tensors embedded, the kernels as the ``torch.ops.dir_tpu.*`` ops it names)
and written behind a magic header (``serve.export_infer``); the serving
side reloads it with ``serve.load`` and no model code
(``apps/serve_http.py``).

Usage:
    python -m dir_tpu_torch.apps.export --model <ckpt|.pth|random> \
        --mano_path ./assets/mano --out dir.pt2 \
        [--batch 256 | --batch 0 for symbolic] [--dtype bfloat16] \
        [--fused_bottleneck [--fused_l2_bands 4]] [--bone_splat] \
        [--quant_backbone --quant_decoder --quant_aux --quant_static \
         --calib_npy calib.npy [--quant_fused [--quant_fused_l2_bands 4]]] \
        [--device cpu] [--check]

The artifact holds constants made on the device it was traced on: export
on the device that serves it (CUDA unless ``--device`` names another).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# --check: the reloaded artifact against the live model, max |err| of the
# final stage's left mesh in metres (the JAX package's bound); measured 0 on
# the CPU, where both run the same ops
CHECK_TOL_M = 1e-3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", type=str, default="random",
                    help="port checkpoint, reference .pth, or 'random'")
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--synthetic_mano", action="store_true")
    ap.add_argument("--out", type=str, default="./dir.pt2")
    ap.add_argument("--batch", type=int, default=0,
                    help="batch size to specialize for; 0 = symbolic "
                         "(one artifact serves every batch size)")
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3")
    ap.add_argument("--stem", type=str, default="conv7",
                    choices=["conv7", "s2d"])
    ap.add_argument("--fused_bottleneck", action="store_true",
                    help="fused bottleneck kernel at layer1 (K1)")
    ap.add_argument("--fused_l2_bands", type=int, default=0,
                    help="with --fused_bottleneck, also layer2 (K2)")
    ap.add_argument("--bone_splat", action="store_true",
                    help="the materialized bone splat through its kernel "
                         "(K5) instead of the factored splat conv")
    ap.add_argument("--quant_backbone", action="store_true",
                    help="embed the int8 backbone path")
    ap.add_argument("--quant_decoder", action="store_true",
                    help="embed the int8 decoder-Residual path")
    ap.add_argument("--quant_aux", action="store_true",
                    help="embed the int8 aux-conv path (stem, "
                         "AttentionPool, fusion/head convs)")
    ap.add_argument("--quant_static", action="store_true",
                    help="static activation scales; calibrated on "
                         "--calib_npy images (or one random batch with a "
                         "warning) and embedded in the artifact")
    ap.add_argument("--quant_fused", action="store_true",
                    help="with --quant_static, the fused int8 bottleneck "
                         "(K3) at layer1")
    ap.add_argument("--quant_fused_l2_bands", type=int, default=0,
                    help="with --quant_fused, also layer2")
    ap.add_argument("--calib_npy", type=str, default="",
                    help=".npy of (N, 256, 256, 3) float32 calibration "
                         "images for --quant_static")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device to trace and serve on "
                         "(default: cuda)")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and hold its outputs against "
                         "the live model on a random batch")
    opt = ap.parse_args(argv)
    if opt.quant_static and not (opt.quant_backbone or opt.quant_decoder
                                 or opt.quant_aux):
        ap.error("--quant_static requires --quant_backbone, "
                 "--quant_decoder and/or --quant_aux")
    return opt


def main(argv=None) -> dict:
    """Export as the flags say; returns the artifact's path, size in bytes,
    the op nodes its graph names and, with ``--check``, the round trip's
    max |err|."""
    opt = parse_args(argv)

    from dir_tpu_torch import serve
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.device import resolve_device
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.train.checkpoint import load_model_weights
    from dir_tpu_torch.utils.logger import setup_logger

    dev = resolve_device(opt.device)
    logger = setup_logger(name="dir_tpu_torch.export")
    if opt.synthetic_mano:
        mano_r = synthetic_mano("right", seed=0)
        mano_l = fix_left_shapedirs(synthetic_mano("left", seed=0), mano_r)
    else:
        mano_l, mano_r = load_mano_pair(opt.mano_path)
    mano_l, mano_r = mano_l.to(dev), mano_r.to(dev)
    cfg = ModelConfig(
        dtype=opt.dtype,
        backbone_layers=tuple(int(x) for x in opt.backbone_layers.split(",")),
        backbone_stem=opt.stem, fused_bottleneck_eval=opt.fused_bottleneck,
        fused_l2_bands=opt.fused_l2_bands,
        fused_splat_conv=not opt.bone_splat, use_pallas_splat=opt.bone_splat,
        quant_backbone_eval=opt.quant_backbone,
        quant_decoder_eval=opt.quant_decoder, quant_aux_eval=opt.quant_aux,
        quant_static=opt.quant_static, quant_fused=opt.quant_fused,
        quant_fused_l2_bands=opt.quant_fused_l2_bands)
    model = DIR(cfg)
    logger.info("weights: %s (%s)", load_model_weights(model, opt.model),
                opt.model)
    model = model.to(dev).eval()

    if opt.quant_static:
        if opt.calib_npy:
            imgs = np.load(opt.calib_npy).astype(np.float32)
        else:
            logger.warning("no --calib_npy: calibrating static int8 scales "
                           "on ONE RANDOM batch; fine for smoke tests, "
                           "wrong for production artifacts")
            imgs = np.random.RandomState(0).randn(
                2, 256, 256, 3).astype(np.float32)
        serve.calibrate_static_scales(model, imgs, mano_l, mano_r)
        logger.info("calibrated static int8 scales on %d images",
                    imgs.shape[0])

    batch = opt.batch if opt.batch > 0 else None
    logger.info("tracing on %s (batch=%s)...", dev, batch or "symbolic")
    program = serve.export_program(model, mano_l, mano_r, batch_size=batch)
    blob = serve.serialize(program)
    serve.save(opt.out, blob)
    counts = serve.op_counts(program)
    logger.info("wrote %s (%.1f MB); kernel ops in the graph: %s", opt.out,
                len(blob) / 1e6, counts)
    result = {"path": opt.out, "bytes": len(blob), "ops": counts}

    if opt.check:
        fn = serve.load(opt.out)
        b = batch or 2
        img = np.random.RandomState(0).randn(b, 256, 256, 3).astype(
            np.float32)
        got = fn(img)["stages"][-1]["pd_mesh_xyz_left"]
        want = serve.make_infer(model, mano_l, mano_r)(img)["stages"][-1][
            "pd_mesh_xyz_left"]
        err = float((got - want).abs().max())
        logger.info("roundtrip max |err| = %.2e", err)
        result["check_err"] = err
        if not err < CHECK_TOL_M:
            raise SystemExit("roundtrip check FAILED")
    return result


if __name__ == "__main__":
    main()
