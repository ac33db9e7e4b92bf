"""Offline benchmark evaluation on InterHand2.6M with the port
(counterpart of ``apps/eval.py``).

Usage:
    python -m dir_tpu_torch.apps.eval --model <ckpt_dir>/<name> \
        --data_path ./data/interhand2.6m --mano_path ./assets/mano \
        [--bs 64] [--root_joint 0] [--no-scale] [--out <dir>] \
        [--dtype bfloat16 --fused_bottleneck] [--device cpu] \
        [--devices N] [--unroll K]

``--model`` takes a port checkpoint (``<ckpt_dir>/<name>``, the
``<name>.pt`` that the port's Trainer writes, or a checkpoint directory,
whose ``latest`` is read), the reference's released ``.pth`` or ``random``
(seeded random weights, for smoke runs). Prints the metric block and a ``SUMMARY {json}`` line and writes
the per-sample error dumps. With ``--resume_every N`` the accumulators are
saved every N batches to ``<out>/eval_resume.<config hash>.npz``, and a
rerun with the same configuration resumes from there. Runs on CUDA unless
``--device`` names another device.

``--devices N`` evaluates data-parallel over N ranks, one process each
(started here, or by ``torchrun --nproc_per_node N -m
dir_tpu_torch.apps.eval``): each rank runs its block of every batch, the
per-sample errors are gathered in dataset order and rank 0 writes them, so
the outputs are those of ``--devices 1``. ``--unroll K`` runs K consecutive
batches per call (their forwards queued back to back, the errors then
read), with per-batch outputs unchanged.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

_DUMP_KEYS = ("joint_left", "joint_right", "vert_left", "vert_right",
              "joint2d_left", "joint2d_right", "vert2d_left", "vert2d_right",
              "root", "joints_xyz_left", "joints_xyz_right")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", type=str, default="random")
    ap.add_argument("--data_path", type=str, default="./data/interhand2.6m")
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--root_joint", type=int, default=0)  # 0 wrist, 9 MCP
    ap.add_argument("--no-scale", dest="scale", action="store_false")
    ap.add_argument("--out", type=str, default="./result/dir_tpu_torch")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3",
                    help="comma-separated resnet stage depths")
    ap.add_argument("--synthetic_mano", action="store_true",
                    help="use the synthetic MANO pair (smoke runs)")
    ap.add_argument("--stage", type=int, default=-1,
                    help="stage to evaluate (-1: the final refinement)")
    ap.add_argument("--stem", type=str, default="conv7",
                    choices=["conv7", "s2d"])
    ap.add_argument("--fused_bottleneck", action="store_true",
                    help="fused bottleneck kernel at layer1 (bf16 trunk)")
    ap.add_argument("--fused_l2_bands", type=int, default=0,
                    help="with --fused_bottleneck, also layer2 as N bands")
    ap.add_argument("--quant_backbone", action="store_true",
                    help="int8 backbone convs (a serving option)")
    ap.add_argument("--quant_decoder", action="store_true",
                    help="int8 decoder Residual convs")
    ap.add_argument("--quant_aux", action="store_true",
                    help="int8 auxiliary convs (stem, pools, heads)")
    ap.add_argument("--quant_static", action="store_true",
                    help="static activation scales, calibrated on the "
                         "first batch")
    ap.add_argument("--quant_fused", action="store_true",
                    help="with --quant_static, the fused int8 bottleneck "
                         "kernel at layer1")
    ap.add_argument("--quant_fused_l2_bands", type=int, default=0,
                    help="with --quant_fused, also layer2 as N bands")
    ap.add_argument("--resume_every", type=int, default=200,
                    help="save the accumulators every N batches and resume "
                         "from them on a rerun (0 disables)")
    ap.add_argument("--unroll", type=int, default=1,
                    help="batches per call (per-batch outputs unchanged)")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks, one process each; each batch "
                         "is split over them (per-sample outputs unchanged)")
    opt = ap.parse_args(argv)
    if opt.quant_static and not (opt.quant_backbone or opt.quant_decoder
                                 or opt.quant_aux):
        ap.error("--quant_static requires --quant_backbone, "
                 "--quant_decoder and/or --quant_aux")
    if opt.unroll < 1 or opt.devices < 1:
        ap.error("--unroll and --devices must be at least 1")
    if opt.devices > 1:
        if opt.bs % opt.devices:
            ap.error("--bs must be divisible by --devices")
        if opt.fused_bottleneck:
            # as dir_tpu refuses it: its Pallas kernels do not partition
            # over a mesh
            ap.error("--devices does not compose with --fused_bottleneck")
    return opt


def main(argv=None) -> dict:
    opt = parse_args(argv)

    import torch

    from dir_tpu_torch.parallel import launch, mesh as pmesh

    mesh = None
    if pmesh.launched():
        pmesh.init_distributed(device=opt.device)
        mesh = pmesh.make_mesh(opt.devices, device=opt.device)
    elif opt.devices > 1:
        return launch.run_ranks("dir_tpu_torch.apps.eval",
                                sys.argv[1:] if argv is None else argv,
                                opt.devices)
    try:
        return _evaluate(opt, mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _evaluate(opt, mesh) -> dict:
    import torch

    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.data.interhand import InterHandDataset
    from dir_tpu_torch.data.loader import BatchLoader
    from dir_tpu_torch.device import no_tf32, resolve_device
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.parallel.mesh import replicate, shard_batch
    from dir_tpu_torch.serve import calibrate_static_scales, make_infer
    from dir_tpu_torch.train import evaluate
    from dir_tpu_torch.train.checkpoint import load_model_weights
    from dir_tpu_torch.utils.logger import setup_logger

    dev = mesh.device if mesh is not None else resolve_device(opt.device)
    lead = mesh is None or mesh.rank == 0
    logger = setup_logger(name="dir_tpu_torch.eval")
    if not lead:
        logger.setLevel("WARNING")
    os.makedirs(opt.out, exist_ok=True)

    if opt.synthetic_mano:
        mano_r = synthetic_mano("right", seed=0)
        mano_l = fix_left_shapedirs(synthetic_mano("left", seed=0), mano_r)
    else:
        mano_l, mano_r = load_mano_pair(opt.mano_path)
    layers = tuple(int(x) for x in opt.backbone_layers.split(","))
    cfg = ModelConfig(root_joint=opt.root_joint, dtype=opt.dtype,
                      backbone_layers=layers, backbone_stem=opt.stem,
                      fused_bottleneck_eval=opt.fused_bottleneck,
                      fused_l2_bands=opt.fused_l2_bands,
                      quant_backbone_eval=opt.quant_backbone,
                      quant_decoder_eval=opt.quant_decoder,
                      quant_aux_eval=opt.quant_aux,
                      quant_static=opt.quant_static,
                      quant_fused=opt.quant_fused,
                      quant_fused_l2_bands=opt.quant_fused_l2_bands)
    model = DIR(cfg)
    logger.info("weights: %s (%s)", load_model_weights(model, opt.model),
                opt.model)
    model = model.to(dev).eval()
    mano_l, mano_r = mano_l.to(dev), mano_r.to(dev)

    ds = InterHandDataset(opt.data_path, "test", mano_l, mano_r,
                          augment_train=False)
    loader = BatchLoader(ds, opt.bs, shuffle=False, drop_last=False,
                         pad_last=True, num_threads=4,
                         pin_memory=dev.type == "cuda")
    logger.info("evaluating %d samples on %s", len(ds), dev)

    if opt.quant_static:
        # one calibration forward on the first batch, built synchronously;
        # under a mesh every rank calibrates on the whole batch, as dir_tpu
        # calibrates on the unsharded batch, so the scales agree with no
        # collective
        first = loader.peek_batch()
        calibrate_static_scales(model, torch.as_tensor(first["img"]),
                                mano_l, mano_r)
        logger.info("calibrated static int8 scales on one batch of %d",
                    first["img"].shape[0])
    # rank 0's weights on every rank, and the dynamic int8 scales over the
    # global batch
    replicate(model, mesh)

    infer = make_infer(model, mano_l, mano_r)
    jreg_l = evaluate.extended_j_regressor(mano_l)
    jreg_r = evaluate.extended_j_regressor(mano_r)
    dump = {k: [] for k in _DUMP_KEYS}

    # resume: the dumps are per sample and in order, so the whole eval
    # state is (accumulated arrays, batches consumed); the fingerprint of
    # every flag that changes an output guards against another run's file
    config_fp = json.dumps({
        "model": opt.model, "data_path": opt.data_path, "bs": opt.bs,
        "root_joint": opt.root_joint, "scale": opt.scale,
        "stage": opt.stage, "dtype": opt.dtype,
        "backbone_layers": opt.backbone_layers, "stem": opt.stem,
        "quant": [opt.quant_backbone, opt.quant_decoder, opt.quant_static,
                  opt.quant_aux, opt.quant_fused, opt.quant_fused_l2_bands],
        "mano": [opt.mano_path, opt.synthetic_mano],
        "fused_bottleneck": [opt.fused_bottleneck, opt.fused_l2_bands],
    }, sort_keys=True)
    fp_hash = hashlib.sha1(config_fp.encode()).hexdigest()[:8]
    resume_path = os.path.join(opt.out, f"eval_resume.{fp_hash}.npz")
    start_batch = 0
    if opt.resume_every and os.path.exists(resume_path):
        with np.load(resume_path, allow_pickle=False) as saved:
            if str(saved["_config"]) == config_fp:
                start_batch = int(saved["_batches_done"])
                for k in dump:
                    if len(saved[k]):
                        dump[k] = [saved[k]]
                logger.info("resuming eval at batch %d/%d from %s",
                            start_batch, len(loader), resume_path)
            else:
                logger.warning("ignoring %s: config fingerprint differs",
                               resume_path)

    def save_resume(batches_done: int) -> None:
        if not lead:
            return
        arrs = {k: (np.concatenate(v, axis=0) if v
                    else np.zeros((0,), np.float32))
                for k, v in dump.items()}
        tmp = resume_path + ".tmp.npz"  # .npz suffix: savez appends none
        np.savez(tmp, _batches_done=batches_done, _config=config_fp, **arrs)
        os.replace(tmp, resume_path)

    def place(batch, key):
        """This rank's block of ``batch[key]`` on the device."""
        if mesh is not None:
            return shard_batch(batch[key], mesh)
        return torch.as_tensor(batch[key]).to(dev, non_blocking=True)

    def accumulate(batch, final):
        with torch.inference_mode(), no_tf32():
            errs = evaluate.batch_errors(
                final["pd_mesh_xyz_left"], final["pd_mesh_xyz_right"],
                final["pd_offset"], place(batch, "mesh_3d_left"),
                place(batch, "mesh_3d_right"), place(batch, "camera"),
                jreg_l, jreg_r, root_joint=opt.root_joint,
                scale_align=opt.scale)
            n = int(batch["_valid"])
            for k in dump:
                rows = errs[k] if mesh is None else mesh.gather_rows(errs[k])
                dump[k].append(rows[:n].cpu().numpy())

    last_saved = start_batch
    group = []
    for bi, batch in enumerate(loader.iter_from(start_batch),
                               start=start_batch + 1):
        # --unroll: the group's forwards are queued back to back before any
        # of their errors is read back
        group.append(batch)
        if len(group) < opt.unroll and bi < len(loader):
            continue
        finals = [infer(place(b, "img"))["stages"][opt.stage]
                  for b in group]
        for b, final in zip(group, finals):
            accumulate(b, final)
        group = []
        if opt.resume_every and bi - last_saved >= opt.resume_every:
            save_resume(bi)
            last_saved = bi
            logger.info("saved eval accumulators at batch %d", bi)

    d = {k: np.concatenate(v, axis=0) for k, v in dump.items()}
    if not lead:
        return None
    if opt.resume_every and os.path.exists(resume_path):
        os.remove(resume_path)  # complete: the partial state is ours
    out = opt.out
    np.savetxt(f"{out}/left_joint.txt",
               d["joints_xyz_left"].reshape(-1, 63) * 1000, fmt="%.3f")
    np.savetxt(f"{out}/right_joint.txt",
               d["joints_xyz_right"].reshape(-1, 63) * 1000, fmt="%.3f")
    np.savetxt(f"{out}/joint_left_error.txt", d["joint_left"] * 1000,
               fmt="%.3f")
    np.savetxt(f"{out}/joint_right_error.txt", d["joint_right"] * 1000,
               fmt="%.3f")
    np.savetxt(f"{out}/mesh_left_error.txt",
               d["vert_left"].mean(-1) * 1000, fmt="%.3f")
    np.savetxt(f"{out}/mesh_right_error.txt",
               d["vert_right"].mean(-1) * 1000, fmt="%.3f")
    np.savetxt(f"{out}/joint_2d_left_error.txt", d["joint2d_left"],
               fmt="%.3f")
    np.savetxt(f"{out}/joint_2d_right_error.txt", d["joint2d_right"],
               fmt="%.3f")
    np.savetxt(f"{out}/mesh_2d_left_error.txt", d["vert2d_left"].mean(-1),
               fmt="%.3f")
    np.savetxt(f"{out}/mesh_2d_right_error.txt", d["vert2d_right"].mean(-1),
               fmt="%.3f")
    np.savetxt(f"{out}/root_loss.txt", d["root"] * 1000, fmt="%.3f")

    jl = d["joint_left"].mean() * 1000
    jr = d["joint_right"].mean() * 1000
    vl = d["vert_left"].mean() * 1000
    vr = d["vert_right"].mean() * 1000
    j2l = d["joint2d_left"].mean()
    j2r = d["joint2d_right"].mean()
    v2l = d["vert2d_left"].mean()
    v2r = d["vert2d_right"].mean()
    print("joint mean error:")
    print(f"    left: {jl} mm, right: {jr} mm")
    print(f"    all: {(jl + jr) / 2} mm")
    print("vert mean error:")
    print(f"    left: {vl} mm, right: {vr} mm")
    print(f"    all: {(vl + vr) / 2} mm")
    print("pixel joint mean error:")
    print(f"    left: {j2l} px, right: {j2r} px")
    print(f"    all: {(j2l + j2r) / 2} px")
    print("pixel vert mean error:")
    print(f"    left: {v2l} px, right: {v2r} px")
    print(f"    all: {(v2l + v2r) / 2} px")
    print(f"root error: {d['root'].mean() * 1000} mm")
    summary = {
        "joint_mean_all_mm": float((jl + jr) / 2),
        "vert_mean_all_mm": float((vl + vr) / 2),
        "joint2d_mean_all_px": float((j2l + j2r) / 2),
        "vert2d_mean_all_px": float((v2l + v2r) / 2),
        "root_mean_mm": float(d["root"].mean() * 1000),
    }
    print("SUMMARY " + json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
