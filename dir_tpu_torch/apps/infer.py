"""Single-image two-hand inference with the port (counterpart of
``apps/infer.py``; batch 1, 256x256).

Reads one RGB crop, runs DIR, writes the predicted MANO meshes (.obj),
parameters (.npz), the skeleton overlay and the shaded mesh overlay.

Usage:
    python -m dir_tpu_torch.apps.infer --image crop.jpg \
        --model <ckpt|DIR.pth|random> --mano_path ./assets/mano \
        [--out ./infer_out] [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

OUTPUTS = ("hand_left.obj", "hand_right.obj", "prediction.npz",
           "overlay.png", "mesh_overlay.png")


def _write_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def main(argv=None) -> dict:
    """Run one image; returns the final stage's outputs as numpy arrays."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image", type=str, required=True)
    ap.add_argument("--model", type=str, default="random")
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--out", type=str, default="./infer_out")
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3")
    ap.add_argument("--synthetic_mano", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    opt = ap.parse_args(argv)

    import cv2 as cv

    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.data.augment import normalize_image
    from dir_tpu_torch.device import resolve_device
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import make_infer
    from dir_tpu_torch.train.checkpoint import load_model_weights
    from dir_tpu_torch.utils.visualize import (draw_2d_skeleton,
                                               render_mesh_overlay)

    dev = resolve_device(opt.device)
    os.makedirs(opt.out, exist_ok=True)
    if opt.synthetic_mano:
        mano_r = synthetic_mano("right", seed=0)
        mano_l = fix_left_shapedirs(synthetic_mano("left", seed=0), mano_r)
    else:
        mano_l, mano_r = load_mano_pair(opt.mano_path)
    layers = tuple(int(x) for x in opt.backbone_layers.split(","))
    model = DIR(ModelConfig(dtype=opt.dtype, backbone_layers=layers))
    load_model_weights(model, opt.model)
    infer = make_infer(model.to(dev), mano_l, mano_r)

    img_bgr = cv.resize(cv.imread(opt.image), (256, 256))
    out = infer(normalize_image(img_bgr)[None])
    final = {k: v[0].float().cpu().numpy()
             for k, v in out["stages"][-1].items()}

    faces = mano_r.faces.cpu().numpy()
    for side in ("left", "right"):
        _write_obj(os.path.join(opt.out, f"hand_{side}.obj"),
                   final[f"pd_mesh_xyz_{side}"], faces)
    np.savez(os.path.join(opt.out, "prediction.npz"),
             mano_para_left=final["pd_mano_para_left"],
             mano_para_right=final["pd_mano_para_right"],
             offset=final["pd_offset"],
             joints_left=final["pd_joint_xyz_left"],
             joints_right=final["pd_joint_xyz_right"],
             seg=out["seg"][0].float().cpu().numpy())

    overlay = img_bgr
    for side in ("left", "right"):
        uv = (final[f"pd_joint_uv_{side}"] + 1) / 2 * 256
        overlay = draw_2d_skeleton(overlay, uv)
    cv.imwrite(os.path.join(opt.out, "overlay.png"), overlay)

    # The 3D mesh overlay (reference: pyrender offscreen render,
    # utils/visualize.py:75-105). Predictions are root-relative; they are
    # placed at a nominal depth in front of a camera that keeps the crop's
    # framing.
    depth = 0.5
    cam = np.array([[512.0, 0, 128.0], [0, 512.0, 128.0], [0, 0, 1.0]],
                   np.float32)
    off = final["pd_offset"] * 0.15
    vl = final["pd_mesh_xyz_left"] - off / 2 + [0, 0, depth]
    vr = final["pd_mesh_xyz_right"] + off / 2 + [0, 0, depth]
    cv.imwrite(os.path.join(opt.out, "mesh_overlay.png"),
               render_mesh_overlay(img_bgr, vl, vr, faces, cam, alpha=0.85))
    print(f"wrote meshes, parameters, and overlays to {opt.out}")
    return final


if __name__ == "__main__":
    main()
