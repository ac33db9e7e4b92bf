"""Random-hand MANO demo with the port (counterpart of ``apps/demo.py``;
reference: manopth/manopth/demo.py).

Draws a random two-hand pose, runs the port's MANO layer, renders the
meshes with the numpy rasterizer, and saves the mask, dense and skeleton
panels side by side.

Usage:
    python -m dir_tpu_torch.apps.demo [--mano_path ./assets/mano] \
        [--out demo.png] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> np.ndarray:
    """Render one random pair; returns the (256, 768, 3) uint8 panels."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mano_path", type=str, default="./assets/mano")
    ap.add_argument("--out", type=str, default="demo.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device of the MANO layer (default: cuda)")
    opt = ap.parse_args(argv)

    import cv2 as cv
    import torch
    from scipy.spatial.transform import Rotation as R

    from dir_tpu_torch.data.rasterizer import (dense_colors, mask_colors,
                                               render_two_hands)
    from dir_tpu_torch.device import resolve_device
    from dir_tpu_torch.mano.assets import (fix_left_shapedirs, load_mano_pair,
                                           synthetic_mano)
    from dir_tpu_torch.mano.layer import mano_forward_rotmat
    from dir_tpu_torch.utils.visualize import draw_2d_skeleton

    dev = resolve_device(opt.device)
    try:
        mano_l, mano_r = load_mano_pair(opt.mano_path)
    except FileNotFoundError:
        print("no MANO assets found; using the synthetic test model")
        mano_r = synthetic_mano("right", seed=1)
        mano_l = fix_left_shapedirs(synthetic_mano("left", seed=1), mano_r)

    rng = np.random.RandomState(opt.seed)
    size = 256
    cam = np.array([[500.0, 0, size / 2], [0, 500.0, size / 2], [0, 0, 1]],
                   np.float32)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    verts_np, joints_np = {}, {}
    for model, side, xoff in ((mano_l, "left", -0.06),
                              (mano_r, "right", 0.06)):
        root = R.random(random_state=rng.randint(1 << 30)).as_matrix()
        pose = (rng.randn(1, 45) * 0.5).astype(np.float32)
        shape = (rng.randn(1, 10) * 0.5).astype(np.float32)
        with torch.no_grad():
            v, j = mano_forward_rotmat(
                model.to(dev), t(root[None]), t(pose), t(shape),
                trans=t([[xoff, 0.0, 0.45]]), center_idx=None)
        verts_np[side] = v[0].cpu().numpy()
        joints_np[side] = j[0].cpu().numpy()

    faces = mano_r.faces.cpu().numpy()
    nv = verts_np["left"].shape[0]
    mask, _ = render_two_hands(verts_np["left"], verts_np["right"], faces,
                               cam, size, mask_colors(nv, "left"),
                               mask_colors(nv, "right"))
    dense, _ = render_two_hands(
        verts_np["left"], verts_np["right"], faces, cam, size,
        dense_colors(mano_l.v_template.cpu().numpy()),
        dense_colors(mano_r.v_template.cpu().numpy()))
    skel = np.zeros((size, size, 3), np.uint8)
    for side in ("left", "right"):
        p = joints_np[side] @ cam.T
        skel = draw_2d_skeleton(skel, p[:, :2] / p[:, 2:])
    panels = np.concatenate([(mask * 255).astype(np.uint8),
                             (dense * 255).astype(np.uint8), skel], axis=1)
    cv.imwrite(opt.out, panels)
    print(f"wrote {opt.out}")
    return panels


if __name__ == "__main__":
    main()
