"""On-device data pipeline: the host decodes JPEGs, the card does the rest
(counterpart of ``dir_tpu/data/device_pipeline.py``).

Per batch, on the device:

  * MANO ground truth of both hands from the stored parameters (one
    hand-batched forward in fp32 with TF32 off), the camera transform and
    the projection;
  * a random horizontal flip with the left/right swap;
  * motion blur (a random line kernel), then a global rotation, scale and
    translation affine warp of image, mask and dense maps with the 2D
    labels transformed and the 3D labels re-lifted through the camera;
  * brightness and Gaussian noise;
  * the segmentation decode from the mask colours and the ImageNet
    normalization.

Each random step is split into a *draw* (:func:`draw_augmentation`, from a
``torch.Generator`` on the device) and an *apply* (the rest of this module,
a pure function of the drawn values): the same draws give the same batch
on any device, and the tests replay the JAX package's draws through the
apply functions. The warp gathers the four bilinear taps with each tap's
integer index clipped to the map, as the JAX package does; that is not
``grid_sample``'s border mode, which clamps the sample coordinate.
"""

from __future__ import annotations

import math
import os.path as osp
import pickle
from glob import glob
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from dir_tpu_torch.device import float_constant, no_tf32, resolve_device
from dir_tpu_torch.mano.assets import ManoModel, stack_mano_pair
from dir_tpu_torch.mano.layer import mano_forward_rotmat_pair
from dir_tpu_torch.train.steps import IMAGENET_MEAN, IMAGENET_STD

BLUR_K = 9  # motion-blur kernel size (the reference samples 3..10)
_SIDES = ("left", "right")


def draw_augmentation(generator: torch.Generator, b: int, image_shape,
                      scale_factor: float = 0.1, rot_deg: float = 180.0,
                      transl: float = 10.0, alpha: float = 0.3
                      ) -> Dict[str, torch.Tensor]:
    """Every random value one training batch of ``b`` images of
    ``image_shape`` (H, W, C) needs, drawn from ``generator`` on its
    device: the flip's uniform, the affine's scale offset, angle (degrees)
    and shift, the blur's angle, half length and uniform, the brightness
    factors, the offset's uniform in [-1, 1] and standard-normal noise."""
    dev = generator.device

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (hi - lo) + lo

    return {
        "flip_u": uniform((b,)),
        "scale_delta": uniform((b,), -scale_factor, scale_factor),
        "rot_deg": uniform((b,), -rot_deg, rot_deg),
        "tx": uniform((b,), -transl, transl),
        "ty": uniform((b,), -transl, transl),
        "blur_angle": uniform((b,), -math.pi, math.pi),
        "blur_length": uniform((b,), 1.5, BLUR_K / 2),
        "blur_u": uniform((b,)),
        "bright": uniform((b, 1, 1, 3), 1 - alpha, 1 + alpha),
        "offset_u": uniform((b, 1, 1, 1), -1.0, 1.0),
        "noise": torch.randn((b, *image_shape), generator=generator,
                             device=dev),
    }


def affine_mats(scale_delta, rot_deg, tx, ty, img_size: int) -> torch.Tensor:
    """(B, 2, 3) forward affine: rotate and scale about the centre, then
    translate."""
    scale = 1.0 + scale_delta
    theta = torch.deg2rad(rot_deg)
    c = img_size / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    # M = T S R about (c, c): linear part A = s R, offset c - A c + t
    a00 = scale * cos
    a01 = -scale * sin
    a10 = scale * sin
    a11 = scale * cos
    ox = c - (a00 * c + a01 * c) + tx
    oy = c - (a10 * c + a11 * c) + ty
    return torch.stack([torch.stack([a00, a01, ox], -1),
                        torch.stack([a10, a11, oy], -1)], dim=1)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) forward -> inverse map, with |det| floored at 1e-12."""
    a, b_, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b_ * d
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    ia, ib = e / det, -b_ / det
    id_, ie = -d / det, a / det
    ic = -(ia * c + ib * f)
    if_ = -(id_ * c + ie * f)
    return torch.stack([torch.stack([ia, ib, ic], -1),
                        torch.stack([id_, ie, if_], -1)], dim=1)


def warp_images(imgs: torch.Tensor, m_fwd: torch.Tensor) -> torch.Tensor:
    """Batched bilinear affine warp, (B, H, W, C) float by the (B, 2, 3)
    forward affine (dst = M src): four taps gathered from the flattened
    map, each tap's integer index clipped to the map."""
    b, h, w, c = imgs.shape
    minv = invert_affine(m_fwd)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=imgs.device, dtype=imgs.dtype),
        torch.arange(w, device=imgs.device, dtype=imgs.dtype), indexing="ij")
    dst = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)   # (H, W, 3)
    src = torch.einsum("bij,hwj->bhwi", minv, dst)             # (B, H, W, 2)
    sx, sy = src[..., 0], src[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = imgs.reshape(b, h * w, c)

    def tap(xi, yi, wgt):
        xc = xi.clamp(0, w - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        idx = (yc * w + xc).reshape(b, h * w, 1).expand(b, h * w, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c) * wgt[..., None]

    return (tap(x0, y0, (1 - fx) * (1 - fy))
            + tap(x0 + 1, y0, fx * (1 - fy))
            + tap(x0, y0 + 1, (1 - fx) * fy)
            + tap(x0 + 1, y0 + 1, fx * fy))


def motion_blur(imgs: torch.Tensor, angle: torch.Tensor,
                length: torch.Tensor, apply_u: torch.Tensor,
                prob: float = 0.3) -> torch.Tensor:
    """A line-kernel blur per sample where ``apply_u < prob`` (else the
    identity kernel): the kernel's taps lie within ``length`` along the
    line at ``angle`` and 0.6 across it. One depthwise cross-correlation
    over the batch's (sample, channel) planes with zero padding."""
    b, h, w, c = imgs.shape
    r = (torch.arange(BLUR_K, device=imgs.device, dtype=imgs.dtype)
         - (BLUR_K - 1) / 2)
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    ca = torch.cos(angle)[:, None, None]
    sa = torch.sin(angle)[:, None, None]
    along = xx[None] * ca + yy[None] * sa
    perp = -xx[None] * sa + yy[None] * ca
    line = ((along.abs() <= length[:, None, None])
            & (perp.abs() <= 0.6)).to(imgs.dtype)
    ident = torch.zeros((BLUR_K, BLUR_K), dtype=imgs.dtype,
                        device=imgs.device)
    ident[(BLUR_K - 1) // 2, (BLUR_K - 1) // 2] = 1.0
    kernel = torch.where((apply_u < prob)[:, None, None], line, ident[None])
    kernel = kernel / kernel.sum(dim=(1, 2), keepdim=True)
    planes = imgs.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    weight = kernel.repeat_interleave(c, dim=0)[:, None]   # (B*C, 1, K, K)
    out = F.conv2d(planes, weight, padding=BLUR_K // 2, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def add_noise(imgs: torch.Tensor, bright: torch.Tensor,
              offset_u: torch.Tensor, normal: torch.Tensor,
              noise: float = 0.01, beta: float = 0.05) -> torch.Tensor:
    """Brightness factors per channel, an offset of ``255 beta offset_u``
    and Gaussian noise of std ``255 noise`` on [0, 255] images, clipped."""
    off = 255.0 * beta * offset_u
    g = 255.0 * noise * normal
    return torch.clamp(imgs * bright + off + g, 0, 255)


def seg_from_mask(mask: torch.Tensor, flipped: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR mask values in [0, 255] -> (B, H, W) int32 labels
    (1 left, 2 right); ``flipped`` (B,) bool swaps them."""
    g, r = mask[..., 1], mask[..., 2]
    hand = (g > 50) | (r > 50)
    left = hand & (g >= r)
    right = hand & (g < r)
    f = flipped[:, None, None]
    zero = torch.zeros_like(g, dtype=torch.int32)
    one, two = zero + 1, zero + 2
    seg = torch.where(left, torch.where(f, two, one), zero)
    return torch.where(right, torch.where(f, one, two), seg)


def preprocess_apply(raw: Dict[str, torch.Tensor], draws, pair: ManoModel,
                     img_size: int, train: bool) -> Dict[str, torch.Tensor]:
    """The batch of the model and the losses from a raw batch on the
    device (:class:`RawInterHandDataset` samples, collated) and, with
    ``train``, the values of :func:`draw_augmentation`."""
    b = raw["img"].shape[0]
    img = raw["img"].to(torch.float32)
    mask = raw["mask"].to(torch.float32)
    dense = raw["dense"].to(torch.float32)

    # MANO ground truth of both hands in one forward, camera frame
    def both(key):
        return torch.stack([raw[f"{key}_{s}"] for s in _SIDES])

    verts, joints = mano_forward_rotmat_pair(
        pair, both("R"), both("pose"), both("shape"), trans=both("trans"),
        center_idx=None)
    cam_r, cam_t = raw["cam_R"], raw["cam_t"][None, :, None]
    verts = torch.einsum("hbvc,bdc->hbvd", verts, cam_r) + cam_t
    joints = torch.einsum("hbjc,bdc->hbjd", joints, cam_r) + cam_t
    gt = {}
    for i, side in enumerate(_SIDES):
        gt[f"verts_{side}"] = verts[i]
        gt[f"joints_{side}"] = joints[i]
    cam = raw["camera"]

    def project(x):
        p = torch.einsum("bnc,bdc->bnd", x, cam)
        return p[..., :2] / p[..., 2:]

    uv = {k: project(v) for k, v in gt.items()}

    if train:
        do_flip = draws["flip_u"] < 0.5
        fmask = do_flip[:, None, None, None]
        img, mask, dense = (torch.where(fmask, x.flip(2), x)
                            for x in (img, mask, dense))
        fl = do_flip[:, None, None]

        def flip_uv(x):
            fx = torch.stack([img_size - x[..., 0] - 1, x[..., 1]], -1)
            return torch.where(fl, fx, x)

        new_uv, new_gt = {}, {}
        for side, other in (("left", "right"), ("right", "left")):
            for kind in ("verts", "joints"):
                mine, theirs = f"{kind}_{side}", f"{kind}_{other}"
                new_uv[mine] = flip_uv(torch.where(fl, uv[theirs], uv[mine]))
                new_gt[mine] = torch.where(fl, gt[theirs], gt[mine])
        uv, gt = new_uv, new_gt

        img = motion_blur(img, draws["blur_angle"], draws["blur_length"],
                          draws["blur_u"])
        m_fwd = affine_mats(draws["scale_delta"], draws["rot_deg"],
                            draws["tx"], draws["ty"], img_size)
        img, mask, dense = (warp_images(x, m_fwd) for x in (img, mask, dense))
        fx, fy = cam[:, 0:1, 0:1], cam[:, 1:2, 1:2]
        fu, fv = cam[:, 0:1, 2:3], cam[:, 1:2, 2:3]
        for k in ("verts_left", "verts_right", "joints_left", "joints_right"):
            uw = (torch.einsum("bij,bnj->bni", m_fwd[:, :, :2], uv[k])
                  + m_fwd[:, None, :, 2])
            depth = gt[k][..., 2:]
            x = (uw[..., 0:1] - fu) * depth / fx
            y = (uw[..., 1:2] - fv) * depth / fy
            uv[k], gt[k] = uw, torch.cat([x, y, depth], -1)

        img = add_noise(img, draws["bright"], draws["offset_u"],
                        draws["noise"])
    else:
        do_flip = torch.zeros((b,), dtype=torch.bool, device=img.device)

    seg = seg_from_mask(mask, do_flip)
    mean = float_constant(IMAGENET_MEAN, img.device)
    std = float_constant(IMAGENET_STD, img.device)
    img_norm = (img.flip(-1) / 255.0 - mean) / std
    # dense GT stays BGR, as the reference trains its dense head on it
    dense_norm = dense / 255.0

    def nuv(u, x3):
        return torch.cat([u / img_size * 2 - 1, x3[..., 2:]], dim=-1)

    return {
        "img": img_norm,
        "seg": seg,
        "dense": dense_norm,
        "joint_2d_left": nuv(uv["joints_left"], gt["joints_left"]),
        "joint_2d_right": nuv(uv["joints_right"], gt["joints_right"]),
        "mesh_2d_left": nuv(uv["verts_left"], gt["verts_left"]),
        "mesh_2d_right": nuv(uv["verts_right"], gt["verts_right"]),
        "joint_3d_left": gt["joints_left"],
        "joint_3d_right": gt["joints_right"],
        "mesh_3d_left": gt["verts_left"],
        "mesh_3d_right": gt["verts_right"],
        "center_left": gt["joints_left"][:, 9:10],
        "center_right": gt["joints_right"][:, 9:10],
        "camera": cam,
    }


def make_preprocess_fn(mano_left: ManoModel, mano_right: ManoModel,
                       img_size: int = 256, train: bool = True,
                       device=None):
    """``preprocess(raw, generator=None, draws=None) -> batch`` on
    ``device`` (CUDA unless the caller names another; raises without a
    card and none named).

    ``raw``: a collated :class:`RawInterHandDataset` batch (numpy arrays or
    tensors; ``_valid`` is ignored): img, mask, dense (B, S, S, 3) uint8
    BGR; R_left/right (B, 3, 3); pose_* (B, 45); shape_* (B, 10); trans_*
    (B, 3); cam_R (B, 3, 3); cam_t (B, 3); camera (B, 3, 3). With
    ``train`` the augmentation's values come from ``draws`` when given,
    else from ``generator`` (a ``torch.Generator`` on the device). Runs
    in fp32 with TF32 off and returns the model/loss batch on the device.
    """
    dev = resolve_device(device)
    pair = stack_mano_pair(mano_left, mano_right).to(dev)

    def preprocess(raw, generator: torch.Generator | None = None,
                   draws: dict | None = None) -> Dict[str, torch.Tensor]:
        raw = {k: torch.as_tensor(v).to(dev, non_blocking=True)
               for k, v in raw.items() if k != "_valid"}
        if train and draws is None:
            if generator is None:
                raise ValueError("train=True needs a generator or draws")
            draws = draw_augmentation(generator, raw["img"].shape[0],
                                      tuple(raw["img"].shape[1:]))
        with no_tf32():
            return preprocess_apply(raw, draws, pair, img_size, train)

    return preprocess


class RawInterHandDataset:
    """Host-side reader of the processed InterHand layout: JPEG decode and
    the annotation pickle only; :func:`make_preprocess_fn` does the rest."""

    def __init__(self, data_path: str, split: str, img_size: int = 256):
        self.data_path = data_path
        self.split = split
        self.img_size = img_size
        self.size = len(glob(osp.join(data_path, split, "anno", "*.pkl")))

    def __len__(self):
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        import cv2 as cv
        sp = self.split
        img = cv.imread(osp.join(self.data_path, sp, "img", f"{idx}.jpg"))
        mask = cv.imread(osp.join(self.data_path, sp, "mask", f"{idx}.jpg"))
        dense = cv.imread(osp.join(self.data_path, sp, "dense", f"{idx}.jpg"))
        with open(osp.join(self.data_path, sp, "anno", f"{idx}.pkl"),
                  "rb") as f:
            data = pickle.load(f)
        out = {
            "img": img.astype(np.uint8),
            "mask": mask.astype(np.uint8),
            "dense": dense.astype(np.uint8),
            "cam_R": np.asarray(data["camera"]["R"], np.float32),
            "cam_t": np.asarray(data["camera"]["t"], np.float32),
            "camera": np.asarray(data["camera"]["camera"], np.float32),
        }
        for side in _SIDES:
            p = data["mano_params"][side]
            out[f"R_{side}"] = np.asarray(p["R"], np.float32).reshape(3, 3)
            out[f"pose_{side}"] = np.asarray(p["pose"],
                                             np.float32).reshape(-1)
            out[f"shape_{side}"] = np.asarray(p["shape"],
                                              np.float32).reshape(10)
            out[f"trans_{side}"] = np.asarray(p["trans"],
                                              np.float32).reshape(3)
        return out
