"""The numbers that decide ``correct``, computed from the program's outputs
and the plain reference's on the same inputs. Each has its own limit in
``portbench/limits/<workload>.json``.

Serving outputs (per image):

``mm.s<i>``
    stage ``i``'s error in mm: per image, the mean over both hands' 21
    joints and 778 vertices of the distance to the reference's point; the
    number is the mean over the images.
``mm.s<i>.worst``
    the same of the last stage held, for the worst image: an answer that
    says the wrong thing.
``seg_flip``
    the share of the seg map's pixels whose label (argmax) differs from
    the reference's, among those where the reference's top logit leads the
    next by more than ``SEG_MARGIN``.
``dense_rel``
    the dense map's RMS error over the reference's RMS.
"""

from __future__ import annotations

import contextlib
import math

import torch

POINTS = ("pd_mesh_xyz_left", "pd_mesh_xyz_right", "pd_joint_xyz_left",
          "pd_joint_xyz_right")
SEG_MARGIN = 1.0


def _f(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().double().cpu()


def stage_mm(got: dict, want: dict) -> torch.Tensor:
    """Per image, the mean point distance over both hands' joints and
    meshes, in mm."""
    err = [(_f(got[k]) - _f(want[k])).norm(dim=-1).mean(-1) for k in POINTS]
    return torch.stack(err).mean(0) * 1e3


def serving_numbers(got: dict, want: dict) -> dict:
    """``got`` and ``want``: ``{"stages": [...], "seg", "dense"}`` over the
    same images."""
    out = {}
    for i in range(len(want["stages"])):
        g = got["stages"][i]
        per = stage_mm(g, want["stages"][i])
        finite = all(bool(torch.isfinite(_f(g[k])).all()) for k in POINTS)
        out[f"mm.s{i}"] = float(per.mean()) if finite else math.inf
    out[f"mm.s{i}.worst"] = float(per.max()) if finite else math.inf
    seg, ref = _f(got["seg"]), _f(want["seg"])
    top = ref.sort(-1).values
    sure = (top[..., -1] - top[..., -2]) > SEG_MARGIN
    flipped = seg.argmax(-1) != ref.argmax(-1)
    out["seg_flip"] = (float(flipped[sure].double().mean())
                       if torch.isfinite(seg).all() else math.inf)
    dense, ref = _f(got["dense"]), _f(want["dense"])
    rel = float(((dense - ref) ** 2).mean().sqrt()
                / (ref ** 2).mean().sqrt())
    out["dense_rel"] = rel if math.isfinite(rel) else math.inf
    return out


def cat_outputs(parts: list) -> dict:
    """Concatenate output dicts of image blocks along the batch."""
    first = parts[0]
    out = {"stages": [{k: torch.cat([p["stages"][i][k] for p in parts])
                       for k in s} for i, s in enumerate(first["stages"])]}
    for k in ("seg", "dense"):
        if k in first:
            out[k] = torch.cat([p[k] for p in parts])
    return out


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def reference_outputs(model, pair: dict, images: torch.Tensor,
                      block: int = 64) -> dict:
    """The reference's outputs on ``images`` (B, H, W, 3), in blocks of
    ``block`` images, fp32 with TF32 off; on the host."""
    dev = next(model.parameters()).device
    parts = []
    with torch.no_grad(), no_tf32():
        for i in range(0, images.shape[0], block):
            out = model(images[i:i + block].to(dev, torch.float32), pair)
            parts.append({"stages": [{k: v.cpu() for k, v in s.items()}
                                     for s in out["stages"]],
                          "seg": out["seg"].cpu(),
                          "dense": out["dense"].cpu()})
    return cat_outputs(parts)
