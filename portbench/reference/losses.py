"""DIR's training loss in plain float32 PyTorch, as the published trainer
assembles it: per refine stage the smooth-L1 coordinate terms (2D joints
and meshes, 3D joints and meshes relative to each hand's MCP joint, the
hands' offset), the mesh edge-length and normal terms, and once the
weighted cross-entropy, Lovász-softmax and dense smooth-L1 terms of the
heads. Also the decoding of the uint8 wire format a train batch arrives in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def decode(batch: dict, device) -> dict:
    """The wire format on ``device``: uint8 BGR images to normalized RGB
    float32, uint8 dense / 255, uint8 seg to int64; the rest as float32."""
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    out["img"] = (out["img"].flip(-1).float() / 255.0 - mean) / std
    out["dense"] = out["dense"].float() / 255.0
    out["seg"] = out["seg"].long()
    return out


def smooth_l1(x, y):
    z = (x - y).flatten(1)
    per = torch.where(z.abs() < 0.01, 0.5 * z * z, 0.01 * (z.abs() - 0.005))
    return per.mean(1).mean()


def _unit(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-24))


def _edges(coord, faces):
    f = faces.long()
    v0, v1, v2 = coord[:, f[:, 0]], coord[:, f[:, 1]], coord[:, f[:, 2]]
    return v1 - v0, v2 - v0, v2 - v1


def normal_loss(out, gt, faces):
    e_o = _edges(out, faces)
    e1, e2, _ = _edges(gt, faces)
    n = _unit(torch.linalg.cross(_unit(e1), _unit(e2), dim=-1))
    return torch.stack([(_unit(e) * n).sum(-1).abs() for e in e_o]).mean()


def edge_loss(out, gt, faces):
    def length(e):
        return torch.sqrt((e * e).sum(-1) + 1e-12)
    return torch.stack([(length(a) - length(b)).abs() for a, b in
                        zip(_edges(out, faces), _edges(gt, faces))]).mean()


def weighted_ce(logits, labels, weights):
    nll = -F.log_softmax(logits, -1).gather(-1, labels[..., None])[..., 0]
    w = torch.tensor(weights, device=logits.device)[labels]
    return (nll * w).sum() / w.sum()


def lovasz_softmax(probas, labels):
    """Lovász-softmax over the classes present (Berman et al., 2018), on
    the raw logits as the published trainer feeds them."""
    c = probas.shape[-1]
    flat, lab = probas.reshape(-1, c), labels.reshape(-1)
    losses = []
    for k in range(c):
        fg = (lab == k).float()
        if fg.sum() == 0:
            continue
        err = (fg - flat[:, k]).abs()
        err_sorted, order = torch.sort(err, descending=True, stable=True)
        g = fg[order]
        inter = g.sum() - g.cumsum(0)
        union = g.sum() + (1 - g).cumsum(0)
        jac = 1.0 - inter / union
        jac = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append((err_sorted * jac).sum())
    return torch.stack(losses).mean()


def dir_losses(out: dict, t: dict, cfg: dict, pair: dict) -> dict:
    """The loss terms; their sum is the training loss. ``t`` is a decoded
    batch."""
    w = cfg["loss"]
    s, cw = cfg["coord_scale"], w["coord_weight"]
    seg = out["seg"]
    size = seg.shape[1]
    stride = t["seg"].shape[1] // size
    gt_seg = t["seg"][:, ::stride, ::stride]
    gt_dense = F.interpolate(t["dense"].permute(0, 3, 1, 2), size=(size, size),
                             mode="bilinear", align_corners=False
                             ).permute(0, 2, 3, 1)
    loss = {
        "seg": weighted_ce(seg, gt_seg, w["seg_class_weights"])
        * w["seg_weight"] * w["dense_weight"],
        "dense": smooth_l1(out["dense"], gt_dense) * w["dense_weight"],
        "lovasz": lovasz_softmax(seg, gt_seg) * w["lovasz_weight"]
        * w["dense_weight"],
    }
    gt = {}
    for side in ("left", "right"):
        c = t[f"center_{side}"]
        gt[f"joint_xyz_{side}"] = (t[f"joint_3d_{side}"] - c) / s
        gt[f"mesh_xyz_{side}"] = (t[f"mesh_3d_{side}"] - c) / s
        gt[f"joint_uv_{side}"] = t[f"joint_2d_{side}"][..., :2]
        gt[f"mesh_uv_{side}"] = t[f"mesh_2d_{side}"][..., :2]
    gt_off = ((t["center_right"] - t["center_left"]) / s)[:, 0]
    for i, st in enumerate(out["stages"]):
        for side in ("left", "right"):
            for what in ("joint", "mesh"):
                loss[f"{what}_{side}_uv_{i}"] = smooth_l1(
                    st[f"pd_{what}_uv_{side}"], gt[f"{what}_uv_{side}"]) * cw
                loss[f"{what}_{side}_xyz_{i}"] = smooth_l1(
                    st[f"pd_{what}_xyz_{side}"] / s,
                    gt[f"{what}_xyz_{side}"]) * cw
            m, g = st[f"pd_mesh_xyz_{side}"] / s, gt[f"mesh_xyz_{side}"]
            faces = pair[side]["faces"]
            loss[f"edge_{side}_{i}"] = edge_loss(m, g, faces) * w["edge_weight"]
            loss[f"normal_{side}_{i}"] = normal_loss(m, g, faces) \
                * w["normal_weight"]
        loss[f"offset_{i}"] = smooth_l1(st["pd_offset"], gt_off) * cw
    return loss


class AdamW:
    """AdamW (Loshchilov and Hutter, 2019) with the decoupled decay:
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

    def __init__(self, params, lr, betas, eps, weight_decay):
        self.params = [p for p in params]
        self.lr, (self.b1, self.b2) = lr, betas
        self.eps, self.wd = eps, weight_decay
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p
            p.sub_(self.lr * upd)
