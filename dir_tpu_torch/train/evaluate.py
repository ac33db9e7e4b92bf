"""Benchmark evaluation metrics: MPJPE/MPVPE/root errors (counterpart of
``dir_tpu/train/evaluate.py``).

* GT joints are regressed from the GT vertices through an extended 21-row
  J_regressor (16 MANO rows + 5 fingertip one-hots, reordered).
* Predictions are root-centred at ``root_joint`` and scaled by the
  GT/predicted joint9-joint0 bone-length ratio.
* 3D errors in metres (summaries in mm), 2D pixel errors over (u, v)
  through the camera, and the inter-hand root offset error.

Each per-batch function takes a validity mask, so a final partial batch
can be padded to a fixed size. Pure tensor math on whatever device the
inputs lie on. Under a data mesh each rank computes the sums of its block
(:func:`valid_rows` masks the padding in it) and :func:`global_sums` adds
them over the ranks, so the accumulators are the global batch's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dir_tpu_torch.mano.assets import ManoModel
from dir_tpu_torch.ops.projection import xyz_to_uv
from dir_tpu_torch.parallel.mesh import Mesh


def extended_j_regressor(model: ManoModel) -> torch.Tensor:
    """(21, 778) regressor: 16 MANO rows + 5 fingertip one-hots, reordered.
    Uses the data-side tip indices."""
    base = model.j_regressor.detach().cpu().numpy()
    tips = np.zeros((5, base.shape[1]), np.float32)
    for i, v in enumerate((745, 317, 444, 556, 673)):
        tips[i, v] = 1.0
    j21 = np.concatenate([base, tips], axis=0)
    new_order = [0, 13, 14, 15, 16, 1, 2, 3, 17, 4, 5, 6, 18,
                 10, 11, 12, 19, 7, 8, 9, 20]
    return torch.from_numpy(j21[new_order]).to(model.j_regressor.device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(x, dim=-1)


def _aligned(pred_verts_left, pred_verts_right, pred_offset, gt_verts_left,
             gt_verts_right, camera, jreg_left, jreg_right, root_joint,
             scale_align) -> dict:
    """What both per-batch functions share: root-centred, scale-aligned
    predictions and ground truth, the 2D ground truth, and the per-sample
    root offset error."""

    def reg(jreg, v):
        return torch.einsum("jv,bvc->bjc", jreg, v)

    rj = root_joint
    gt_j_l = reg(jreg_left, gt_verts_left)
    gt_j_r = reg(jreg_right, gt_verts_right)
    root_l_gt = gt_j_l[:, rj:rj + 1]
    root_r_gt = gt_j_r[:, rj:rj + 1]
    gt_offset = root_r_gt - root_l_gt
    len_l_gt = _norm(gt_j_l[:, 9] - gt_j_l[:, 0])
    len_r_gt = _norm(gt_j_r[:, 9] - gt_j_r[:, 0])

    pd_j_l = reg(jreg_left, pred_verts_left)
    pd_j_r = reg(jreg_right, pred_verts_right)
    root_l_pd = pd_j_l[:, rj:rj + 1]
    root_r_pd = pd_j_r[:, rj:rj + 1]
    len_l_pd = _norm(pd_j_l[:, 9] - pd_j_l[:, 0])
    len_r_pd = _norm(pd_j_r[:, 9] - pd_j_r[:, 0])
    if scale_align:
        sc_l = (len_l_gt / len_l_pd)[:, None, None]
        sc_r = (len_r_gt / len_r_pd)[:, None, None]
    else:
        sc_l = sc_r = torch.ones_like(len_l_gt)[:, None, None]

    # inter-hand root offset; pred_offset is normalized (x 0.15 -> metres)
    rel_pred = pred_offset[:, None, :] * 0.15
    if root_joint != 0:
        pd_j_r_off = pd_j_r + rel_pred
        rel_pred = pd_j_r_off[:, rj:rj + 1] - pd_j_l[:, rj:rj + 1]

    return {
        "jl": (pd_j_l - root_l_pd) * sc_l,
        "jr": (pd_j_r - root_r_pd) * sc_r,
        "vl": (pred_verts_left - root_l_pd) * sc_l,
        "vr": (pred_verts_right - root_r_pd) * sc_r,
        "gjl": gt_j_l - root_l_gt,
        "gjr": gt_j_r - root_r_gt,
        "gvl": gt_verts_left - root_l_gt,
        "gvr": gt_verts_right - root_r_gt,
        "root_l_gt": root_l_gt,
        "root_r_gt": root_r_gt,
        "gt_j2_l": xyz_to_uv(gt_j_l, camera),
        "gt_j2_r": xyz_to_uv(gt_j_r, camera),
        "gt_v2_l": xyz_to_uv(gt_verts_left, camera),
        "gt_v2_r": xyz_to_uv(gt_verts_right, camera),
        "root": _norm(gt_offset - rel_pred)[:, 0],
    }


def _pair_errors(a: dict, camera: torch.Tensor) -> dict:
    """Per-sample, per-point error norms of the aligned quantities; the 2D
    ones re-anchor the predictions at the GT root."""
    return {
        "joint_left": _norm(a["jl"] - a["gjl"]),
        "joint_right": _norm(a["jr"] - a["gjr"]),
        "vert_left": _norm(a["vl"] - a["gvl"]),
        "vert_right": _norm(a["vr"] - a["gvr"]),
        "joint2d_left": _norm(
            xyz_to_uv(a["jl"] + a["root_l_gt"], camera) - a["gt_j2_l"]),
        "joint2d_right": _norm(
            xyz_to_uv(a["jr"] + a["root_r_gt"], camera) - a["gt_j2_r"]),
        "vert2d_left": _norm(
            xyz_to_uv(a["vl"] + a["root_l_gt"], camera) - a["gt_v2_l"]),
        "vert2d_right": _norm(
            xyz_to_uv(a["vr"] + a["root_r_gt"], camera) - a["gt_v2_r"]),
    }


def batch_errors(pred_verts_left: torch.Tensor,
                 pred_verts_right: torch.Tensor,
                 pred_offset: torch.Tensor,
                 gt_verts_left: torch.Tensor,
                 gt_verts_right: torch.Tensor,
                 camera: torch.Tensor,
                 jreg_left: torch.Tensor,
                 jreg_right: torch.Tensor,
                 root_joint: int = 0,
                 scale_align: bool = True) -> Dict[str, torch.Tensor]:
    """Per-sample, per-point errors, not reduced.

    Returns: joint_{left,right} (B, 21) m; vert_{left,right} (B, 778) m;
    joint2d/vert2d px; root (B,) m; plus the aligned prediction and GT
    joints.
    """
    a = _aligned(pred_verts_left, pred_verts_right, pred_offset,
                 gt_verts_left, gt_verts_right, camera, jreg_left,
                 jreg_right, root_joint, scale_align)
    out = _pair_errors(a, camera)
    out.update({
        "root": a["root"],
        "joints_xyz_left": a["jl"],
        "joints_xyz_right": a["jr"],
        "joints_xyz_left_gt": a["gjl"],
        "joints_xyz_right_gt": a["gjr"],
    })
    return out


def batch_metrics(pred_verts_left: torch.Tensor,
                  pred_verts_right: torch.Tensor,
                  pred_offset: torch.Tensor,
                  gt_verts_left: torch.Tensor,
                  gt_verts_right: torch.Tensor,
                  camera: torch.Tensor,
                  jreg_left: torch.Tensor,
                  jreg_right: torch.Tensor,
                  valid_mask: torch.Tensor,
                  root_joint: int = 0,
                  scale_align: bool = True) -> Dict[str, torch.Tensor]:
    """Per-sample metric sums for one (possibly padded) batch.

    pred_offset: (B, 3) normalized inter-hand offset. valid_mask: (B,)
    1.0 for real samples. Returns sums over the valid samples of each
    sample's mean error; divide by ``count`` for means.
    """
    a = _aligned(pred_verts_left, pred_verts_right, pred_offset,
                 gt_verts_left, gt_verts_right, camera, jreg_left,
                 jreg_right, root_joint, scale_align)
    m = valid_mask
    out = {}
    for key, err in _pair_errors(a, camera).items():
        unit = "px" if "2d" in key else "m"
        out[f"{key}_sum_{unit}"] = torch.sum(err.mean(dim=-1) * m)
    out["root_sum_m"] = torch.sum(a["root"] * m)
    out["count"] = torch.sum(m)
    return out


def online_batch_metrics(pd_joints_left: torch.Tensor,
                         pd_joints_right: torch.Tensor,
                         pd_verts_left: torch.Tensor,
                         pd_verts_right: torch.Tensor,
                         gt_joints_left: torch.Tensor,
                         gt_joints_right: torch.Tensor,
                         gt_verts_left: torch.Tensor,
                         gt_verts_right: torch.Tensor,
                         valid_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The in-training metric, distinct from the offline one above: the
    root is fixed at joint 9 (MCP), GT joints come straight from the
    targets (no J_regressor), and the scale alignment uses the
    joint9-joint0 bone of those target joints.

    Returns per-sample-mean sums over the valid samples, plus ``count``;
    divide by count and multiply by 1000 for mm.
    """
    m = valid_mask
    out = {}
    for side, pj, pv, gj, gv in (
            ("left", pd_joints_left, pd_verts_left,
             gt_joints_left, gt_verts_left),
            ("right", pd_joints_right, pd_verts_right,
             gt_joints_right, gt_verts_right)):
        root_gt = gj[:, 9:10]
        len_gt = _norm(gj[:, 9] - gj[:, 0])
        root_pd = pj[:, 9:10]
        len_pd = _norm(pj[:, 9] - pj[:, 0])
        scale = (len_gt / len_pd)[:, None, None]
        j_err = _norm((pj - root_pd) * scale - (gj - root_gt)).mean(dim=-1)
        v_err = _norm((pv - root_pd) * scale - (gv - root_gt)).mean(dim=-1)
        out[f"joint_{side}_sum_m"] = torch.sum(j_err * m)
        out[f"vert_{side}_sum_m"] = torch.sum(v_err * m)
    out["count"] = torch.sum(m)
    return out


def valid_rows(n_valid: int, b: int, device,
               mesh: Mesh | None = None) -> torch.Tensor:
    """The validity mask of this rank's ``b`` rows of a global batch whose
    first ``n_valid`` rows are real (the rest pad the last batch): 1.0 for
    a real row, 0.0 for padding."""
    start = 0 if mesh is None else mesh.rank * b
    return (torch.arange(start, start + b, device=device) < n_valid).float()


def global_sums(metrics: Dict[str, torch.Tensor],
                mesh: Mesh | None = None) -> Dict[str, float]:
    """A per-batch function's sums, added over the ranks in one all-reduce
    and brought to the host in one copy."""
    values = torch.stack(list(metrics.values()))
    if mesh is not None:
        values = mesh.sum(values)
    return dict(zip(metrics, values.cpu().tolist()))


def summarize_online(acc: Dict[str, float]) -> Dict[str, float]:
    """Accumulated online sums -> mm means per hand and over both."""
    n = acc["count"]
    s = {f"{kind}_mean_{side}_mm": acc[f"{kind}_{side}_sum_m"] / n * 1000
         for kind in ("joint", "vert") for side in ("left", "right")}
    s["joint_mean_all_mm"] = (s["joint_mean_left_mm"]
                              + s["joint_mean_right_mm"]) / 2
    s["vert_mean_all_mm"] = (s["vert_mean_left_mm"]
                             + s["vert_mean_right_mm"]) / 2
    return s


def summarize(acc: Dict[str, float]) -> Dict[str, float]:
    """Accumulated sums -> the printed summary: mm and px means per hand
    and over both hands, and the root offset error in mm."""
    n = acc["count"]
    s = {}
    for kind in ("joint", "vert"):
        for side in ("left", "right"):
            s[f"{kind}_mean_{side}_mm"] = acc[f"{kind}_{side}_sum_m"] / n * 1000.0
            s[f"{kind}2d_mean_{side}_px"] = acc[f"{kind}2d_{side}_sum_px"] / n
    s["root_mean_mm"] = acc["root_sum_m"] / n * 1000.0
    for key, unit in (("joint", "mm"), ("vert", "mm"), ("joint2d", "px"),
                      ("vert2d", "px")):
        s[f"{key}_mean_all_{unit}"] = (s[f"{key}_mean_left_{unit}"]
                                       + s[f"{key}_mean_right_{unit}"]) / 2
    return s
