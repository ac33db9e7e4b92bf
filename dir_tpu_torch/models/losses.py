"""DIR training losses and their assembly (counterpart of
``dir_tpu/models/losses.py``).

The reference's custom SmoothL1, normal and edge losses, weighted
cross-entropy, the Lovász-softmax surrogate and the full loss assembly with
its weights. Kept from the reference and the JAX package: Lovász-softmax
runs on the raw seg logits; its classes are masked by presence, not skipped
in Python; gt seg is nearest-downsampled by ``[::stride]`` and gt dense
resized bilinearly without antialiasing. Every term runs in the dtype of
its inputs (fp32 in training, fp64 in the parity tests).

Under a data mesh each rank computes its *share* of each term on its block
of the global batch: shares averaged over the ranks make the global batch's
loss, and their gradients, averaged as the train step averages them, make
its gradient. A per-sample mean over equal blocks is its own share. The
weighted cross-entropy and Lovász-softmax are not per-sample means: their
normalizers, sort and class presence are the global batch's, and their
shares carry the factor ``world``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.parallel.mesh import Mesh


def smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Piecewise MSE/L1 with a 0.01 threshold: per-sample mean over the
    flattened residual, then the batch mean."""
    b = x.shape[0]
    z = (x - y).reshape(b, -1)
    az = z.abs()
    per_elem = torch.where(az < 0.01, 0.5 * z * z, 0.01 * (az - 0.005))
    return per_elem.mean(-1).mean()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / max(||v||, eps)``, clamped inside the sqrt: clamping after it
    gives a 0 * inf = NaN gradient on exactly degenerate rows. The bound is
    a Python scalar, so no host value is copied to the device."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return v / torch.sqrt(torch.clamp_min(sq, eps * eps))


def _face_edges(coord: torch.Tensor, faces):
    """Per-face edge vectors ``(v1 - v0, v2 - v0, v2 - v1)``, each
    (B, F, 3), by indexing the vertices with the faces (an int tensor, on
    the device already in training: ``ManoModel.faces``)."""
    f = torch.as_tensor(faces, device=coord.device)
    v0, v1, v2 = coord[:, f[:, 0]], coord[:, f[:, 1]], coord[:, f[:, 2]]
    return v1 - v0, v2 - v0, v2 - v1


def normal_vector_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                       faces) -> torch.Tensor:
    """Mean |cos| between the predicted edges and the gt face normals."""
    e1o, e2o, e3o = _face_edges(coord_out, faces)
    e1g, e2g, _ = _face_edges(coord_gt, faces)
    ng = _normalize(torch.linalg.cross(_normalize(e1g), _normalize(e2g),
                                       dim=-1))
    cos = [torch.sum(_normalize(e) * ng, dim=-1).abs()
           for e in (e1o, e2o, e3o)]
    return torch.stack(cos).mean()


def edge_length_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                     faces) -> torch.Tensor:
    """Mean |edge-length difference| over the faces' three edges."""
    def elen(e):
        return torch.sqrt(torch.sum(e * e, dim=-1) + 1e-12)

    diffs = [(elen(a) - elen(b)).abs()
             for a, b in zip(_face_edges(coord_out, faces),
                             _face_edges(coord_gt, faces))]
    return torch.stack(diffs).mean()


def _parallel(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.parallel


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights, mesh: Mesh | None = None
                           ) -> torch.Tensor:
    """``nn.CrossEntropyLoss(weight=w)``: the weighted mean of the per-pixel
    NLL, normalized by the summed weights of the labelled classes.

    logits: (B, H, W, C); labels: (B, H, W) int. The weights are Python
    floats, so no host-to-device copy is made. Under ``mesh`` the
    normalizer is the global batch's (it carries no gradient) and the
    result is this rank's share."""
    lab = labels.long()
    nll = -F.log_softmax(logits, dim=-1).gather(-1, lab[..., None])[..., 0]
    pix_w = torch.zeros_like(nll)
    for c, w in enumerate(class_weights):
        pix_w = pix_w + float(w) * (lab == c).to(nll.dtype)
    if not _parallel(mesh):
        return torch.sum(nll * pix_w) / torch.sum(pix_w)
    return (torch.sum(nll * pix_w) / mesh.sum(torch.sum(pix_w))
            * mesh.world)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the sorted errors,
    per leading index; ``gt_sorted`` is (..., N) sorted on its last axis."""
    gts = gt_sorted.sum(-1, keepdim=True)
    # the labels are 0 or 1, so their running counts are integers: counted
    # in int64, exact as the float cumsum is and deterministic on the card,
    # where a float cumsum has no deterministic form
    fg_count = gt_sorted.long().cumsum(-1).to(gt_sorted.dtype)
    bg_count = (1 - gt_sorted.long()).cumsum(-1).to(gt_sorted.dtype)
    intersection = gts - fg_count
    union = gts + bg_count
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   mesh: Mesh | None = None) -> torch.Tensor:
    """Multi-class Lovász-softmax surrogate, classes present only, over the
    whole batch.

    probas: (B, H, W, C); the reference feeds raw logits here and so does
    the port. labels: (B, H, W) int. Every class is computed and masked by
    presence. The errors of each class are sorted descending by a stable
    sort of their negation, as ``jax.lax.sort`` does; only detached values
    are sorted, and the Lovász weights are detached.

    Under ``mesh`` the detached errors and the labels of every rank are
    gathered in batch order, so the sort, the weights and the classes
    present are the global batch's; the weighted sum stays on this rank's
    pixels, and the result is this rank's share."""
    c = probas.shape[-1]
    flat = probas.reshape(-1, c).t()                       # (C, N)
    fg = F.one_hot(labels.reshape(-1).long(), c).t().to(flat.dtype)
    errors = (fg - flat).abs()
    all_errors, all_fg, lo = errors.detach(), fg, 0
    if _parallel(mesh):
        all_errors = mesh.gather_rows(all_errors.t()).t()
        all_fg = mesh.gather_rows(fg.t()).t()
        lo = mesh.rank * fg.shape[1]
    order = torch.argsort(-all_errors, dim=-1, stable=True)
    grad = _lovasz_grad(all_fg.gather(-1, order))
    w = torch.empty_like(grad).scatter_(-1, order, grad)   # unsorted
    w = w[:, lo:lo + fg.shape[1]]
    losses = torch.sum(torch.relu(errors) * w.detach(), dim=-1)
    present = (all_fg.sum(-1) > 0).to(losses.dtype)
    loss = torch.sum(losses * present) / torch.clamp(present.sum(), min=1.0)
    return loss * mesh.world if _parallel(mesh) else loss


# The per-stage outputs the coordinate losses read.
_STAGE_KEYS = ("pd_joint_uv_left", "pd_joint_uv_right", "pd_mesh_uv_left",
               "pd_mesh_uv_right", "pd_joint_xyz_left", "pd_joint_xyz_right",
               "pd_mesh_xyz_left", "pd_mesh_xyz_right", "pd_offset")


def dir_losses(outputs: dict, targets: dict, cfg: ModelConfig,
               faces_left, faces_right, fused_stages: bool = False,
               mesh: Mesh | None = None) -> dict:
    """The full DIR loss dict; its values sum to the training loss (under
    ``mesh``: this rank's shares, see the module's docstring).

    fused_stages: each per-stage term is computed once over the stages
    stacked along the batch axis and multiplied by their number (every stage
    has the same element count, so this is the sum over stages); the dict
    then holds ``*_all`` keys instead of per-stage ones. The train step
    uses it.

    targets (batch-first, NHWC, fp32 unless noted):
        joint_2d_{left,right}: (B, 21, 3) [-1, 1] uv + depth
        mesh_2d_{left,right}: (B, 778, 3)
        joint_3d_{left,right}: (B, 21, 3) meters (camera frame)
        mesh_3d_{left,right}: (B, 778, 3)
        center_{left,right}: (B, 1, 3) MCP joint (9) position
        seg: (B, 256, 256) int {0 bg, 1 left, 2 right}
        dense: (B, 256, 256, 3) dense correspondence colors in [0, 1]
    """
    s = cfg.coord_scale
    loss = {}

    # seg / dense heads at the map size
    seg_logits = outputs["seg"]
    map_size = seg_logits.shape[1]
    stride = targets["seg"].shape[1] // map_size
    gt_seg = targets["seg"][:, ::stride, ::stride]
    gt_dense = F.interpolate(
        targets["dense"].permute(0, 3, 1, 2), size=(map_size, map_size),
        mode="bilinear", align_corners=False,
        antialias=False).permute(0, 2, 3, 1)
    loss["seg"] = weighted_cross_entropy(
        seg_logits, gt_seg, cfg.seg_class_weights, mesh) * \
        cfg.seg_weight * cfg.dense_weight
    loss["dense"] = smooth_l1(outputs["dense"], gt_dense) * cfg.dense_weight
    loss["lovasz"] = lovasz_softmax(seg_logits, gt_seg, mesh) * \
        cfg.lovasz_weight * cfg.dense_weight

    # per-stage coordinate losses
    cl = targets["center_left"]
    cr = targets["center_right"]
    gt_j_l = (targets["joint_3d_left"] - cl) / s
    gt_j_r = (targets["joint_3d_right"] - cr) / s
    gt_m_l = (targets["mesh_3d_left"] - cl) / s
    gt_m_r = (targets["mesh_3d_right"] - cr) / s
    gt_offset = ((cr - cl) / s)[:, 0]
    uv_j_l = targets["joint_2d_left"][:, :, :2]
    uv_j_r = targets["joint_2d_right"][:, :, :2]
    uv_m_l = targets["mesh_2d_left"][:, :, :2]
    uv_m_r = targets["mesh_2d_right"][:, :, :2]

    cw = cfg.coord_weight
    if fused_stages:
        n = len(outputs["stages"])
        st = {k: torch.cat([o[k] for o in outputs["stages"]], dim=0)
              for k in _STAGE_KEYS}

        def tile(x):
            return torch.cat([x] * n, dim=0)

        loss["joint_left_uv_all"] = smooth_l1(
            st["pd_joint_uv_left"], tile(uv_j_l)) * cw * n
        loss["joint_right_uv_all"] = smooth_l1(
            st["pd_joint_uv_right"], tile(uv_j_r)) * cw * n
        loss["mesh_left_uv_all"] = smooth_l1(
            st["pd_mesh_uv_left"], tile(uv_m_l)) * cw * n
        loss["mesh_right_uv_all"] = smooth_l1(
            st["pd_mesh_uv_right"], tile(uv_m_r)) * cw * n

        j_l = st["pd_joint_xyz_left"] / s
        j_r = st["pd_joint_xyz_right"] / s
        m_l = st["pd_mesh_xyz_left"] / s
        m_r = st["pd_mesh_xyz_right"] / s
        gm_l, gm_r = tile(gt_m_l), tile(gt_m_r)
        loss["joint_left_xyz_all"] = smooth_l1(j_l, tile(gt_j_l)) * cw * n
        loss["joint_right_xyz_all"] = smooth_l1(j_r, tile(gt_j_r)) * cw * n
        loss["mesh_left_xyz_all"] = smooth_l1(m_l, gm_l) * cw * n
        loss["mesh_right_xyz_all"] = smooth_l1(m_r, gm_r) * cw * n

        loss["edge_left_all"] = edge_length_loss(
            m_l, gm_l, faces_left) * cfg.edge_weight * n
        loss["edge_right_all"] = edge_length_loss(
            m_r, gm_r, faces_right) * cfg.edge_weight * n
        loss["normal_left_all"] = normal_vector_loss(
            m_l, gm_l, faces_left) * cfg.normal_weight * n
        loss["normal_right_all"] = normal_vector_loss(
            m_r, gm_r, faces_right) * cfg.normal_weight * n
        loss["offset_all"] = smooth_l1(st["pd_offset"],
                                       tile(gt_offset)) * cw * n
        return loss

    for i, out in enumerate(outputs["stages"]):
        loss[f"joint_left_uv_{i}"] = smooth_l1(
            out["pd_joint_uv_left"], uv_j_l) * cw
        loss[f"joint_right_uv_{i}"] = smooth_l1(
            out["pd_joint_uv_right"], uv_j_r) * cw
        loss[f"mesh_left_uv_{i}"] = smooth_l1(
            out["pd_mesh_uv_left"], uv_m_l) * cw
        loss[f"mesh_right_uv_{i}"] = smooth_l1(
            out["pd_mesh_uv_right"], uv_m_r) * cw

        j_l = out["pd_joint_xyz_left"] / s
        j_r = out["pd_joint_xyz_right"] / s
        m_l = out["pd_mesh_xyz_left"] / s
        m_r = out["pd_mesh_xyz_right"] / s
        loss[f"joint_left_xyz_{i}"] = smooth_l1(j_l, gt_j_l) * cw
        loss[f"joint_right_xyz_{i}"] = smooth_l1(j_r, gt_j_r) * cw
        loss[f"mesh_left_xyz_{i}"] = smooth_l1(m_l, gt_m_l) * cw
        loss[f"mesh_right_xyz_{i}"] = smooth_l1(m_r, gt_m_r) * cw

        loss[f"edge_left_{i}"] = edge_length_loss(
            m_l, gt_m_l, faces_left) * cfg.edge_weight
        loss[f"edge_right_{i}"] = edge_length_loss(
            m_r, gt_m_r, faces_right) * cfg.edge_weight
        loss[f"normal_left_{i}"] = normal_vector_loss(
            m_l, gt_m_l, faces_left) * cfg.normal_weight
        loss[f"normal_right_{i}"] = normal_vector_loss(
            m_r, gt_m_r, faces_right) * cfg.normal_weight

        loss[f"offset_{i}"] = smooth_l1(out["pd_offset"], gt_offset) * cw

    return loss


def total_loss(loss_dict: dict) -> torch.Tensor:
    """The training loss: the sum of the dict's values in its order."""
    return sum(loss_dict.values())
