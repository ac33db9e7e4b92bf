"""The DIR network (counterpart of ``dir_tpu/models/dir.py``): backbone ->
initial MANO regression -> two refinement stages -> seg/dense heads.

Module names follow the reference torch layout, so ``load_state_dict``
takes the weight bridge's output (``dir_tpu_torch/weights.py``) with
``strict=True``. The trunk runs in the configured dtype; MANO, geometry,
pooled statistics and the parameter heads run in fp32. The JAX
package's stop-gradients are ``.detach()`` calls here.

Public layouts are the JAX package's: the image goes in as NHWC
``(B, H, W, 3)``, seg/dense come out NHWC, joints ``(B, 21, 3)`` and
meshes ``(B, 778, 3)``. Inside, feature maps are NCHW in
``torch.channels_last`` memory format.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.mano.assets import ManoModel, stack_mano_pair
from dir_tpu_torch.mano.layer import mano_forward_pca6d_pair
from dir_tpu_torch.models.gcn import ResSimplePGCN
from dir_tpu_torch.models.layers import (BatchNorm2d, ConvHead, MLP1d,
                                         Residual, conv2d, upsample2x)
from dir_tpu_torch.models.resnet import ResNetPyramid
from dir_tpu_torch.models.transformer import STE
from dir_tpu_torch.ops.bone_splat import bone_splat, bone_splat_plain
from dir_tpu_torch.ops.projection import ortho_project
from dir_tpu_torch.ops.quant import ActAmax, module_quant_conv
from dir_tpu_torch.ops.sampling import grid_sample_nhwc
from dir_tpu_torch.ops.splat_conv import fused_splat_conv


def _head32(x: torch.Tensor) -> torch.Tensor:
    """At least fp32: parameter heads never run in the bf16 trunk dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _mano_and_project(pair: ManoModel, para_left: torch.Tensor,
                      para_right: torch.Tensor, root_joint: int) -> dict:
    """Both MANO hands (one call over a hand axis of size 2) and the
    weak-perspective projection, from the (B, 64) parameter vectors
    [6D root + 45 PCA | 10 betas | scale, tx, ty]."""
    pose_l, beta_l, cam_l = torch.split(para_left, [51, 10, 3], dim=-1)
    pose_r, beta_r, cam_r = torch.split(para_right, [51, 10, 3], dim=-1)
    verts, joints = mano_forward_pca6d_pair(
        pair, torch.stack([pose_l, pose_r]), torch.stack([beta_l, beta_r]),
        center_idx=root_joint)
    mesh_l, mesh_r = verts[0], verts[1]
    joint_l, joint_r = joints[0], joints[1]
    return {
        "pd_mano_para_left": para_left,
        "pd_mano_para_right": para_right,
        "pd_proj_left": cam_l,
        "pd_proj_right": cam_r,
        "pd_mesh_xyz_left": mesh_l,
        "pd_mesh_xyz_right": mesh_r,
        "pd_joint_xyz_left": joint_l,
        "pd_joint_xyz_right": joint_r,
        "pd_joint_uv_left": ortho_project(cam_l[:, 0], cam_l[:, 1:], joint_l),
        "pd_joint_uv_right": ortho_project(cam_r[:, 0], cam_r[:, 1:], joint_r),
        "pd_mesh_uv_left": ortho_project(cam_l[:, 0], cam_l[:, 1:], mesh_l),
        "pd_mesh_uv_right": ortho_project(cam_r[:, 0], cam_r[:, 1:], mesh_r),
    }


class AttentionPool(ConvHead):
    """Spatial-attention pooling: a sigmoid map from Conv3x3-BN-ReLU-Conv1x1,
    then the attention-weighted mean of the features, in fp32."""

    def __init__(self, ch: int, dtype=torch.float32,
                 quant_eval: bool = False, quant_static: bool = False):
        super().__init__(ch, ch // 2, 1, dtype=dtype, quant_eval=quant_eval,
                         quant_static=quant_static)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(_head32(super().forward(feat)))
        num = torch.sum(_head32(feat) * a, dim=(2, 3))
        den = torch.sum(a, dim=(2, 3)) + 1e-8
        return num / den


class InitRegressor(nn.Module):
    """Initial MANO parameter regression from c4."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        c4 = cfg.backbone_dims[3]
        self.root_joint = cfg.root_joint
        q, qs = cfg.quant_aux_eval, cfg.quant_static
        self.attention_left = AttentionPool(c4, dtype, q, qs)
        self.attention_right = AttentionPool(c4, dtype, q, qs)
        self.mano_left = nn.Linear(c4, cfg.mano_param_dim)
        self.mano_right = nn.Linear(c4, cfg.mano_param_dim)
        self.offset = nn.Linear(c4, 3)

    def forward(self, feat: torch.Tensor, pair: ManoModel) -> dict:
        pd_offset = self.offset(torch.mean(_head32(feat), dim=(2, 3)))
        para_left = self.mano_left(self.attention_left(feat))
        para_right = self.mano_right(self.attention_right(feat))
        out = _mano_and_project(pair, para_left, para_right, self.root_joint)
        out["pd_offset"] = pd_offset
        return out


class RegressorOffset(nn.Module):
    """Iterative MANO head: flattened joint features plus the detached
    previous parameters predict the new parameter vector (fp32)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        flat = cfg.joint_num * cfg.joint_dim
        self.root_joint = cfg.root_joint
        self.mano_left = nn.Linear(flat + cfg.mano_param_dim,
                                   cfg.mano_param_dim)
        self.mano_right = nn.Linear(flat + cfg.mano_param_dim,
                                    cfg.mano_param_dim)
        self.offset = nn.Linear(2 * flat + 3, 3)

    def forward(self, feat_l, feat_r, prev_para_l, prev_para_r, prev_offset,
                pair: ManoModel) -> dict:
        b = feat_l.shape[0]
        flat_l = _head32(feat_l.reshape(b, -1))
        flat_r = _head32(feat_r.reshape(b, -1))
        pd_offset = self.offset(torch.cat([flat_l, flat_r, prev_offset], -1))
        para_left = self.mano_left(
            torch.cat([flat_l, prev_para_l.detach()], -1))
        para_right = self.mano_right(
            torch.cat([flat_r, prev_para_r.detach()], -1))
        out = _mano_and_project(pair, para_left, para_right, self.root_joint)
        out["pd_offset"] = pd_offset
        return out


class ImgToJointFeature(nn.Module):
    """Per-joint MLP over image features sampled at the 2D joints."""

    def __init__(self, in_ch: int, out_dim: int, dtype):
        super().__init__()
        self.filters = MLP1d(in_ch, out_dim, out_dim, dtype)

    def forward(self, sampled: torch.Tensor) -> torch.Tensor:
        return self.filters(sampled)


class RefineStage(nn.Module):
    """One decoupled refinement stage: joint-space interaction (image
    sampling, GCN, cross-hand transformer), the MANO update, and the
    image-space re-projection: through the factored splat conv
    (``cfg.fused_splat_conv``), or through the two materialized bone splats
    (kernel K5 with ``cfg.use_pallas_splat``, else its plain version), their
    concat and the 3x3 fusion conv. Both branches hold the same parameters.

    Returns ``(result, feats)``; ``feats["img_feat"]`` is the fused map,
    and with ``want_vis`` on the materialized branch ``feats["vis_img_feat"]``
    is the sum of the two splat maps (for visualization only; the factored
    branch never builds them)."""

    def __init__(self, cfg: ModelConfig, in_ch: int, distance: float, dtype):
        super().__init__()
        emd, jdim = cfg.embed_dim, cfg.joint_dim
        self.cfg = cfg
        self.dtype = dtype
        self.distance = float(distance)
        for side in ("left", "right"):
            self.add_module(f"img2joint_{side}",
                            ImgToJointFeature(in_ch, emd, dtype))
            self.add_module(f"pos_emb_{side}", MLP1d(3, emd, emd, dtype))
            self.add_module(f"gcn_{side}",
                            ResSimplePGCN(emd, cfg.gcn_layers, dtype=dtype))
        self.global_pos_emb = MLP1d(3, emd, emd, dtype)
        self.interaction = STE(2 * cfg.joint_num, emd, jdim, cfg.ste_depth,
                               cfg.ste_heads, cfg.ste_mlp_ratio, dtype)
        self.proj_feat_emb = MLP1d(jdim, jdim, jdim, dtype)
        self.fusion = nn.Sequential(
            nn.Conv2d(2 * 20 * jdim, in_ch, 3, padding=1),
            BatchNorm2d(in_ch), nn.ReLU(), nn.Conv2d(in_ch, in_ch, 1))
        self.regressor = RegressorOffset(cfg)
        # cfg.quant_aux_eval: the 1x1 fusion conv in int8
        self.quant_stats = (ActAmax(("fusion_conv2_in",))
                            if cfg.quant_aux_eval else None)

    def forward(self, img_feat: torch.Tensor, prev: dict, pair: ManoModel,
                want_vis: bool = False):
        cfg, dt = self.cfg, self.dtype
        scale = cfg.coord_scale
        xyz_l = prev["pd_joint_xyz_left"].detach()
        xyz_r = prev["pd_joint_xyz_right"].detach()
        uv_l = prev["pd_joint_uv_left"].detach()
        uv_r = prev["pd_joint_uv_right"].detach()
        para_l = prev["pd_mano_para_left"].detach()
        para_r = prev["pd_mano_para_right"].detach()
        offset = prev["pd_offset"].detach()

        # joint-space interaction; one sampling pass for both hands
        sampled = grid_sample_nhwc(_nhwc(img_feat), torch.cat([uv_l, uv_r], 1))
        jif_l = self.img2joint_left(sampled[:, :cfg.joint_num])
        jif_r = self.img2joint_right(sampled[:, cfg.joint_num:])
        feat_l = self.gcn_left(jif_l + self.pos_emb_left(xyz_l / scale))
        feat_r = self.gcn_right(jif_r + self.pos_emb_right(xyz_r / scale))
        off = offset[:, None, :]
        feat_l = feat_l + self.global_pos_emb(xyz_l / scale - off / 2)
        feat_r = feat_r + self.global_pos_emb(xyz_r / scale + off / 2)
        tokens = self.interaction(torch.cat([feat_l, feat_r], dim=1))
        feat_l, feat_r = torch.chunk(tokens, 2, dim=1)

        result = self.regressor(feat_l, feat_r, para_l, para_r, offset, pair)

        # image-space re-projection
        pf_l = self.proj_feat_emb(feat_l)
        pf_r = self.proj_feat_emb(feat_r)
        conv1, bn, _, conv2 = self.fusion
        size = img_feat.shape[2]
        feats = {"joint_feat_left": feat_l, "joint_feat_right": feat_r}
        if cfg.fused_splat_conv:
            fused = _nchw(fused_splat_conv(
                result["pd_joint_uv_left"], result["pd_joint_uv_right"],
                pf_l, pf_r, conv1.weight.permute(2, 3, 1, 0).to(dt),
                conv1.bias, size, self.distance).to(dt))
        else:
            splat = bone_splat if cfg.use_pallas_splat else bone_splat_plain
            splat_l = splat(result["pd_joint_uv_left"], pf_l, size,
                            self.distance)
            splat_r = splat(result["pd_joint_uv_right"], pf_r, size,
                            self.distance)
            # NHWC concat: a channels_last NCHW view, no copy before cuDNN
            fused = conv2d(_nchw(torch.cat([splat_l, splat_r], dim=-1)),
                           conv1, dt)
            if want_vis:
                feats["vis_img_feat"] = splat_l + splat_r
        fused = torch.relu(bn(fused))
        if cfg.quant_aux_eval and not self.training:
            feats["img_feat"] = _nchw(module_quant_conv(
                self.quant_stats, "fusion_conv2", _nhwc(fused), conv2,
                static=cfg.quant_static, out_dtype=dt))
        else:
            feats["img_feat"] = conv2d(fused, conv2, dt)
        return result, feats


class Decoder(nn.Module):
    """FPN-style decoder with two refinement stages and the seg/dense
    heads."""

    def __init__(self, cfg: ModelConfig, dtype):
        super().__init__()
        d = cfg.decoder_dim
        _, c2, c3, c4 = cfg.backbone_dims
        q = {"quant_eval": cfg.quant_decoder_eval,
             "quant_static": cfg.quant_static}
        self.skip_layer4 = Residual(c3, d, dtype, **q)
        self.fusion_layer4 = Residual(c4 + d, d, dtype, **q)
        self.enhance_layer4 = Residual(2 * d, d, dtype, **q)
        self.skip_layer3 = Residual(c2, d, dtype, **q)
        self.fusion_layer3 = Residual(2 * d, d, dtype, **q)
        self.enhance_layer3 = Residual(2 * d, d, dtype, **q)
        self.projecter_4 = RefineStage(cfg, d, cfg.stage_distances[0], dtype)
        self.projecter_3 = RefineStage(cfg, d, cfg.stage_distances[1], dtype)
        qa = {"quant_eval": cfg.quant_aux_eval,
              "quant_static": cfg.quant_static}
        self.conv_final = ConvHead(d, d, d, first_bias=False, dtype=dtype,
                                   quant_second=True, **qa)
        self.seg = ConvHead(d, d // 2, 3, dtype=dtype, **qa)
        self.dense = ConvHead(d, d // 2, 3, dtype=dtype, **qa)

    def forward(self, feats, init_out: dict, pair: ManoModel,
                want_vis: bool = False) -> dict:
        _, c2, c3, c4 = feats
        outputs = []

        # stage 1 at c3's resolution (16x16 at 256^2 input)
        c4_up = _nchw(upsample2x(_nhwc(c4)))
        fusion = self.fusion_layer4(c4_up, pair=self.skip_layer4(c3))
        result, stage_feats = self.projecter_4(fusion, init_out, pair)
        enhance = self.enhance_layer4(fusion, pair=stage_feats["img_feat"])
        outputs.append(result)

        # stage 2 at c2's resolution (32x32)
        c3_up = _nchw(upsample2x(_nhwc(enhance)))
        fusion = self.fusion_layer3(c3_up, pair=self.skip_layer3(c2))
        result, stage_feats = self.projecter_3(fusion, result, pair,
                                               want_vis)
        enhance = self.enhance_layer3(fusion, pair=stage_feats["img_feat"])
        outputs.append(result)

        x = self.conv_final(enhance)
        return {
            "result_list": outputs,
            "seg": _nhwc(_head32(self.seg(x))),
            "dense": _nhwc(_head32(self.dense(x))),
            "proj_feat": stage_feats.get("vis_img_feat"),
        }


class DIR(nn.Module):
    """Full DIR network. ``forward(img, mano_left, mano_right)`` takes an
    NHWC image batch and returns ``{"stages": [init, refine1, refine2],
    "seg": (B, 32, 32, 3), "dense": (B, 32, 32, 3)}``. With
    ``want_vis=True`` and the materialized splat branch
    (``cfg.fused_splat_conv=False``) it also returns ``"vis_img_feat"``,
    the last stage's summed splat maps (B, 32, 32, 20 * joint_dim); the JAX
    package computes that map inside its jitted program, where it costs
    nothing unless read, so here it is made only on request."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.backbone = ResNetPyramid(
            cfg.backbone_layers, dtype,
            fused_eval=cfg.fused_bottleneck_eval, stem=cfg.backbone_stem,
            fused_l2_bands=cfg.fused_l2_bands,
            quant_eval=cfg.quant_backbone_eval,
            quant_static=cfg.quant_static, quant_stem=cfg.quant_aux_eval,
            quant_fused=cfg.quant_fused,
            quant_fused_l2_bands=cfg.quant_fused_l2_bands)
        self.init_regressor = InitRegressor(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)

    def forward(self, img: torch.Tensor, mano_left: ManoModel,
                mano_right: ManoModel, want_vis: bool = False) -> dict:
        pair = stack_mano_pair(mano_left, mano_right)
        feats = self.backbone(_nchw(img))
        init_out = self.init_regressor(feats[-1], pair)
        decode = self.decoder(feats, init_out, pair, want_vis)
        out = {
            "stages": [init_out] + decode["result_list"],
            "seg": decode["seg"],
            "dense": decode["dense"],
        }
        if decode["proj_feat"] is not None:
            out["vis_img_feat"] = decode["proj_feat"]
        return out
