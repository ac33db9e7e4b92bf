"""The plain reference of DIR (Ren et al., ICCV 2023): ResNet-50 pyramid,
attention-pooled initial MANO regression, two decoupled refine stages
(joint sampling, GCN, cross-hand transformer, MANO update, bone splat and
fusion conv) and the seg/dense heads.

Plain PyTorch in float32, no kernels, no caches, no batching tricks: the
benchmark's yardstick. It imports nothing of the measured program and
nothing of JAX. The module names and the parameter layout are those of the
published torch code, so one ``state_dict`` loads with ``strict=True``
into this model and into the program under test.

Departures from the program's forms, all exact in real arithmetic:
joints are sampled with ``F.grid_sample`` (the program multiplies by a
selection matrix), the decoder upsamples with ``F.interpolate`` (the
program writes the half-pixel taps out), and the splat and its fusion conv
are either materialized (``splat_conv="materialized"``, the published
form) or factored through the splat's rank-1 structure
(``splat_conv="factored"``, which a configuration may state).

``round_`` is applied to both operands of every trunk matrix product
(convolutions, token linears, graph convolutions, the factored splat
contraction). It is the identity for the reference; a lower precision put
in its place gives the control that a correct run must be told apart
from. The parameter heads, MANO, geometry, norms and attention's softmax
product stay in float32 as the published model keeps them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference import mano as mano_ref


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Rounded(nn.Module):
    """A module whose matrix products take ``round_`` on their operands;
    the rounding is set on the whole tree by :func:`set_rounding`."""

    round_ = staticmethod(identity)

    def conv(self, x, conv: nn.Conv2d, padding=None):
        r = self.round_
        return F.conv2d(r(x), r(conv.weight), conv.bias, conv.stride,
                        conv.padding if padding is None else padding)

    def lin(self, x, weight, bias):
        r = self.round_
        return F.linear(r(x), r(weight), bias)


def set_rounding(model: nn.Module, round_) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Rounded):
            m.round_ = round_
    return model


class ConvHolder(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


class Residual(_Rounded):
    """Pre-activation bottleneck residual (BN-ReLU-1x1, BN-ReLU-3x3,
    BN-ReLU-1x1), with a 1x1 skip conv where the widths differ."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        half = cout // 2
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = ConvHolder(cin, half, 1)
        self.bn2 = nn.BatchNorm2d(half)
        self.conv2 = ConvHolder(half, half, 3)
        self.bn3 = nn.BatchNorm2d(half)
        self.conv3 = ConvHolder(half, cout, 1)
        self.skip_layer = ConvHolder(cin, cout, 1) if cin != cout else None

    def forward(self, x, pair=None):
        if pair is not None:
            x = torch.cat([x, pair], 1)
        skip = x if self.skip_layer is None else self.conv(
            x, self.skip_layer.conv)
        out = self.conv(torch.relu(self.bn1(x)), self.conv1.conv)
        out = self.conv(torch.relu(self.bn2(out)), self.conv2.conv)
        out = self.conv(torch.relu(self.bn3(out)), self.conv3.conv)
        return out + skip


class ConvHead(nn.Sequential, _Rounded):
    """Conv3x3 - BN - ReLU - Conv1x1 (keys 0, 1, 3)."""

    def __init__(self, cin: int, mid: int, out: int, first_bias=True):
        super().__init__(nn.Conv2d(cin, mid, 3, padding=1, bias=first_bias),
                         nn.BatchNorm2d(mid), nn.ReLU(),
                         nn.Conv2d(mid, out, 1))

    def forward(self, x):
        return self.conv(torch.relu(self[1](self.conv(x, self[0]))), self[3])


class MLP1d(nn.Sequential, _Rounded):
    """Conv1d(k=1) - BN1d - ReLU - Conv1d(k=1) over (B, N, C) tokens."""

    def __init__(self, cin: int, hidden: int, out: int):
        super().__init__(nn.Conv1d(cin, hidden, 1), nn.BatchNorm1d(hidden),
                         nn.ReLU(), nn.Conv1d(hidden, out, 1))

    def forward(self, x):
        x = self.lin(x, self[0].weight[:, :, 0], self[0].bias)
        x = torch.relu(self[1](x.transpose(1, 2)).transpose(1, 2))
        return self.lin(x, self[3].weight[:, :, 0], self[3].bias)


class Bottleneck(_Rounded):
    """torchvision v1.5 bottleneck: the stride on the 3x3 conv."""

    def __init__(self, cin: int, planes: int, stride: int, down: bool):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = nn.Sequential(
            nn.Conv2d(cin, out, 1, stride, bias=False),
            nn.BatchNorm2d(out)) if down else None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv(x, self.conv1)))
        out = torch.relu(self.bn2(self.conv(out, self.conv2)))
        out = self.bn3(self.conv(out, self.conv3))
        idt = x if self.downsample is None else self.downsample[1](
            self.conv(x, self.downsample[0]))
        return torch.relu(out + idt)


class ResNetPyramid(_Rounded):
    """ResNet-50 (7x7/2 stem, 3x3/2 max pool) returning c1..c4."""

    def __init__(self, layers=(3, 4, 6, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin = 64
        for i, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            stride = 1 if i == 0 else 2
            seq = []
            for b in range(blocks):
                down = b == 0 and (stride != 1 or cin != planes * 4)
                seq.append(Bottleneck(cin, planes, stride if b == 0 else 1,
                                      down))
                cin = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*seq))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv(x, self.conv1)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            feats.append(x)
        return feats


HAND_EDGES = ((0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
              (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14),
              (14, 15), (15, 16), (0, 17), (17, 18), (18, 19), (19, 20))


class PGraphConv(_Rounded):
    """Per-node weights on two branches (self loops, one-hop neighbours),
    each mixed by a softmax over learned edge scores."""

    def __init__(self, features: int, joints: int = 21):
        super().__init__()
        adj = np.zeros((joints, joints), np.float32)
        for i, j in HAND_EDGES:
            adj[i, j] = adj[j, i] = 1.0
        self.W = nn.Parameter(torch.zeros(2, joints, features, features))
        self.e_0 = nn.Parameter(torch.ones(1, joints))
        self.e_1 = nn.Parameter(torch.ones(1, int(adj.sum())))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("adj", torch.from_numpy(adj), persistent=False)

    def forward(self, x):
        j = self.W.shape[1]
        eye = torch.eye(j, device=x.device, dtype=torch.bool)
        s0 = torch.full((j, j), -9e15, device=x.device)
        s0 = s0.masked_scatter(eye, self.e_0[0])
        s1 = torch.full((j, j), -9e15, device=x.device)
        s1 = s1.masked_scatter(self.adj > 0, self.e_1[0])
        a0, a1 = torch.softmax(s0, 1), torch.softmax(s1, 1)
        r = self.round_
        h0 = torch.einsum("bjc,jcd->bjd", r(x), r(self.W[0]))
        h1 = torch.einsum("bjc,jcd->bjd", r(x), r(self.W[1]))
        return a0 @ h0 + a1 @ h1 + self.bias


class GraphConvBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.gconv = PGraphConv(features)
        self.bn = nn.BatchNorm1d(features)

    def forward(self, x):
        return torch.relu(self.bn(self.gconv(x).transpose(1, 2))
                          .transpose(1, 2))


class ResSimplePGCN(nn.Module):
    def __init__(self, features: int, layers: int):
        super().__init__()
        self.gconv_layers = nn.ModuleList(GraphConvBlock(features)
                                          for _ in range(layers))

    def forward(self, x):
        for layer in self.gconv_layers:
            x = layer(x)
        return x


class Attention(_Rounded):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.heads
        q, k, v = self.lin(x, self.qkv.weight, self.qkv.bias).reshape(
            b, n, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) * hd ** -0.5, -1)
        out = att @ v                                   # (B, H, N, D)
        return self.lin(out.transpose(1, 2).reshape(b, n, c),
                        self.proj.weight, self.proj.bias)


class Mlp(_Rounded):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        x = F.gelu(self.lin(x, self.fc1.weight, self.fc1.bias))
        return self.lin(x, self.fc2.weight, self.fc2.bias)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * ratio))

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class STE(_Rounded):
    """Spatial transformer over the 42 joint tokens: blocks 1..depth-1 run
    (block 0 is never built), one shared norm after each."""

    def __init__(self, tokens: int, dim: int, out: int, depth: int,
                 heads: int, ratio: float):
        super().__init__()
        self.spatial_pos_embed = nn.Parameter(torch.zeros(1, tokens, dim))
        self.STEblocks = nn.ModuleDict({str(i): Block(dim, heads, ratio)
                                        for i in range(1, depth)})
        self.spatial_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                                  nn.Linear(dim, out))

    def forward(self, x):
        x = x + self.spatial_pos_embed
        for blk in self.STEblocks.values():
            x = self.spatial_norm(blk(x))
        return self.lin(self.head[0](x), self.head[1].weight,
                        self.head[1].bias)


def mano_and_project(pair, para_l, para_r, root: int) -> dict:
    """Both hands' MANO from [6D root + 45 PCA | 10 betas | s, tx, ty], and
    the weak-perspective projection."""
    out = {"pd_mano_para_left": para_l, "pd_mano_para_right": para_r}
    for side, para in (("left", para_l), ("right", para_r)):
        pose, beta, cam = torch.split(para, [51, 10, 3], dim=-1)
        verts, joints = mano_ref.forward_pca6d(pair[side], pose, beta, root)
        out[f"pd_proj_{side}"] = cam
        out[f"pd_mesh_xyz_{side}"] = verts
        out[f"pd_joint_xyz_{side}"] = joints
        for what, pts in (("joint", joints), ("mesh", verts)):
            out[f"pd_{what}_uv_{side}"] = (cam[:, 0, None, None] * pts[..., :2]
                                           + cam[:, None, 1:])
    return out


class AttentionPool(ConvHead):
    def __init__(self, ch: int):
        super().__init__(ch, ch // 2, 1)

    def forward(self, feat):
        a = torch.sigmoid(super().forward(feat))
        return (feat * a).sum((2, 3)) / (a.sum((2, 3)) + 1e-8)


class InitRegressor(nn.Module):
    def __init__(self, c4: int, para: int, root: int):
        super().__init__()
        self.root = root
        self.attention_left = AttentionPool(c4)
        self.attention_right = AttentionPool(c4)
        self.mano_left = nn.Linear(c4, para)
        self.mano_right = nn.Linear(c4, para)
        self.offset = nn.Linear(c4, 3)

    def forward(self, feat, pair):
        out = mano_and_project(
            pair, self.mano_left(self.attention_left(feat)),
            self.mano_right(self.attention_right(feat)), self.root)
        out["pd_offset"] = self.offset(feat.mean((2, 3)))
        return out


class RegressorOffset(nn.Module):
    def __init__(self, flat: int, para: int, root: int):
        super().__init__()
        self.root = root
        self.mano_left = nn.Linear(flat + para, para)
        self.mano_right = nn.Linear(flat + para, para)
        self.offset = nn.Linear(2 * flat + 3, 3)

    def forward(self, fl, fr, para_l, para_r, offset, pair):
        fl, fr = fl.flatten(1), fr.flatten(1)
        out = mano_and_project(
            pair, self.mano_left(torch.cat([fl, para_l.detach()], -1)),
            self.mano_right(torch.cat([fr, para_r.detach()], -1)), self.root)
        out["pd_offset"] = self.offset(torch.cat([fl, fr, offset], -1))
        return out


class ImgToJointFeature(nn.Module):
    def __init__(self, cin: int, out: int):
        super().__init__()
        self.filters = MLP1d(cin, out, out)

    def forward(self, x):
        return self.filters(x)


PARENT = (0, 1, 2, 3, 0, 5, 6, 7, 0, 9, 10, 11, 0, 13, 14, 15, 0, 17, 18, 19)
CHILD = tuple(range(1, 21))


def splat_weights(uv, size: int, distance: float):
    """Per pixel centre and bone, the weights of the bone's two endpoint
    features: 1 - (distance to the endpoint) / (sum of both), where the
    pixel lies closer than ``distance`` pixels to the bone's segment, and
    0 elsewhere. (B, S, S, 20) each."""
    p_uv = (uv + 1.0) / 2.0 * size
    a = p_uv[:, PARENT][:, None]                       # (B, 1, 20, 2)
    b = p_uv[:, CHILD][:, None]
    c = torch.arange(size, dtype=uv.dtype, device=uv.device) + 0.5
    yy, xx = torch.meshgrid(c, c, indexing="ij")
    p = torch.stack([xx, yy], -1).reshape(1, -1, 1, 2)
    ab = b - a
    length = torch.hypot(ab[..., 0], ab[..., 1])[..., None]
    d = ab / torch.where(length > 0, length, torch.ones_like(length))
    h = torch.clamp(torch.maximum(((a - p) * d).sum(-1),
                                  ((p - b) * d).sum(-1)), min=0.0)
    pa = p - a
    seg = torch.hypot(h, pa[..., 0] * d[..., 1] - pa[..., 1] * d[..., 0])
    da, db = (p - a).norm(dim=-1), (p - b).norm(dim=-1)
    mask = (seg < distance) & (length[..., 0] > 0)
    den = torch.where(da + db > 0, da + db, torch.ones_like(da))
    wa = torch.where(mask, 1.0 - da / den, torch.zeros_like(da))
    wb = torch.where(mask, 1.0 - db / den, torch.zeros_like(db))
    n = uv.shape[0]
    return wa.reshape(n, size, size, 20), wb.reshape(n, size, size, 20)


def splat(uv, feat, size: int, distance: float):
    """The materialized bone splat: (B, S, S, 20 * C), bone-major."""
    wa, wb = splat_weights(uv, size, distance)
    out = (wa[..., None] * feat[:, PARENT][:, None, None]
           + wb[..., None] * feat[:, CHILD][:, None, None])
    return out.reshape(*out.shape[:3], -1)


class RefineStage(_Rounded):
    def __init__(self, cfg: dict, cin: int, distance: float):
        super().__init__()
        emd, jdim, nj = cfg["embed_dim"], cfg["joint_dim"], cfg["joint_num"]
        self.nj, self.distance = nj, float(distance)
        self.scale = cfg["coord_scale"]
        self.factored = cfg["splat_conv"] == "factored"
        for side in ("left", "right"):
            self.add_module(f"img2joint_{side}", ImgToJointFeature(cin, emd))
            self.add_module(f"pos_emb_{side}", MLP1d(3, emd, emd))
            self.add_module(f"gcn_{side}",
                            ResSimplePGCN(emd, cfg["gcn_layers"]))
        self.global_pos_emb = MLP1d(3, emd, emd)
        self.interaction = STE(2 * nj, emd, jdim, cfg["ste_depth"],
                               cfg["ste_heads"], cfg["ste_mlp_ratio"])
        self.proj_feat_emb = MLP1d(jdim, jdim, jdim)
        self.fusion = nn.Sequential(
            nn.Conv2d(2 * cfg["bone_num"] * jdim, cin, 3, padding=1),
            nn.BatchNorm2d(cin), nn.ReLU(), nn.Conv2d(cin, cin, 1))
        self.regressor = RegressorOffset(nj * jdim, cfg["mano_param_dim"],
                                         cfg["root_joint"])

    def fuse(self, uv_l, uv_r, pf_l, pf_r, size: int):
        """The 3x3 fusion conv over the two hands' splats."""
        conv = self.fusion[0]
        if not self.factored:
            maps = torch.cat([splat(uv_l, pf_l, size, self.distance),
                              splat(uv_r, pf_r, size, self.distance)], -1)
            return self.conv(maps.permute(0, 3, 1, 2), conv)
        # the splat is rank-1 per bone and endpoint: contract the kernel
        # with the endpoint features first, then take the nine shifted
        # windows of the (B, S, S, 80) weight maps
        r = self.round_
        b, _, c = pf_l.shape
        wa_l, wb_l = splat_weights(uv_l, size, self.distance)
        wa_r, wb_r = splat_weights(uv_r, size, self.distance)
        w = torch.cat([wa_l, wb_l, wa_r, wb_r], -1)
        f = torch.cat([pf_l[:, PARENT], pf_l[:, CHILD], pf_r[:, PARENT],
                       pf_r[:, CHILD]], 1)                       # (B, 80, C)
        k = conv.weight.reshape(-1, 2, 20, c, 3, 3)
        k = torch.cat([k[:, 0], k[:, 0], k[:, 1], k[:, 1]], 1)   # (O,80,C,3,3)
        g = torch.einsum("ojcxy,bjc->bxyjo", r(k), r(f))
        pad = F.pad(w, (0, 0, 1, 1, 1, 1))
        wins = torch.cat([pad[:, y:y + size, x:x + size]
                          for y in range(3) for x in range(3)], -1)
        out = torch.bmm(r(wins.reshape(b, size * size, 720)),
                        r(g.reshape(b, 720, -1))) + conv.bias
        return out.reshape(b, size, size, -1).permute(0, 3, 1, 2)

    def forward(self, img_feat, prev: dict, pair):
        s, nj = self.scale, self.nj
        xyz_l = prev["pd_joint_xyz_left"].detach()
        xyz_r = prev["pd_joint_xyz_right"].detach()
        uv = torch.cat([prev["pd_joint_uv_left"],
                        prev["pd_joint_uv_right"]], 1).detach()
        offset = prev["pd_offset"].detach()
        sampled = F.grid_sample(img_feat, uv[:, None], mode="bilinear",
                                padding_mode="zeros", align_corners=False)
        sampled = sampled[:, :, 0].transpose(1, 2)              # (B, 42, C)
        fl = self.gcn_left(self.img2joint_left(sampled[:, :nj])
                           + self.pos_emb_left(xyz_l / s))
        fr = self.gcn_right(self.img2joint_right(sampled[:, nj:])
                            + self.pos_emb_right(xyz_r / s))
        off = offset[:, None]
        fl = fl + self.global_pos_emb(xyz_l / s - off / 2)
        fr = fr + self.global_pos_emb(xyz_r / s + off / 2)
        fl, fr = torch.chunk(self.interaction(torch.cat([fl, fr], 1)), 2, 1)
        result = self.regressor(fl, fr, prev["pd_mano_para_left"],
                                prev["pd_mano_para_right"], offset, pair)
        fused = self.fuse(result["pd_joint_uv_left"],
                          result["pd_joint_uv_right"], self.proj_feat_emb(fl),
                          self.proj_feat_emb(fr), img_feat.shape[2])
        fused = torch.relu(self.fusion[1](fused))
        return result, self.conv(fused, self.fusion[3])


def upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class Decoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["decoder_dim"]
        _, c2, c3, c4 = cfg["backbone_dims"]
        self.skip_layer4 = Residual(c3, d)
        self.fusion_layer4 = Residual(c4 + d, d)
        self.enhance_layer4 = Residual(2 * d, d)
        self.skip_layer3 = Residual(c2, d)
        self.fusion_layer3 = Residual(2 * d, d)
        self.enhance_layer3 = Residual(2 * d, d)
        dist = cfg["stage_distances"]
        self.projecter_4 = RefineStage(cfg, d, dist[0])
        self.projecter_3 = RefineStage(cfg, d, dist[1])
        self.conv_final = ConvHead(d, d, d, first_bias=False)
        self.seg = ConvHead(d, d // 2, 3)
        self.dense = ConvHead(d, d // 2, 3)

    def forward(self, feats, init: dict, pair):
        _, c2, c3, c4 = feats
        fusion = self.fusion_layer4(upsample2x(c4), pair=self.skip_layer4(c3))
        r1, img = self.projecter_4(fusion, init, pair)
        enhance = self.enhance_layer4(fusion, pair=img)
        fusion = self.fusion_layer3(upsample2x(enhance),
                                    pair=self.skip_layer3(c2))
        r2, img = self.projecter_3(fusion, r1, pair)
        x = self.conv_final(self.enhance_layer3(fusion, pair=img))
        return [r1, r2], self.seg(x), self.dense(x)


class DIR(nn.Module):
    """``forward(img (B, H, W, 3), pair) -> {"stages": [init, refine1,
    refine2], "seg": (B, 32, 32, 3), "dense": (B, 32, 32, 3)}``; ``pair``
    is :func:`portbench.reference.mano.pair` of the two hands."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.backbone = ResNetPyramid(tuple(cfg["backbone_layers"]))
        self.init_regressor = InitRegressor(cfg["backbone_dims"][3],
                                            cfg["mano_param_dim"],
                                            cfg["root_joint"])
        self.decoder = Decoder(cfg)

    def forward(self, img, pair) -> dict:
        feats = self.backbone(img.permute(0, 3, 1, 2))
        init = self.init_regressor(feats[-1], pair)
        stages, seg, dense = self.decoder(feats, init, pair)
        return {"stages": [init] + stages, "seg": seg.permute(0, 2, 3, 1),
                "dense": dense.permute(0, 2, 3, 1)}
