"""Weight bridge: the JAX package's ``params``/``batch_stats`` trees (nested
dicts of numpy arrays) -> the port's ``state_dict``.

The port's own copy of the mapping table of the reference torch layout
(``dir_tpu/train/checkpoint.py:dir_mapping``) and of its inverse
transforms, so that ``DIR.load_state_dict(..., strict=True)`` takes the
result. Leaves absent from the trees (Residual skip convs of same-width
blocks) are skipped; STE block 0 is not in the table.

The optimizer's moments cross the same way (:func:`jax_opt_state_to_torch`:
``optax.adamw``'s mu and nu into ``torch.optim.AdamW``'s state), so a JAX
train state continues in the port.

State carried across as well: the JAX package's ``quant_stats`` collection
(the calibrated activation maxes of int8 static serving) and the port's
``ActAmax`` buffers are turned into each other by the same kind of table
(:func:`quant_mapping`), so both packages can serve with the same scales.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch


class Entry(NamedTuple):
    torch_key: str          # state_dict key
    path: Tuple[str, ...]   # path in the JAX tree
    kind: str               # transform kind
    collection: str         # "params" | "batch_stats" | "quant_stats"


def _conv2d(tkey, path, bias=True):
    out = [Entry(f"{tkey}.weight", path + ("kernel",), "conv2d", "params")]
    if bias:
        out.append(Entry(f"{tkey}.bias", path + ("bias",), "raw", "params"))
    return out


def _dense(tkey, path):
    return [Entry(f"{tkey}.weight", path + ("kernel",), "linear", "params"),
            Entry(f"{tkey}.bias", path + ("bias",), "raw", "params")]


def _conv1d_dense(tkey, path):
    return [Entry(f"{tkey}.weight", path + ("kernel",), "conv1d_dense",
                  "params"),
            Entry(f"{tkey}.bias", path + ("bias",), "raw", "params")]


def _bn(tkey, path):
    return [
        Entry(f"{tkey}.weight", path + ("scale",), "raw", "params"),
        Entry(f"{tkey}.bias", path + ("bias",), "raw", "params"),
        Entry(f"{tkey}.running_mean", path + ("mean",), "raw", "batch_stats"),
        Entry(f"{tkey}.running_var", path + ("var",), "raw", "batch_stats"),
    ]


def _ln(tkey, path):
    return [Entry(f"{tkey}.weight", path + ("scale",), "raw", "params"),
            Entry(f"{tkey}.bias", path + ("bias",), "raw", "params")]


def _residual(tpre, fpre):
    out = []
    for i in (1, 2, 3):
        out += _bn(f"{tpre}.bn{i}", fpre + (f"bn{i}",))
        out += _conv2d(f"{tpre}.conv{i}.conv", fpre + (f"conv{i}",))
    return out + _conv2d(f"{tpre}.skip_layer.conv", fpre + ("skip",))


def _mlp1d(tpre, fpre):
    return (_conv1d_dense(f"{tpre}.0", fpre + ("fc1",))
            + _bn(f"{tpre}.1", fpre + ("bn",))
            + _conv1d_dense(f"{tpre}.3", fpre + ("fc2",)))


def _bottleneck(tpre, fpre, has_down):
    out = []
    for i in (1, 2, 3):
        out += _conv2d(f"{tpre}.conv{i}", fpre + (f"conv{i}",), bias=False)
        out += _bn(f"{tpre}.bn{i}", fpre + (f"bn{i}",))
    if has_down:
        out += _conv2d(f"{tpre}.downsample.0", fpre + ("down_conv",),
                       bias=False)
        out += _bn(f"{tpre}.downsample.1", fpre + ("down_bn",))
    return out


def _resnet(layers):
    out = _conv2d("backbone.conv1", ("backbone", "conv1"), bias=False)
    out += _bn("backbone.bn1", ("backbone", "bn1"))
    for s, blocks in enumerate(layers):
        for b in range(blocks):
            out += _bottleneck(f"backbone.layer{s + 1}.{b}",
                               ("backbone", f"layer{s + 1}_{b}"),
                               has_down=b == 0)
    return out


def _gcn(tpre, fpre, num_layers=4):
    out = []
    for i in range(num_layers):
        g = f"{tpre}.gconv_layers.{i}"
        f = fpre + (f"layer{i}",)
        out += [
            Entry(f"{g}.gconv.W", f + ("gconv", "w"), "raw", "params"),
            Entry(f"{g}.gconv.e_0", f + ("gconv", "e0"), "squeeze0",
                  "params"),
            Entry(f"{g}.gconv.e_1", f + ("gconv", "e1"), "squeeze0",
                  "params"),
            Entry(f"{g}.gconv.bias", f + ("gconv", "bias"), "raw", "params"),
        ]
        out += _bn(f"{g}.bn", f + ("bn",))
    return out


def _ste(tpre, fpre, depth=4):
    out = [Entry(f"{tpre}.spatial_pos_embed", fpre + ("spatial_pos_embed",),
                 "raw", "params")]
    for i in range(1, depth):
        b = f"{tpre}.STEblocks.{i}"
        f = fpre + (f"block{i}",)
        out += _ln(f"{b}.norm1", f + ("norm1",))
        out += _dense(f"{b}.attn.qkv", f + ("attn", "qkv"))
        out += _dense(f"{b}.attn.proj", f + ("attn", "proj"))
        out += _ln(f"{b}.norm2", f + ("norm2",))
        out += _dense(f"{b}.mlp.fc1", f + ("mlp", "fc1"))
        out += _dense(f"{b}.mlp.fc2", f + ("mlp", "fc2"))
    out += _ln(f"{tpre}.spatial_norm", fpre + ("spatial_norm",))
    out += _ln(f"{tpre}.head.0", fpre + ("head_norm",))
    out += _dense(f"{tpre}.head.1", fpre + ("head",))
    return out


def _head(tpre, fpre):
    return (_conv2d(f"{tpre}.0", fpre + ("conv1",))
            + _bn(f"{tpre}.1", fpre + ("bn",))
            + _conv2d(f"{tpre}.3", fpre + ("conv2",)))


def _refine_stage(tpre, fpre):
    out = []
    for side in ("left", "right"):
        out += _mlp1d(f"{tpre}.img2joint_{side}.filters",
                      fpre + (f"img2joint_{side}", "filters"))
        out += _mlp1d(f"{tpre}.pos_emb_{side}", fpre + (f"pos_emb_{side}",))
        out += _gcn(f"{tpre}.gcn_{side}", fpre + (f"gcn_{side}",))
    out += _mlp1d(f"{tpre}.global_pos_emb", fpre + ("global_pos_emb",))
    out += _ste(f"{tpre}.interaction", fpre + ("interaction",))
    out += _mlp1d(f"{tpre}.proj_feat_emb", fpre + ("proj_feat_emb",))
    out += _conv2d(f"{tpre}.fusion.0", fpre + ("fusion_conv1",))
    out += _bn(f"{tpre}.fusion.1", fpre + ("fusion_bn",))
    out += _conv2d(f"{tpre}.fusion.3", fpre + ("fusion_conv2",))
    for name in ("mano_left", "mano_right", "offset"):
        out += _dense(f"{tpre}.regressor.{name}", fpre + ("regressor", name))
    return out


def dir_mapping(backbone_layers=(3, 4, 6, 3)) -> List[Entry]:
    """Every (torch key, JAX path, transform) pair of the DIR model."""
    out = _resnet(backbone_layers)
    for side in ("left", "right"):
        out += _head(f"init_regressor.attention_{side}",
                     ("init_regressor", f"attention_{side}"))
        out += _dense(f"init_regressor.mano_{side}",
                      ("init_regressor", f"mano_{side}"))
    out += _dense("init_regressor.offset", ("init_regressor", "offset"))
    d = ("decoder",)
    for res in ("skip_layer4", "fusion_layer4", "enhance_layer4",
                "skip_layer3", "fusion_layer3", "enhance_layer3"):
        out += _residual(f"decoder.{res}", d + (res,))
    out += _refine_stage("decoder.projecter_4", d + ("projecter_4",))
    out += _refine_stage("decoder.projecter_3", d + ("projecter_3",))
    out += _conv2d("decoder.conv_final.0", d + ("final_conv1",), bias=False)
    out += _bn("decoder.conv_final.1", d + ("final_bn",))
    out += _conv2d("decoder.conv_final.3", d + ("final_conv2",))
    out += _head("decoder.seg", d + ("seg",))
    out += _head("decoder.dense", d + ("dense",))
    return out


# JAX layout -> torch layout.
_INV = {
    "raw": lambda w: w,
    "conv2d": lambda w: np.transpose(w, (3, 2, 0, 1)),
    "linear": lambda w: np.transpose(w, (1, 0)),
    "conv1d_dense": lambda w: np.transpose(w, (1, 0))[:, :, None],
    "squeeze0": lambda w: w[None],
}


def _get(tree: dict, path: Tuple[str, ...]):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def jax_to_state_dict(params: dict, batch_stats: dict,
                      backbone_layers=(3, 4, 6, 3)) -> Dict[str, torch.Tensor]:
    """JAX ``params``/``batch_stats`` trees -> the port's ``state_dict``
    (CPU tensors, same dtypes and values)."""
    sd = {}
    for e in dir_mapping(backbone_layers):
        tree = params if e.collection == "params" else batch_stats
        leaf = _get(tree, e.path)
        if leaf is None:
            continue
        arr = np.array(_INV[e.kind](np.asarray(leaf)), order="C", copy=True)
        sd[e.torch_key] = torch.from_numpy(arr)
    return sd


def adapt_stem_s2d(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Rewrite a conv7 stem weight (64, C, 7, 7) to the space-to-depth
    layout (64, 4C, 4, 4) wherever a ``conv1.weight`` has a 7x7 kernel, so
    that conv7 checkpoints load into ``backbone_stem="s2d"`` models. The
    rewrite is exact (``models/resnet.py:stem_weights_to_s2d``); the other
    entries are returned as they are."""
    from dir_tpu_torch.models.resnet import stem_weights_to_s2d

    out = dict(state_dict)
    for key, w in state_dict.items():
        if (key.rsplit(".", 2)[-2:] == ["conv1", "weight"]
                and tuple(w.shape[2:]) == (7, 7)):
            w4 = stem_weights_to_s2d(w.permute(2, 3, 1, 0).cpu().numpy())
            out[key] = w4.permute(3, 2, 0, 1).contiguous().to(w.device)
    return out


def _amax(tpre: str, fpre: Tuple[str, ...], names, torch_names=None):
    torch_names = torch_names or names
    return [Entry(f"{tpre}.quant_stats.{t}", fpre + (n,), "raw", "quant_stats")
            for n, t in zip(names, torch_names)]


def quant_mapping(backbone_layers=(3, 4, 6, 3)) -> List[Entry]:
    """Every (buffer name in the port, path in ``quant_stats``) pair: one
    calibrated ``|max|`` per int8 conv input, all three int8 options on."""
    out = _amax("backbone", ("backbone",), ("conv1_in",))
    for s, blocks in enumerate(backbone_layers):
        for b in range(blocks):
            names = ("conv1_in", "conv2_in", "conv3_in") + (
                ("down_in",) if b == 0 else ())
            out += _amax(f"backbone.layer{s + 1}.{b}",
                         ("backbone", f"layer{s + 1}_{b}"), names)
    for side in ("left", "right"):
        out += _amax(f"init_regressor.attention_{side}",
                     ("init_regressor", f"attention_{side}"), ("conv1_in",))
    d = ("decoder",)
    for res in ("skip_layer4", "fusion_layer4", "enhance_layer4",
                "skip_layer3", "fusion_layer3", "enhance_layer3"):
        out += _amax(f"decoder.{res}", d + (res,),
                     ("conv1_in", "conv2_in", "conv3_in", "skip_in"))
    for stage in ("projecter_4", "projecter_3"):
        out += _amax(f"decoder.{stage}", d + (stage,), ("fusion_conv2_in",))
    out += _amax("decoder.conv_final", d,
                 ("final_conv1_in", "final_conv2_in"),
                 ("conv1_in", "conv2_in"))
    for head in ("seg", "dense"):
        out += _amax(f"decoder.{head}", d + (head,), ("conv1_in",))
    return out


def quant_stats_to_amax(quant_stats: dict, backbone_layers=(3, 4, 6, 3)
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``quant_stats`` tree (nested dicts of numpy
    scalars) -> ``{buffer name: fp32 scalar tensor}``; leaves the tree does
    not hold (options that were off) are skipped."""
    out = {}
    for e in quant_mapping(backbone_layers):
        leaf = _get(quant_stats, e.path)
        if leaf is not None:
            out[e.torch_key] = torch.tensor(float(np.asarray(leaf)),
                                            dtype=torch.float32)
    return out


def load_amax(model: torch.nn.Module, amax: Dict[str, torch.Tensor]) -> None:
    """Store calibrated maxes (from :func:`quant_stats_to_amax`) in the
    ``ActAmax`` buffers of ``model``; a name the model does not have
    raises."""
    for key, value in amax.items():
        path, name = key.rsplit(".", 1)
        try:
            stats = model.get_submodule(path)
            getattr(stats, name)
        except AttributeError as err:
            raise KeyError(f"the model has no int8 scale {key!r}") from err
        stats.set_(name, value)


def amax_to_quant_stats(model: torch.nn.Module,
                        backbone_layers=(3, 4, 6, 3)) -> dict:
    """The calibrated maxes of ``model`` as the JAX package's
    ``quant_stats`` tree (nested dicts of numpy fp32 scalars); buffers no
    calibration has filled are left out."""
    tree: dict = {}
    for e in quant_mapping(backbone_layers):
        path, name = e.torch_key.rsplit(".", 1)
        try:
            stats = model.get_submodule(path)
        except AttributeError:
            continue
        if name not in stats.filled:
            continue
        node = tree
        for k in e.path[:-1]:
            node = node.setdefault(k, {})
        node[e.path[-1]] = np.float32(getattr(stats, name).item())
    return tree


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an ``optax.adamw``
    state: a NamedTuple chain, or the same as nested dicts or lists (as a
    checkpoint restores it)."""
    if isinstance(opt_state, dict):
        if {"count", "mu", "nu"} <= set(opt_state):
            return opt_state["count"], opt_state["mu"], opt_state["nu"]
        items = opt_state.values()
    elif all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state.count, opt_state.mu, opt_state.nu
    elif isinstance(opt_state, (list, tuple)):
        items = opt_state
    else:
        items = ()
    for item in items:
        found = _adam_state(item)
        if found is not None:
            return found
    return None


def jax_opt_state_to_torch(opt_state_numpy, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer) -> int:
    """Carry ``optax.adamw``'s moments into ``torch.optim.AdamW``'s state.

    ``opt_state_numpy``: the JAX train state's ``opt_state`` with numpy
    leaves. Its ``ScaleByAdamState(count, mu, nu)`` becomes, for every
    parameter of ``model`` that ``optimizer`` holds, ``exp_avg`` (mu),
    ``exp_avg_sq`` (nu) and ``step`` (count), in each parameter's dtype and
    on its device. mu and nu are linear in the gradients, so they take the
    parameters' layout changes of :func:`jax_to_state_dict`. Returns the
    count: the optimizer steps taken, the port's ``TrainState.step``."""
    found = _adam_state(opt_state_numpy)
    if found is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the state")
    count, mu, nu = found
    layers = model.cfg.backbone_layers
    exp_avg = jax_to_state_dict(mu, {}, layers)
    exp_avg_sq = jax_to_state_dict(nu, {}, layers)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    step = int(np.asarray(count))
    for name, p in model.named_parameters():
        if id(p) not in held:
            continue
        if name not in exp_avg:
            raise KeyError(f"the JAX state has no moments for {name!r}")
        optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": exp_avg[name].to(p.device, p.dtype),
            "exp_avg_sq": exp_avg_sq[name].to(p.device, p.dtype),
        }
    return step
