"""What a run is made of, from its seed: the configuration's files, the
weights drawn on the device, the MANO hands, the conditioning of the
random weights, the plain reference, and the program's model loaded with
the same tensors.

The weights are drawn by the benchmark, on the run's device, with one
``torch.Generator`` in two large draws (normal and uniform) that are then
cut into the parameters; the reference is conditioned with them, and its
``state_dict`` is loaded with ``strict=True`` into the program's model.
The reference takes nothing that the program made.
"""

from __future__ import annotations

import json
import math
import os

import torch
import torch.nn as nn

from portbench.reference import mano as mano_ref
from portbench.reference.net import DIR, Bottleneck, RefineStage, Residual

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The bias of the MANO parameter heads after conditioning: the identity 6D
# root and a camera scale at which the hand spans about half of the crop.
HEAD_BIAS = {0: 1.0, 4: 1.0, 61: 5.0}
HEADS = ("mano_left", "mano_right", "offset")
CONDITION_IMAGES = 8
# The scale, after conditioning, of the last BatchNorm of each backbone
# bottleneck, of the last conv of each decoder residual and of the 1x1 conv
# that ends each refine stage's splat fusion. At the drawn scale the random
# network is chaotic: a bf16 rounding of the trunk already moves the c4
# features by 48 % of their norm and every output as far as another image's
# output lies, so no comparison could tell bf16 from fp8; and a (pixel,
# bone) pair that rounding moves across the splat's distance threshold
# moves the next stage's joints of its image by up to 0.6 mm. Trained
# networks are not chaotic; small residual branches (as torchvision's
# ``zero_init_residual`` starts them, but not zero, so that every branch,
# the kernels' included, still reaches the output) make the random one
# behave alike.
RESIDUAL_SCALE = 0.1


def read_json(rel: str) -> dict:
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json("BENCHMARK.json")


def cell(workload: str) -> tuple[dict, dict, dict]:
    """``(workload entry, configuration file, traffic file)`` of a cell,
    found by the names in ``BENCHMARK.json``."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == workload]
    if not found:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = found[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return (w, read_json(conf["file"]),
            read_json(f"portbench/traffic/{w['traffic']}.json"))


def reference(cfg: dict, device) -> DIR:
    with torch.device(device):
        return DIR(cfg).to(device)


def draw_weights_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights on the model's device: truncated-normal
    fan-out convs, truncated lecun-normal linears and token convs,
    N(0, 1e-3) parameter heads, uniform graph-conv weights, BatchNorm
    scales in [0.8, 1.2] and shifts in [-0.1, 0.1], zero biases and
    position embedding, unit LayerNorms."""
    dev = next(model.parameters()).device
    normal, uniform = [], []        # (tensor, scale) and (tensor, low, high)
    for name, m in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, nn.Conv2d):
            o, _, kh, kw = m.weight.shape
            normal.append((m.weight, math.sqrt(2.0 / (o * kh * kw)), 2.0))
        elif isinstance(m, nn.Conv1d):
            normal.append((m.weight, math.sqrt(1.0 / m.weight.shape[1]), 2.0))
        elif isinstance(m, nn.Linear):
            if leaf in HEADS:
                normal.append((m.weight, 1e-3, None))
            else:
                normal.append((m.weight, math.sqrt(1.0 / m.weight.shape[1]),
                               2.0))
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            uniform += [(m.weight, 0.8, 1.2), (m.bias, -0.1, 0.1)]
        elif hasattr(m, "e_0"):                               # PGraphConv
            _, j, cin, cout = m.W.shape
            bound = 1.414 * math.sqrt(6.0 / (j * cin * cout + 2 * cin * cout))
            uniform += [(m.W, -bound, bound),
                        (m.bias, -1 / math.sqrt(j), 1 / math.sqrt(j))]
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        for m in model.modules():
            if isinstance(m, nn.LayerNorm) or hasattr(m, "e_0"):
                for n in ("weight", "e_0", "e_1"):
                    if hasattr(m, n):
                        getattr(m, n).fill_(1.0)
        z = torch.randn(sum(t.numel() for t, _, _ in normal), generator=gen,
                        device=dev)
        u = torch.rand(sum(t.numel() for t, _, _ in uniform), generator=gen,
                       device=dev)
        at = 0
        for t, scale, cut in normal:
            v = z[at:at + t.numel()]
            if cut is not None:       # truncated at 2 std, std kept
                v = v.clamp(-cut, cut) / 0.8796256610342398
            t.copy_((v * scale).view_as(t))
            at += t.numel()
        at = 0
        for t, low, high in uniform:
            t.copy_((low + (high - low) * u[at:at + t.numel()]).view_as(t))
            at += t.numel()
    return model


def condition_(model: DIR, pair: dict, seed: int, size: int) -> DIR:
    """Make random weights behave like trained ones where it matters for a
    comparison: every MANO head starts at the identity root and a camera
    scale that puts the hand in the crop, the residual branches and the
    splat fusions are scaled by ``RESIDUAL_SCALE``, and every BatchNorm's
    running
    statistics become the batch statistics of ``CONDITION_IMAGES`` seeded
    N(0, 1) images, as training leaves them. Returns the model in eval
    mode."""
    dev = next(model.parameters()).device
    norms = [m for m in model.modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.no_grad():
        for name, m in model.named_modules():
            if name.rsplit(".", 1)[-1] in ("mano_left", "mano_right"):
                for i, v in HEAD_BIAS.items():
                    m.bias[i] = v
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(RESIDUAL_SCALE)
            elif isinstance(m, Residual):
                m.conv3.conv.weight.mul_(RESIDUAL_SCALE)
            elif isinstance(m, RefineStage):
                m.fusion[3].weight.mul_(RESIDUAL_SCALE)
        for m in norms:
            m.reset_running_stats()
            m.momentum = None              # the average over one pass
        img = torch.randn((CONDITION_IMAGES, size, size, 3), generator=gen,
                          device=dev)
        model.train()
        model(img, pair)
    for m in norms:
        m.momentum = 0.1
    return model.eval()


def mano(seed: int, device) -> tuple[dict, dict]:
    """``(numpy hands, reference pair)`` drawn from the seed."""
    hands = mano_ref.synthetic(seed)
    return hands, {s: mano_ref.tensors(h, device) for s, h in hands.items()}


def seeded_reference(cfg: dict, seed: int, device):
    """The conditioned reference of ``cfg`` with the seed's weights and
    hands: ``(model, numpy hands, reference pair)``."""
    hands, pair = mano(seed, device)
    model = draw_weights_(reference(cfg, device), seed)
    condition_(model, pair, seed, cfg["image_size"])
    return model, hands, pair


def program_mano(hands: dict, device):
    """The hands as the program's ``ManoModel`` pair (left, right)."""
    from dir_tpu_torch.mano.assets import ManoModel

    return tuple(ManoModel(**{k: torch.from_numpy(hands[s][k]).to(device)
                              for k in mano_ref.FIELDS})
                 for s in ("left", "right"))


def program_model(cfg: dict, state: dict, device, **flags):
    """The program's DIR with the configuration's flags (``flags`` override
    them), holding ``state`` (loaded with ``strict=True``)."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR as ProgramDIR

    import dataclasses

    sizes = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg.items()
             if k in {f.name for f in dataclasses.fields(ModelConfig)}
             and k != "backbone"}
    sizes.update({k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg["loss"].items()})
    mcfg = ModelConfig(**{**sizes, **cfg["program"], **flags})
    with torch.device(device):
        model = ProgramDIR(mcfg)
    model.to(device).load_state_dict(state, strict=True)
    model.eval()
    return model, mcfg
