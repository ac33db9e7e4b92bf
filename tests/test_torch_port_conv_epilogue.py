"""The fused eval route of ``dir_tpu_torch/ops/conv_epilogue.py``: each
conv's eval BatchNorm folded into it, and its bias, the residual and the
ReLU in one pass after it, at the stem, the ``Bottleneck`` blocks K1 does
not take, the decoder's ``Residual`` blocks and the ``ConvHead``s.

On the CPU the sites never take the route (:func:`conv_epilogue.engages`
wants a CUDA device), so the CPU tests force it with ``engages`` patched to
True: the fused sites then run the plain version, which at fp64 equals the
unfused eval composition. The tests marked ``gpu`` run the card's route
(the folded conv, then the Triton pass) and skip without a card. The file
imports nothing of JAX; on the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_conv_epilogue.py
"""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch
import torch.nn as nn

from dir_tpu_torch.models.layers import ConvHead, Residual
from dir_tpu_torch.models.resnet import Bottleneck, ResNetPyramid
from dir_tpu_torch.ops import conv_epilogue as ce

F64 = torch.float64


def randomize_(module: nn.Module, seed: int) -> nn.Module:
    """Every conv weight at a fan-in scale, every conv bias, BN scale,
    shift and running statistic random (nothing at its initial value)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-0.5, 0.5, generator=g)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.5, 0.5, generator=g)
                m.running_mean.normal_(0.0, 0.5, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return module


@contextlib.contextmanager
def engaged():
    """Every site takes the fused route (on the CPU: the plain version)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ce, "engages", lambda module, x: True)
        yield


def fused_and_unfused(module, *args):
    """``(unfused output, fused output, fused calls)`` of ``module`` in eval
    mode without gradients."""
    module.eval()
    with torch.no_grad():
        plain = module(*args)
        before = ce.conv_bias_relu.fused_runs
        with engaged():
            fused = module(*args)
        return plain, fused, ce.conv_bias_relu.fused_runs - before


def assert_same(a, b, tol=1e-10):
    a, b = (t if isinstance(t, (list, tuple)) else [t] for t in (a, b))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        scale = max(1.0, float(u.abs().max()))
        assert float((u - v).abs().max()) <= tol * scale


def rand(shape, seed, dtype=F64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=dtype)
    return x.contiguous(memory_format=torch.channels_last)


SITES = {
    # name: (module, inputs, fused calls a forward)
    "stem_and_projection_blocks": (
        lambda: ResNetPyramid((1, 1, 1, 1), F64),
        lambda: [rand((2, 3, 32, 32), 1)], 1 + 4 * 3),
    "stem_s2d": (
        lambda: ResNetPyramid((1, 1, 1, 1), F64, stem="s2d"),
        lambda: [rand((2, 3, 32, 32), 2)], 1 + 4 * 3),
    "identity_block": (
        lambda: Bottleneck(64, 16, dtype=F64),
        lambda: [rand((2, 64, 6, 5), 3)], 3),
    "projection_block": (
        lambda: Bottleneck(24, 16, downsample=True, dtype=F64),
        lambda: [rand((2, 24, 6, 5), 4)], 3),
    "strided_projection_block": (
        lambda: Bottleneck(64, 32, stride=2, downsample=True, dtype=F64),
        lambda: [rand((2, 64, 7, 6), 5)], 3),
    "residual": (
        lambda: Residual(16, 16, F64),
        lambda: [rand((2, 16, 5, 6), 6)], 2),
    "residual_pair_skip_conv": (
        lambda: Residual(24, 16, F64),
        lambda: [rand((2, 16, 5, 6), 7), rand((2, 8, 5, 6), 8)], 2),
    "conv_head": (
        lambda: ConvHead(16, 8, 3, dtype=F64),
        lambda: [rand((2, 16, 5, 6), 9)], 1),
    "conv_head_without_bias": (
        lambda: ConvHead(16, 16, 16, first_bias=False, dtype=F64),
        lambda: [rand((2, 16, 5, 6), 10)], 1),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_site_matches_unfused_eval_fp64(site):
    """Each kind of site on the fused route (the BN folded into the conv,
    bias, residual and ReLU after it; a projection's folded bias moved into
    b3) equals the unfused eval composition at fp64."""
    make, inputs, calls = SITES[site]
    module = randomize_(make().to(F64), seed=11)
    plain, fused, runs = fused_and_unfused(module, *inputs())
    assert runs == calls
    assert_same(plain, fused)


def test_dir_forward_fused_matches_unfused_fp64():
    """The whole tiny DIR at fp64: 30 fused calls a forward (the stem, 4
    blocks x 3, 6 ``Residual``s x 2, 5 ``ConvHead``s), every output equal
    to the unfused forward."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import flagship_mano

    model = randomize_(DIR(ModelConfig(backbone_layers=(1, 1, 1, 1),
                                       dtype="float64")).to(F64), seed=12)
    ml, mr = (type(m)(*(t.to(F64) if t.is_floating_point() else t
                        for t in m))
              for m in flagship_mano("/nonexistent"))
    img = torch.from_numpy(
        np.random.RandomState(0).randn(2, 64, 64, 3)).to(F64)
    plain, fused, runs = fused_and_unfused(model, img, ml, mr)
    assert runs == 30
    flat_p, spec = torch.utils._pytree.tree_flatten(plain)
    flat_f, spec_f = torch.utils._pytree.tree_flatten(fused)
    assert spec == spec_f
    assert_same(flat_p, flat_f)


def _block():
    return randomize_(Bottleneck(24, 16, downsample=True, dtype=F64).to(F64),
                      seed=13).eval()


def _fused(module, x):
    with torch.no_grad(), engaged():
        return module(x)


def test_operands_kept_across_calls():
    block, x = _block(), rand((2, 24, 5, 5), 14)
    _fused(block, x)
    kept = block._folded.value
    assert kept is not None
    _fused(block, x)
    _fused(block, x)
    assert block._folded.value is kept


def _load_state_dict(block):
    state = copy.deepcopy(block.state_dict())
    state["conv1.weight"] *= 0.5
    block.load_state_dict(state)


def _in_place(block):
    with torch.no_grad():
        block.bn2.running_var.mul_(2.0)


def _replaced(block):
    block.conv3.weight = nn.Parameter(block.conv3.weight.detach() * -1.0)


def _eps(block):
    block.downsample[1].eps = 1e-2


def _marked(block):
    """A write that moves no version (as a CUDA graph's replay writes),
    then marked as the graphed train step marks its replay's writes."""
    block.conv2.weight.data.mul_(-1.0)
    torch.autograd.graph.increment_version(
        [t for conv, bn in block._pairs() for t in ce.sources(conv, bn)])


@pytest.mark.parametrize("change", [_load_state_dict, _in_place, _replaced,
                                    _eps, _marked],
                         ids=["load_state_dict", "in_place", "replaced",
                              "eps", "marked"])
def test_operands_made_anew_after(change):
    """A load, an in-place update, a replaced parameter, an eps change and
    a version mark each make the folded operands anew, and the fused route
    then equals the unfused one on the changed block."""
    block, x = _block(), rand((2, 24, 5, 5), 15)
    before = _fused(block, x)
    kept = block._folded.value
    change(block)
    plain, fused, _ = fused_and_unfused(block, x)
    assert block._folded.value is not kept
    assert_same(plain, fused)
    assert float((fused - before).abs().max()) > 1e-3


def test_operands_made_anew_after_to():
    """``.to()`` moves every source tensor: the operands follow."""
    block, x = _block(), rand((2, 24, 5, 5), 16)
    _fused(block, x)
    kept = block._folded.value
    block.to(torch.float32)
    block.dtype = torch.float32
    plain, fused, _ = fused_and_unfused(block, x.float())
    assert block._folded.value is not kept
    assert block._folded.value[0].dtype == torch.float32
    assert_same(plain, fused, tol=1e-5)


def test_operands_of_inference_tensors_not_kept():
    """Parameters made under ``inference_mode`` keep no version: the
    operands are made each call and not kept."""
    with torch.inference_mode():
        block = _block()
        x = rand((2, 24, 5, 5), 17)
        with engaged():
            block(x)
    assert block._folded.value is None


CUDA_BF16 = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)


def test_engages_on_bf16_cuda_inference():
    head = ConvHead(8, 8, 3, dtype=torch.bfloat16).eval()
    with torch.no_grad():
        assert ce.engages(head, CUDA_BF16)
    with torch.inference_mode():
        assert ce.engages(head, CUDA_BF16)


@pytest.mark.parametrize("rule", ["training", "grad", "fp32_activations",
                                  "fp32_trunk", "cpu", "exporting"])
def test_bypass_rules(rule, monkeypatch):
    """Each rule alone keeps a site on today's composition."""
    head = ConvHead(8, 8, 3, dtype=torch.bfloat16).eval()
    x = CUDA_BF16
    grad = torch.no_grad()
    if rule == "training":
        head.train()
    elif rule == "grad":
        grad = torch.enable_grad()
    elif rule == "fp32_activations":
        x = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    elif rule == "fp32_trunk":
        head.dtype = torch.float32
    elif rule == "cpu":
        x = torch.zeros((1, 8, 2, 2), dtype=torch.bfloat16)
    else:
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with grad:
        assert not ce.engages(head, x)


@pytest.mark.parametrize("mode", ["eval_bf16", "eval_fp32", "train"])
def test_cpu_forward_never_fuses(mode):
    """On the CPU no site takes the route: eval in bf16 and fp32, and
    training; ``fused_runs`` and the kernel's counters stay as they were."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import flagship_mano

    dtype = "bfloat16" if mode == "eval_bf16" else "float32"
    model = DIR(ModelConfig(backbone_layers=(1, 1, 1, 1), dtype=dtype))
    model.train(mode == "train")
    ml, mr = flagship_mano("/nonexistent")
    img = torch.from_numpy(
        np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32))
    counters = (ce.conv_bias_relu.fused_runs, ce.bias_add_relu_.launches,
                ce.bias_add_relu_.plain_runs)
    grad = torch.enable_grad() if mode == "train" else torch.inference_mode()
    with grad:
        model(img, ml, mr)
    assert (ce.conv_bias_relu.fused_runs, ce.bias_add_relu_.launches,
            ce.bias_add_relu_.plain_runs) == counters
    kept = [v for m in model.modules() for v in vars(m).values()
            if isinstance(v, ce.Kept)]
    assert kept and all(k.value is None for k in kept)


def test_plain_epilogue_rounds_once():
    """The plain version sums in fp32 and rounds once: against the fp64
    sum rounded to bf16."""
    y = rand((2, 8, 3, 4), 18).to(torch.bfloat16)
    z = rand((2, 8, 3, 4), 19).to(torch.bfloat16)
    b = torch.linspace(-1, 1, 8)
    want = torch.relu(y.double() + b.double()[:, None, None]
                      + z.double()).to(torch.bfloat16)
    before = ce.bias_add_relu_.plain_runs
    got = ce.bias_add_relu_(y, b, z)
    assert ce.bias_add_relu_.plain_runs == before + 1
    assert torch.equal(got, want)
    no_z = ce.bias_add_relu_plain(y, b)
    assert torch.equal(no_z, torch.relu(
        y.double() + b.double()[:, None, None]).to(torch.bfloat16))


# ---------------------------------------------------------------- the card


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the Triton kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# A's distinct site shapes: (input channels, output channels, kernel,
# stride, input size, conv bias, residual); the batch does not change the
# arithmetic of an element, so a small one stands for 1,024.
A_SITES = [
    (3, 64, 7, 2, 256, False, None),              # stem
    (64, 64, 1, 1, 64, False, None),              # layer1_0
    (64, 64, 3, 1, 64, False, None),
    (64, 256, 1, 1, 64, False, "projection"),
    (256, 128, 1, 1, 64, False, None),            # layer2_0
    (128, 128, 3, 2, 64, False, None),
    (128, 512, 1, 1, 32, False, "projection"),
    (512, 128, 1, 1, 32, False, None),            # layer2_1-3
    (128, 128, 3, 1, 32, False, None),
    (128, 512, 1, 1, 32, False, "identity"),
    (512, 256, 1, 1, 32, False, None),            # layer3_0
    (256, 256, 3, 2, 32, False, None),
    (256, 1024, 1, 1, 16, False, "projection"),
    (1024, 256, 1, 1, 16, False, None),           # layer3_1-5
    (256, 256, 3, 1, 16, False, None),
    (256, 1024, 1, 1, 16, False, "identity"),
    (1024, 512, 1, 1, 16, False, None),           # layer4_0
    (512, 512, 3, 2, 16, False, None),
    (512, 2048, 1, 1, 8, False, "projection"),
    (2048, 512, 1, 1, 8, False, None),            # layer4_1-2
    (512, 512, 3, 1, 8, False, None),
    (512, 2048, 1, 1, 8, False, "identity"),
    (1024, 128, 1, 1, 16, True, None),            # Residual conv1
    (2304, 128, 1, 1, 16, True, None),
    (512, 128, 1, 1, 16, True, None),
    (512, 128, 1, 1, 32, True, None),
    (128, 128, 3, 1, 16, True, None),             # Residual conv2
    (128, 128, 3, 1, 32, True, None),
    (2048, 1024, 3, 1, 8, True, None),            # attention pools
    (256, 256, 3, 1, 32, False, None),            # conv_final
    (256, 128, 3, 1, 32, True, None),             # seg, dense
]


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,k,stride,size,bias,residual", A_SITES)
def test_cuda_route_at_a_site_shape(cin, cout, k, stride, size, bias,
                                    residual):
    """The card's route at each of A's site shapes, bf16, channels-last:
    the Triton pass on the conv's output equals the plain version to the
    bit (both sum in fp32 in one order and round once), and the route is
    within 2**-7 of the output's max of the fp32 computation on the same
    bf16 operands. 2**-7: the conv's output is rounded to bf16 before the
    bias is added, and the sum once more (at most 2**-9 of each); measured
    at most 0.0059 of the max at batch 1,024 over these shapes."""
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(cin * 7 + cout + k)
    batch = 2
    conv, bn = randomize_(nn.Sequential(
        nn.Conv2d(cin, cout, k, stride, k // 2, bias=bias),
        nn.BatchNorm2d(cout)), seed=cin + cout).to(dev).eval()
    x = torch.randn((batch, cin, size, size), generator=g, device=dev)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w, b = ce.fold(conv, bn, torch.bfloat16)
    out_size = (size + 2 * (k // 2) - k) // stride + 1
    z = None
    if residual:
        z = torch.randn((batch, cout, out_size, out_size), generator=g,
                        device=dev).to(torch.bfloat16)
        z = z.contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        y = torch.nn.functional.conv2d(x, w, None, stride, k // 2)
        plain = ce.bias_add_relu_plain(y, b, z)
        before = ce.bias_add_relu_.launches
        got = ce.bias_add_relu_(y.clone(), b, z)
        assert ce.bias_add_relu_.launches == before + 1
        route = ce.conv_bias_relu(x, w, b, stride, k // 2, z)
        ref = torch.nn.functional.conv2d(x.float(), w.float(), b, stride,
                                         k // 2)
        ref = torch.relu(ref if z is None else ref + z.float())
    torch.cuda.synchronize()
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, plain)
    scale = float(ref.abs().max())
    assert float((route.float() - ref).abs().max()) <= 2 ** -7 * scale


@pytest.mark.gpu
def test_cuda_epilogue_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    y = torch.zeros((2, 64, 4, 4), device=dev, dtype=torch.bfloat16)
    b = torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        ce.bias_add_relu_(y, b)                       # not channels-last
    y = y.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        ce.bias_add_relu_(y, b.to(torch.bfloat16))    # bias not fp32
    with pytest.raises(ValueError):
        ce.bias_add_relu_(y, b[:32])                  # bias of another width
    with pytest.raises(ValueError):
        ce.bias_add_relu_(y, b, torch.zeros_like(y).float())


@pytest.mark.gpu
def test_cuda_flagship_fused_matches_unfused():
    """Configuration A at full width, batch 8: 60 fused calls a forward
    (the stem, 14 blocks x 3, 6 ``Residual``s x 2, 5 ``ConvHead``s) and the
    final joints within the 5 mm the bf16 flagship is held to against fp32
    (``test_torch_port_gpu.py``) of the unfused bf16 forward."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import (condition_random_, flagship_mano,
                                     make_infer, random_init_)

    ml, mr = (m.to(dev) for m in flagship_mano())
    model = random_init_(DIR(ModelConfig(
        dtype="bfloat16", fused_bottleneck_eval=True)), seed=0).to(dev)
    condition_random_(model, ml, mr, seed=0)
    infer = make_infer(model, ml, mr)
    img = np.random.RandomState(1).randn(8, 256, 256, 3).astype(np.float32)
    before = (ce.conv_bias_relu.fused_runs, ce.bias_add_relu_.launches)
    out = infer(img)
    torch.cuda.synchronize()
    after = (ce.conv_bias_relu.fused_runs, ce.bias_add_relu_.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (60, 60)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ce, "engages", lambda module, x: False)
        ref = infer(img)
    assert ce.conv_bias_relu.fused_runs == after[0]
    for key in ("pd_joint_xyz_left", "pd_joint_xyz_right"):
        err_mm = float((out["stages"][-1][key]
                        - ref["stages"][-1][key]).abs().max()) * 1e3
        print(f"{key}: fused against unfused {err_mm:.4f} mm")
        assert err_mm < 5.0, (key, err_mm)


@pytest.mark.gpu
def test_cuda_fp32_and_training_take_todays_path():
    """On the card an fp32 trunk in eval and a bf16 model in training take
    no fused route."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import flagship_mano

    ml, mr = (m.to(dev) for m in flagship_mano())
    img = torch.randn((2, 64, 64, 3), device=dev)
    before = ce.conv_bias_relu.fused_runs
    fp32 = DIR(ModelConfig(backbone_layers=(1, 1, 1, 1))).to(dev).eval()
    with torch.inference_mode():
        fp32(img, ml, mr)
    bf16 = DIR(ModelConfig(backbone_layers=(1, 1, 1, 1),
                           dtype="bfloat16")).to(dev).train()
    bf16(img, ml, mr)
    assert ce.conv_bias_relu.fused_runs == before
