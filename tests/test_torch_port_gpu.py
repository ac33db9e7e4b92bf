"""Tests of the port that need the card: the CUDA kernels K1, K2 (the fused
bottleneck, whole-halo and streamed) and K5 (the bone splat) against their
plain versions, and the bf16 forward with the kernels against the fp32
forward.

They import nothing of JAX, so they run on a machine without it. Each
decides inside the test whether a card is present and skips without
one. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.ops import fused_bottleneck as fb


def _cuda_or_skip() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _folded(rng, c, mid, o, down, dev):
    def w(*shape):
        a = rng.uniform(-1, 1, shape) / np.sqrt(np.prod(shape[:-1]))
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def b(n):
        return torch.from_numpy(
            rng.uniform(-0.5, 0.5, n).astype(np.float32)).to(dev)

    ws = [w(c, mid), b(mid), w(3, 3, mid, mid), b(mid), w(mid, o), b(o)]
    return ws + ([w(c, o), b(o)] if down else [None, None])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,down", [
    ((2, 64, 64, 256), 64, False),
    ((2, 64, 64, 256), 64, True),
    ((1, 10, 20, 32), 16, True),   # ragged tiles on both axes
    ((3, 9, 16, 48), 32, False),
])
def test_cuda_kernel_matches_plain(shape, mid, down):
    dev = _cuda_or_skip()
    rng = np.random.RandomState(4)
    ws = _folded(rng, shape[-1], mid, shape[-1], down, dev)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    before = fb.fused_bottleneck_infer.launches
    out = fb.fused_bottleneck_infer(x, *ws)
    assert fb.fused_bottleneck_infer.launches == before + 1
    ref = fb.fused_bottleneck_infer_plain(x, *ws)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    # four bf16 ulps of the output scale: an fp32 sum in another order can
    # round an intermediate the other way
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 4 * 2 ** -8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,o,down,bands", [
    ((2, 32, 32, 512), 128, 512, False, 4),   # the layer2 shape
    ((2, 32, 32, 512), 128, 512, True, 4),
    ((2, 64, 64, 256), 64, 256, False, 2),    # K1's shape through K2
    ((1, 10, 20, 32), 16, 32, True, 5),       # ragged tiles on both axes
    ((3, 9, 17, 48), 32, 48, False, 3),       # C not a multiple of a chunk
    ((1, 12, 30, 144), 64, 80, True, 2),      # last w3 block narrower than mid
])
def test_cuda_streamed_kernel_matches_plain(shape, mid, o, down, bands):
    """K2 (bands > 0) against the plain version; K1's count stays."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(5)
    ws = _folded(rng, shape[-1], mid, o, down, dev)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches)
    out = f(x, *ws, bands=bands)
    assert (f.launches, f.streamed_launches) == (before[0], before[1] + 1)
    ref = fb.fused_bottleneck_infer_plain(x, *ws)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    # four bf16 ulps of the output scale, as for K1
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 4 * 2 ** -8 * scale


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    ws = [torch.zeros(s, device=dev) for s in
          ((16, 16), (16,), (3, 3, 16, 16), (16,), (16, 16), (16,))]
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches)
    for bands in (0, 2):             # K1 and K2
        with pytest.raises(TypeError):   # fp32 activations
            f(torch.zeros(1, 4, 4, 16, device=dev), *ws, bands=bands)
        x = torch.zeros(1, 16, 4, 4, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError):  # not NHWC-contiguous
            f(x.permute(0, 2, 3, 1), *ws, bands=bands)
    x = torch.zeros(1, 4, 4, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):      # bands must divide H
        f(x, *ws, bands=3)
    # the layer2 shape is beyond K1's shared memory: it raises, and does not
    # quietly take the other kernel or the plain version
    big = [torch.zeros(s, device=dev) for s in
           ((512, 128), (128,), (3, 3, 128, 128), (128,), (128, 512), (512,))]
    with pytest.raises(ValueError, match="shared memory"):
        f(torch.zeros(1, 32, 32, 512, device=dev, dtype=torch.bfloat16), *big)
    assert (f.launches, f.streamed_launches) == before  # nothing launched


def _splat_inputs(seed, b, c, dev, dtype):
    rng = np.random.RandomState(seed)
    uv = rng.uniform(-0.9, 0.9, (b, 21, 2)).astype(np.float32)
    uv[-1, 2] = uv[-1, 1]            # a zero-length bone
    feat = rng.randn(b, 21, c).astype(np.float32)
    return (torch.from_numpy(uv).to(dev),
            torch.from_numpy(feat).to(dev, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("b,size,c,distance,dtype", [
    (4, 32, 64, 2.0, torch.bfloat16),    # the path's two shapes
    (4, 16, 64, 1.0, torch.bfloat16),
    (3, 16, 64, 1.0, torch.float32),
    (2, 7, 8, 1.5, torch.bfloat16),      # 49 pixels: a ragged last strip
    (1, 5, 12, 3.0, torch.float32),
])
def test_cuda_bone_splat_matches_plain(b, size, c, distance, dtype):
    dev = _cuda_or_skip()
    uv, feat = _splat_inputs(6, b, c, dev, dtype)
    before = bs.bone_splat.launches
    out = bs.bone_splat(uv, feat, size, distance)
    assert bs.bone_splat.launches == before + 1
    ref = bs.bone_splat_plain(uv, feat, size, distance)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape == (
        b, size, size, 20 * c)
    assert torch.isfinite(out).all()
    # one ulp of the feature dtype at the output's max |value|, outside the
    # (pixel, bone) pairs within 1e-4 px of the mask's threshold, where the
    # step can fall either way; at most 0.1 % of the pairs may be left out
    near = bs.threshold_pairs(uv, size, distance)
    err, tol, left_out = bs.mismatch_outside_threshold(out, ref, near)
    assert left_out <= 1e-3 and err <= tol, (err, tol, left_out)


@pytest.mark.gpu
def test_cuda_bone_splat_gradient_is_the_plain_version():
    dev = _cuda_or_skip()
    uv, feat = _splat_inputs(7, 2, 8, dev, torch.float32)
    grads = []
    for fn in (bs.bone_splat, bs.bone_splat_plain):
        u = uv.clone().requires_grad_(True)
        f = feat.clone().requires_grad_(True)
        (fn(u, f, 8, 1.5) ** 2).sum().backward()
        grads.append((u.grad, f.grad))
    # the backward is the same code; only the forward's output (the incoming
    # gradient 2*out) can differ, by an fp32 ulp
    for a, b_ in zip(*grads):
        assert float((a - b_).abs().max()) <= 1e-4 * float(b_.abs().max())


@pytest.mark.gpu
def test_cuda_bone_splat_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    uv, feat = _splat_inputs(8, 2, 8, dev, torch.bfloat16)
    before = bs.bone_splat.launches
    with pytest.raises(TypeError):       # fp16 features
        bs.bone_splat(uv, feat.half(), 8, 1.0)
    with pytest.raises(TypeError):       # fp64 joint positions
        bs.bone_splat(uv.double(), feat, 8, 1.0)
    with pytest.raises(ValueError):      # C not a multiple of 8 (bf16)
        bs.bone_splat(uv, feat[:, :, :4], 8, 1.0)
    with pytest.raises(ValueError):      # not 21 joints
        bs.bone_splat(uv[:, :20], feat[:, :20], 8, 1.0)
    with pytest.raises(ValueError):      # features on the CPU, joints on the card
        bs.bone_splat(uv, feat.cpu(), 8, 1.0)
    assert bs.bone_splat.launches == before  # nothing launched


@pytest.mark.gpu
def test_flagship_bf16_matches_fp32_on_card():
    """A cut-depth flagship: bf16 with K1 against the fp32 unfused forward
    on the same weights; final-stage joints within the serve tolerance."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import (condition_random_, flagship_mano,
                                     make_infer, random_init_)

    layers = (3, 1, 1, 1)
    ml, mr = (m.to(dev) for m in flagship_mano())
    model = random_init_(DIR(ModelConfig(
        backbone_layers=layers, dtype="bfloat16",
        fused_bottleneck_eval=True)), seed=0).to(dev)
    condition_random_(model, ml, mr, seed=0)
    ref_model = DIR(ModelConfig(backbone_layers=layers)).to(dev)
    ref_model.load_state_dict(model.state_dict())
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    before = fb.fused_bottleneck_infer.launches
    out = make_infer(model, ml, mr)(img)
    assert fb.fused_bottleneck_infer.launches == before + 2
    ref = make_infer(ref_model, ml, mr)(img)
    for key in ("pd_joint_xyz_left", "pd_joint_xyz_right"):
        err_mm = float((out["stages"][-1][key]
                        - ref["stages"][-1][key]).abs().max()) * 1e3
        assert err_mm < 5.0, (key, err_mm)


@pytest.mark.gpu
def test_flagship_config_b_matches_fp32_on_card():
    """A cut-depth flagship in configuration B (K1 at layer1, K2 at layer2,
    the bone splat through K5) against the fp32 forward of configuration A
    on the same weights; launches per request K1 2, K2 1 (layer2 has two
    blocks here), K5 4."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import (CONFIG_B, condition_random_,
                                     flagship_mano, make_infer, random_init_)

    layers = (3, 2, 1, 1)
    ml, mr = (m.to(dev) for m in flagship_mano())
    model = random_init_(DIR(ModelConfig(
        backbone_layers=layers, dtype="bfloat16",
        fused_bottleneck_eval=True, **CONFIG_B)), seed=0).to(dev)
    condition_random_(model, ml, mr, seed=0)
    ref_model = DIR(ModelConfig(backbone_layers=layers)).to(dev)
    ref_model.load_state_dict(model.state_dict(), strict=True)
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches, bs.bone_splat.launches)
    out = make_infer(model, ml, mr)(img)
    after = (f.launches, f.streamed_launches, bs.bone_splat.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 1, 4)
    ref = make_infer(ref_model, ml, mr)(img)
    for key in ("pd_joint_xyz_left", "pd_joint_xyz_right"):
        err_mm = float((out["stages"][-1][key]
                        - ref["stages"][-1][key]).abs().max()) * 1e3
        assert err_mm < 5.0, (key, err_mm)
