"""Tests of the port that need the card: the CUDA kernels K1, K2 (the fused
bottleneck, weights resident and streamed), K3 (the fused int8 bottleneck), K4
(stem + layer1_0) and K5 (the bone splat) against their plain versions, the
unfused int8 conv's integers against the CPU's, the bf16 and int8
forwards with the kernels against the fp32 forward, K5's gradient, a bf16
train step, the train step and the decoder's sampler and upsample repeated
to the bit under deterministic algorithms, the sampler against
``F.grid_sample``, an fp32 trunk under the fused flags (served unfused: the
kernels take bf16 only), and the kernels as ``torch.ops.dir_tpu.*`` ops:
equal to their launches, ``opcheck`` on CUDA tensors, and configuration B
exported on the card launching them from its program.

They import nothing of JAX, so they run on a machine without it. Each
decides inside the test whether a card is present and skips without
one. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.ops import conv_epilogue
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops import fused_stem_bottleneck as st
from dir_tpu_torch.ops import quant


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
    ((5, 64, 64, 256), 64, False),  # 160 tiles: more than one per SM
    ((1, 64, 64, 256), 64, False),  # 32 tiles: fewer blocks than SMs
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
    ((20, 32, 32, 512), 128, 512, False, 4),  # 160 tiles: more than one per SM
    ((1, 32, 32, 512), 128, 512, False, 4),   # 8 tiles: fewer blocks than SMs
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,bands", [
    ((3, 64, 64, 256), 64, 0),       # K1
    ((4, 32, 32, 512), 128, 4),      # K2
])
def test_cuda_kernel_back_to_back_launches_agree(shape, mid, bands):
    """Two launches on one stream, the second while the first may still
    run: the persistent blocks' pipelines share nothing, the outputs are
    equal bit for bit."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(14)
    ws = _folded(rng, shape[-1], mid, shape[-1], False, dev)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    operands = fb.kernel_operands(*ws, bands=bands)
    first = fb.launch(x, operands, bands)
    second = fb.launch(x, operands, bands)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_cuda_kernel_is_wgmma_fed_by_tma():
    """The SASS of K1 and K2 (both forms of the one kernel template, every
    mid) has tensor-core products through wgmma (HGMMA) and TMA loads
    (UTMALDG); the kernels they replaced are gone."""
    _cuda_or_skip()
    import shutil
    import subprocess

    from dir_tpu_torch.ops import cuda_build
    fb.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", cuda_build.library_path(fb.NAME)],
        capture_output=True, text=True, check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:]
                 if "fused_bottleneck_kernel" in f.splitlines()[0]]
    assert len(functions) == 8       # mid 16, 32, 64, 128; resident, streamed
    for f in functions:
        assert "HGMMA" in f and "UTMALDG" in f, f.splitlines()[0]
    assert "streamed_kernel" not in sass


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


def _int8_inputs(seed, shape, mid, o, down, dev):
    """x (bf16), folded weights and three static scales (the input's own
    |max|, and plausible ones for the two intermediates)."""
    rng = np.random.RandomState(seed)
    ws = _folded(rng, shape[-1], mid, o, down, dev)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    scales = [x.float().abs().max() / 127,
              torch.tensor(3.0 / 127, device=dev),
              torch.tensor(3.0 / 127, device=dev)]
    return x, ws, scales


def _int8_mismatch(out, ref):
    """(share of elements that differ, max abs error) of two bf16 maps."""
    diff = (out.float() - ref.float()).abs()
    return float((diff > 0).float().mean()), float(diff.max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,o,down,bands", [
    ((2, 64, 64, 256), 64, 256, False, 1),    # the layer1 shape
    ((2, 64, 64, 256), 64, 256, True, 1),
    ((2, 32, 32, 512), 128, 512, False, 4),   # the layer2 shape
    ((2, 32, 32, 512), 128, 512, True, 4),
    ((1, 10, 20, 32), 32, 32, True, 5),       # ragged tiles on both axes
    ((3, 9, 17, 64), 32, 96, True, 3),
    ((1, 12, 30, 160), 64, 160, False, 2),
    ((1, 96, 192, 128), 32, 128, False, 1),   # 144 tiles at batch 1
    ((5, 64, 64, 256), 64, 256, False, 1),    # 160 tiles, resident
    ((20, 32, 32, 512), 128, 512, False, 4),  # 320 tiles, streamed
    ((3, 32, 32, 512), 128, 512, True, 4),    # 48 tiles, streamed projection
])
def test_cuda_int8_kernel_matches_plain(shape, mid, o, down, bands):
    """K3 against its plain version on the card. The s32 sums are exact and
    the roundings are the same ops in both, so the two are bit-equal."""
    dev = _cuda_or_skip()
    x, ws, scales = _int8_inputs(9, shape, mid, o, down, dev)
    f = q8.fused_bottleneck_int8_infer
    before = f.launches
    out = f(x, *ws[:6], *scales, ws[6], ws[7], bands=bands)
    assert f.launches == before + 1
    ref = q8.fused_bottleneck_int8_infer_plain(x, *ws[:6], *scales, ws[6],
                                               ws[7])
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert torch.isfinite(out).all()
    share, err = _int8_mismatch(out, ref)
    assert share == 0.0, (share, err)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid", [
    ((3, 64, 64, 256), 64),          # resident
    ((4, 32, 32, 512), 128),         # streamed
])
def test_cuda_int8_kernel_back_to_back_launches_agree(shape, mid):
    """Two launches of K3 on one stream, the second while the first may
    still run: bit-equal."""
    dev = _cuda_or_skip()
    x, ws, scales = _int8_inputs(15, shape, mid, shape[-1], False, dev)
    operands = q8.kernel_operands(*ws[:6], *scales)
    first = q8.launch(x, operands)
    second = q8.launch(x, operands)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_cuda_int8_kernel_is_s8_wgmma_fed_by_tma():
    """The SASS of K3 (every mid, both forms) has integer tensor-core
    products through wgmma (IGMMA) and TMA loads (UTMALDG), and no
    mma.sync (IMMA): the tile kernel it replaced is gone."""
    _cuda_or_skip()
    import shutil
    import subprocess

    from dir_tpu_torch.ops import cuda_build
    q8.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", cuda_build.library_path(q8.NAME)],
        capture_output=True, text=True, check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:]
                 if "fused_bottleneck_int8_kernel" in f.splitlines()[0]]
    assert len(functions) == 6       # mid 32, 64, 128; resident, streamed
    for f in functions:
        assert "IGMMA" in f and "UTMALDG" in f, f.splitlines()[0]
    assert "IMMA" not in sass.replace("IGMMA", "")


@pytest.mark.gpu
@pytest.mark.parametrize("c,mid,o,down", [
    (256, 64, 256, False), (256, 64, 256, True), (512, 128, 512, False),
    (512, 128, 512, True), (32, 32, 32, True), (160, 64, 160, False),
    (128, 128, 128, False), (1024, 128, 1024, True), (64, 32, 96, True),
])
def test_cuda_int8_layout_is_the_kernels(c, mid, o, down):
    """Python's image size, shared memory, form and stages are the
    library's."""
    _cuda_or_skip()
    lay = q8.layout(c, mid, o, down)
    assert q8.library_layout(q8._library(), c, mid, o, down) == (
        lay.image_bytes, lay.smem, lay.resident, lay.stages)


@pytest.mark.gpu
def test_cuda_int8_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    x, ws, scales = _int8_inputs(10, (1, 8, 16, 32), 32, 32, False, dev)
    f = q8.fused_bottleneck_int8_infer
    before = f.launches
    with pytest.raises(TypeError):       # a dynamic scale (none given)
        f(x, *ws[:6], None, scales[1], scales[2])
    with pytest.raises(TypeError):       # fp32 activations
        f(x.float(), *ws[:6], *scales)
    with pytest.raises(ValueError):      # bands must divide H
        f(x, *ws[:6], *scales, bands=3)
    with pytest.raises(ValueError):      # not NHWC-contiguous
        f(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), *ws[:6],
          *scales)
    with pytest.raises(ValueError):      # a scale on another device
        f(x, *ws[:6], scales[0].cpu(), scales[1], scales[2])
    x16, ws16, _ = _int8_inputs(10, (1, 8, 16, 16), 16, 16, False, dev)
    with pytest.raises(ValueError):      # widths not multiples of 32
        f(x16, *ws16[:6], *scales)
    assert f.launches == before          # nothing launched


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,o", [
    ((2, 128, 128, 64), 64, 256),        # the stem's shape
    ((1, 16, 24, 16), 16, 32),           # small
    ((3, 24, 36, 32), 32, 48),           # ragged tiles on both axes
    ((1, 128, 128, 64), 64, 256),        # batch 1: 32 tiles, fewer than SMs
    ((5, 128, 128, 64), 64, 256),        # 160 tiles: more than one per SM
])
def test_cuda_stem_kernel_matches_plain(shape, mid, o):
    """K4 against its plain version: the pooled map is bit-equal by
    construction, the bottleneck within K1's tolerance."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(11)
    c = shape[-1]
    ws = _folded(rng, c, mid, o, True, dev)
    g1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    t1 = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, torch.bfloat16)
    f = st.fused_stem_bottleneck
    before = f.launches
    out = f(x, g1, t1, *ws)
    assert f.launches == before + 1
    ref = st.fused_stem_bottleneck_plain(x, g1, t1, *ws)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16
    assert out.shape == ref.shape == (shape[0], shape[1] // 2, shape[2] // 2, o)
    assert torch.isfinite(out).all()
    # four bf16 ulps of the output scale, as for K1
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 4 * 2 ** -8 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("shape,mid,o", [
    ((2, 128, 128, 64), 64, 256),
    ((2, 40, 72, 32), 32, 48),           # ragged tiles, the map's border
])
def test_cuda_stem_kernel_pool_skips_the_zero_fill(shape, mid, o):
    """t1 > 0 on every channel and x mostly below -t1 / g1: most of the
    activated map is 0, so a zero-filled raw pixel outside the map taken
    into the pool (relu(t1) > 0) would raise the border's pooled pixels."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(13)
    c = shape[-1]
    ws = _folded(rng, c, mid, o, True, dev)
    g1 = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(dev)
    t1 = torch.from_numpy(rng.uniform(0.2, 0.6, c).astype(np.float32)).to(dev)
    x = torch.from_numpy((rng.randn(*shape) - 2.0).astype(np.float32)).to(
        dev, torch.bfloat16)
    out = st.fused_stem_bottleneck(x, g1, t1, *ws)
    ref = st.fused_stem_bottleneck_plain(x, g1, t1, *ws)
    torch.cuda.synchronize()
    scale = float(ref.float().abs().max())
    assert float((out.float() - ref.float()).abs().max()) <= 4 * 2 ** -8 * scale


@pytest.mark.gpu
def test_cuda_stem_kernel_back_to_back_launches_agree():
    """Two launches on one stream on operands prepared once: equal bit for
    bit."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(15)
    ws = _folded(rng, 64, 64, 256, True, dev)
    g1 = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32)).to(dev)
    t1 = torch.from_numpy(rng.uniform(-0.5, 0.5, 64).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.randn(3, 128, 128, 64).astype(np.float32)).to(
        dev, torch.bfloat16)
    operands = st.kernel_operands(g1, t1, *ws)
    first = st.launch(x, operands)
    second = st.launch(x, operands)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_cuda_stem_kernel_is_wgmma_fed_by_tma():
    """The SASS of K4 (mid 16, 32, 64) has tensor-core products through
    wgmma (HGMMA) and TMA loads (UTMALDG), and no mma.sync (HMMA): the WMMA
    tile kernel it replaced is gone."""
    _cuda_or_skip()
    import shutil
    import subprocess

    from dir_tpu_torch.ops import cuda_build
    st.build()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "--dump-sass", cuda_build.library_path(st.NAME)],
        capture_output=True, text=True, check=True).stdout
    functions = [f for f in sass.split("Function : ")[1:]
                 if "fused_stem_bottleneck_kernel" in f.splitlines()[0]]
    assert len(functions) == 3
    for f in functions:
        assert "HGMMA" in f and "UTMALDG" in f, f.splitlines()[0]
    assert "HMMA" not in sass


@pytest.mark.gpu
@pytest.mark.parametrize("c,mid,o", [
    (64, 64, 256), (16, 16, 32), (32, 32, 48), (64, 32, 128), (48, 64, 64),
    (32, 16, 256),
])
def test_cuda_stem_layout_is_the_kernels(c, mid, o):
    """Python's image size, shared memory and stages are the library's."""
    _cuda_or_skip()
    assert st.library_layout(st._library(), c, mid, o) == st.layout(c, mid, o)


@pytest.mark.gpu
def test_cuda_stem_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    rng = np.random.RandomState(12)
    ws = _folded(rng, 16, 16, 32, True, dev)
    g1 = torch.ones(16, device=dev)
    t1 = torch.zeros(16, device=dev)
    f = st.fused_stem_bottleneck
    before = f.launches
    with pytest.raises(ValueError):      # pooled height 6 is no multiple of 4
        f(torch.zeros(1, 12, 16, 16, device=dev, dtype=torch.bfloat16), g1,
          t1, *ws)
    with pytest.raises(TypeError):       # fp32 activations
        f(torch.zeros(1, 16, 16, 16, device=dev), g1, t1, *ws)
    with pytest.raises(ValueError):      # a weight on the CPU
        f(torch.zeros(1, 16, 16, 16, device=dev, dtype=torch.bfloat16),
          g1.cpu(), t1, *ws)
    assert f.launches == before          # nothing launched


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k,o,stride,padding", [
    ((2, 16, 16, 64), 1, 32, (1, 1), "SAME"),
    ((2, 16, 16, 64), 3, 40, (2, 2), ((1, 1), (1, 1))),
    ((1, 32, 32, 3), 7, 64, (2, 2), ((3, 3), (3, 3))),   # K = 147
    ((1, 16, 16, 12), 4, 64, (1, 1), ((2, 1), (2, 1))),
    ((1, 2, 2, 8), 1, 8, (1, 1), "SAME"),                # 4 rows
])
def test_cuda_int8_conv_gives_the_cpu_integers(shape, k, o, stride, padding):
    """``conv_s32`` on the card (through ``torch._int_mm``, operands padded
    to its size rules) against the same call on the CPU: bit-equal."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(13)
    xq = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
    wq = torch.from_numpy(
        rng.randint(-127, 128, (k, k, shape[-1], o)).astype(np.int8))
    want = quant.conv_s32(xq, wq, stride, padding)
    got = quant.conv_s32(xq.to(dev), wq.to(dev), stride, padding)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_flagship_config_c_matches_fp32_on_card():
    """A cut-depth flagship in configuration C (int8 static serving, the
    fused int8 bottleneck at layer1_1 and layer2_1) against the fp32 forward
    on the same weights: K3 twice a request, K1/K2/K5 never; calibration
    launches no K3. Int8's own error on seeded random weights: the limit is
    chip_smoke.py's."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import (CONFIG_C, calibrate_static_scales,
                                     condition_random_, flagship_mano,
                                     make_infer, random_init_)

    layers = (2, 2, 1, 1)
    ml, mr = (m.to(dev) for m in flagship_mano())
    ref_model = random_init_(DIR(ModelConfig(backbone_layers=layers)),
                             seed=0).to(dev)
    condition_random_(ref_model, ml, mr, seed=0)
    model = DIR(ModelConfig(backbone_layers=layers, dtype="bfloat16",
                            **CONFIG_C)).to(dev)
    model.load_state_dict(ref_model.state_dict(), strict=True)
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    f, q = fb.fused_bottleneck_infer, q8.fused_bottleneck_int8_infer

    def counts():
        return (f.launches, f.streamed_launches, q.launches,
                bs.bone_splat.launches)

    before = counts()
    calibrate_static_scales(model, img, ml, mr)
    assert counts() == before
    out = make_infer(model, ml, mr)(img)
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 2, 0)
    ref = make_infer(ref_model, ml, mr)(img)
    for key in ("pd_joint_xyz_left", "pd_joint_xyz_right"):
        err_mm = float((out["stages"][-1][key]
                        - ref["stages"][-1][key]).abs().max()) * 1e3
        print(key, err_mm)
        assert err_mm < 40.0, (key, err_mm)


@pytest.mark.gpu
@pytest.mark.parametrize("size,distance", [(32, 2.0), (16, 1.0)])
def test_cuda_bone_splat_gradient_matches_plain_bf16(size, distance):
    """K5's autograd route on the card, bf16 features at the two refine
    stages' sizes, against the plain version's own autograd: a loss linear
    in the splat gives both backwards the same incoming gradient, and K5's
    backward is the plain version."""
    dev = _cuda_or_skip()
    uv, feat = _splat_inputs(9, 4, 64, dev, torch.bfloat16)
    w = torch.randn((4, size, size, 20 * 64),
                    generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    grads = []
    before = bs.bone_splat.launches
    for fn in (bs.bone_splat, bs.bone_splat_plain):
        u = uv.clone().requires_grad_(True)
        f = feat.clone().requires_grad_(True)
        (fn(u, f, size, distance).float() * w).sum().backward()
        grads.append((u.grad, f.grad))
    assert bs.bone_splat.launches == before + 1
    (gu, gf), (pu, pf) = grads
    assert gf.dtype == torch.bfloat16 and gu.dtype == torch.float32
    # the same backward on the same inputs; the feature gradient's
    # scattered sums may add in another order: one bf16 ulp (2^-8) of the
    # max for it, 1e-5 of the max for the fp32 joint gradient
    assert float((gf.float() - pf.float()).abs().max()) <= (
        2 ** -8 * float(pf.float().abs().max()))
    assert float((gu - pu).abs().max()) <= 1e-5 * float(pu.abs().max())


@pytest.mark.gpu
def test_bf16_train_step_on_card_launches_k5():
    """One bf16 train step of a cut-depth flagship with B's decoder flags on
    the card: K5 four times (2 hands x 2 stages), no fused bottleneck; a
    finite loss; the parameters moved."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.models.losses import total_loss
    from dir_tpu_torch.profile_serve import train_batch
    from dir_tpu_torch.serve import (CONFIG_B, condition_random_,
                                     flagship_mano, random_init_)
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    ml, mr = (m.to(dev) for m in flagship_mano())
    model = random_init_(DIR(ModelConfig(
        backbone_layers=(1, 1, 1, 1), dtype="bfloat16", **CONFIG_B)),
        seed=0).to(dev)
    condition_random_(model, ml, mr, seed=0)
    init = {k: v.clone() for k, v in model.named_parameters()}
    opt = make_optimizer(model, TrainConfig(), 1000)
    step = make_train_step(model, opt, model.cfg, ml, mr)
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches, bs.bone_splat.launches)
    state, loss_dict = step(create_train_state(model, opt),
                            train_batch(2, device=dev))
    torch.cuda.synchronize()
    after = (f.launches, f.streamed_launches, bs.bone_splat.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 4)
    assert state.step == 1
    assert np.isfinite(float(total_loss(loss_dict)))
    moved = [k for k, p in model.named_parameters()
             if not torch.equal(p, init[k])]
    assert len(moved) > 0.9 * len(init)
    assert all(torch.isfinite(p).all() for p in model.parameters())


def _train_step_twice(dev, flags: dict):
    """One bf16 train step of a cut-depth flagship with ``flags``, run twice
    from one state_dict: the loss dicts and the states after the step."""
    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.profile_serve import train_batch
    from dir_tpu_torch.serve import (condition_random_, flagship_mano,
                                     random_init_)
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    ml, mr = (m.to(dev) for m in flagship_mano())
    cfg = ModelConfig(backbone_layers=(1, 1, 1, 1), dtype="bfloat16", **flags)
    init = random_init_(DIR(cfg), seed=0).to(dev)
    condition_random_(init, ml, mr, seed=0)
    sd = {k: v.clone() for k, v in init.state_dict().items()}
    batch = train_batch(8, device=dev)
    runs = []
    for _ in range(2):
        model = DIR(cfg).to(dev)
        model.load_state_dict(sd, strict=True)
        opt = make_optimizer(model, TrainConfig(), 1000)
        step = make_train_step(model, opt, cfg, ml, mr)
        _, loss = step(create_train_state(model, opt), batch)
        torch.cuda.synchronize()
        runs.append(({k: float(v) for k, v in loss.items()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    return runs


@pytest.mark.gpu
@pytest.mark.parametrize("decoder", ["T", "default"])
def test_bf16_train_step_repeats_bit_for_bit_on_card(decoder):
    """The train step runs under deterministic algorithms: no op of T's or
    the default decoder's step raises for want of a deterministic form, and
    the step repeats to the bit (losses, parameters, BN statistics)."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.serve import CONFIG_B

    (loss_a, sd_a), (loss_b, sd_b) = _train_step_twice(
        dev, CONFIG_B if decoder == "T" else {})
    assert all(np.isfinite(v) for v in loss_a.values())
    assert loss_a == loss_b
    assert [k for k, v in sd_a.items() if not torch.equal(v, sd_b[k])] == []
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["grid_sample_nhwc_mm", "upsample2x"])
def test_decoder_op_backward_repeats_on_card(op):
    """The decoder's sampler and upsample, forward and backward to the maps
    under ``deterministic()`` on bf16 maps of the flagship's 32x32 stage:
    no raise, and the gradients of two runs equal to the bit."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.device import deterministic
    from dir_tpu_torch.models.layers import upsample2x
    from dir_tpu_torch.ops.sampling import grid_sample_nhwc_mm

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((16, 32, 32, 256), device=dev, generator=g).to(
        torch.bfloat16)
    coords = torch.rand((16, 42, 2), device=dev, generator=g) * 2.2 - 1.1
    fn = ((lambda v: grid_sample_nhwc_mm(v, coords))
          if op == "grid_sample_nhwc_mm" else upsample2x)
    grads = []
    with deterministic():
        for _ in range(2):
            xg = x.detach().requires_grad_(True)
            out = fn(xg)
            seed = torch.Generator(device=dev).manual_seed(4)
            (grad,) = torch.autograd.grad(out, xg, torch.randn(
                out.shape, device=dev, generator=seed).to(out.dtype))
            grads.append(grad)
    torch.cuda.synchronize()
    assert torch.isfinite(grads[0].float()).all()
    assert torch.equal(grads[0], grads[1])


@pytest.mark.gpu
def test_grid_sample_mm_matches_f_grid_sample_on_card():
    """The selection-matrix sampler against ``F.grid_sample`` on fp32 maps
    (TF32 off): equal to fp32 rounding, points outside the map included."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.ops.sampling import (grid_sample_nhwc,
                                            grid_sample_nhwc_mm)

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((8, 32, 32, 64), device=dev, generator=g)
    coords = torch.rand((8, 42, 2), device=dev, generator=g) * 2.4 - 1.2
    got = grid_sample_nhwc_mm(x, coords)
    want = grid_sample_nhwc(x, coords)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    # four products of values up to about 4.5, summed in another order
    assert float((got - want).abs().max()) <= 4 * 2 ** -23 * float(
        want.abs().max())


def _fp32_models(dev, **flags):
    """A (3, 1, 1, 1) fp32 flagship with ``flags`` and the same weights
    without the fused flags, both in eval mode on the card."""
    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.serve import random_init_

    layers = (3, 1, 1, 1)
    model = random_init_(DIR(ModelConfig(backbone_layers=layers, **flags)),
                         seed=0).to(dev).eval()
    plain_flags = dict(flags, fused_bottleneck_eval=False, quant_fused=False)
    plain = DIR(ModelConfig(backbone_layers=layers, **plain_flags)).to(dev)
    plain.load_state_dict(model.state_dict(), strict=True)
    return model, plain.eval()


def _assert_outputs_close(out, ref, rtol):
    for so, sr in zip(out["stages"], ref["stages"]):
        for key in sr:
            scale = float(sr[key].abs().max())
            assert float((so[key] - sr[key]).abs().max()) <= rtol * scale, key
    for key in ("seg", "dense"):
        scale = float(ref[key].abs().max())
        assert float((out[key] - ref[key]).abs().max()) <= rtol * scale, key


@pytest.mark.gpu
def test_fp32_with_fused_flags_serves_on_card():
    """An fp32 trunk with ``fused_bottleneck_eval=True, fused_l2_bands=4``:
    the guard sends layer1_1 and layer1_2 to the unfused fp32 block (the
    kernels take bf16 only) and the model serves as the one without the
    flags does."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.models.resnet import Bottleneck
    from dir_tpu_torch.serve import flagship_mano, make_infer

    model, plain = _fp32_models(dev, fused_bottleneck_eval=True,
                                fused_l2_bands=4)
    ml, mr = (m.to(dev) for m in flagship_mano())
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches, Bottleneck.fp32_unfused_runs)
    out = make_infer(model, ml, mr)(img)
    after = (f.launches, f.streamed_launches, Bottleneck.fp32_unfused_runs)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 0, 2)
    # the same fp32 computation: equal up to cuDNN's choice of algorithm
    _assert_outputs_close(out, make_infer(plain, ml, mr)(img), 1e-5)


@pytest.mark.gpu
def test_fp32_with_config_c_serves_on_card():
    """An fp32 trunk with the C flags: the fused int8 guard sends layer1_1
    and layer1_2 to the unfused int8 route, and the model serves as the one
    with ``quant_fused=False`` on the same calibrated scales does."""
    dev = _cuda_or_skip()
    from dir_tpu_torch import weights
    from dir_tpu_torch.models.resnet import Bottleneck
    from dir_tpu_torch.serve import (CONFIG_C, calibrate_static_scales,
                                     flagship_mano, make_infer)

    model, plain = _fp32_models(dev, **CONFIG_C)
    ml, mr = (m.to(dev) for m in flagship_mano())
    img = np.random.RandomState(1).randn(2, 256, 256, 3).astype(np.float32)
    calibrate_static_scales(model, img, ml, mr)
    layers = model.cfg.backbone_layers
    weights.load_amax(plain, weights.quant_stats_to_amax(
        weights.amax_to_quant_stats(model, layers), layers))
    q = q8.fused_bottleneck_int8_infer
    before = (q.launches, Bottleneck.fp32_unfused_runs)
    out = make_infer(model, ml, mr)(img)
    after = (q.launches, Bottleneck.fp32_unfused_runs)
    assert tuple(a - b for a, b in zip(after, before)) == (0, 2)
    _assert_outputs_close(out, make_infer(plain, ml, mr)(img), 1e-5)


# -- the data pipeline and the Trainer on the card ---------------------------

def _synthetic_split(tmp_path, n: int, img_size: int):
    from dir_tpu_torch.data import synthetic
    from dir_tpu_torch.serve import flagship_mano

    ml, mr = flagship_mano()
    synthetic.generate(str(tmp_path), ml, mr, split="test", num_samples=n,
                       img_size=img_size)
    return str(tmp_path), ml, mr


@pytest.mark.gpu
@pytest.mark.parametrize("train", [False, True])
def test_device_pipeline_on_card_matches_cpu(tmp_path, train):
    """The on-device preprocessing on the card against the same call on
    the CPU with the same draws (made once on the CPU). Bounds as the CPU
    tests hold the port against the JAX package: the image 1e-3, dense
    3e-4, labels 1e-5, at most 1e-4 of the seg labels differing (a warped
    mask's channels can tie within rounding)."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.data import device_pipeline as tdp
    from dir_tpu_torch.data.loader import collate

    data_dir, ml, mr = _synthetic_split(tmp_path, 4, 128)
    raw = collate([tdp.RawInterHandDataset(data_dir, "test")[i]
                   for i in range(4)])
    draws = tdp.draw_augmentation(torch.Generator().manual_seed(1), 4,
                                  raw["img"].shape[1:]) if train else None
    want = tdp.make_preprocess_fn(ml, mr, img_size=128, train=train,
                                  device="cpu")(raw, draws=draws)
    got = tdp.make_preprocess_fn(ml, mr, img_size=128, train=train,
                                 device=dev)(
        raw, draws=None if draws is None else {k: v.to(dev)
                                               for k, v in draws.items()})
    tol = {"img": 1e-3, "dense": 3e-4}
    for k, w in want.items():
        g = got[k]
        assert g.device.type == "cuda" and g.shape == w.shape, k
        if k == "seg":
            assert float((g.cpu() != w).float().mean()) <= 1e-4
        else:
            err = float((g.cpu().double() - w.double()).abs().max())
            assert err <= tol.get(k, 1e-5), (k, err)


@pytest.mark.gpu
def test_loader_pins_batches_for_the_card(tmp_path):
    """With pin_memory the batches are pinned tensors holding the numpy
    loader's values; the copy to the card is asynchronous."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.data.device_pipeline import RawInterHandDataset
    from dir_tpu_torch.data.loader import BatchLoader

    data_dir, _, _ = _synthetic_split(tmp_path, 3, 64)
    ds = RawInterHandDataset(data_dir, "test", img_size=64)
    kw = dict(batch_size=2, drop_last=False, pad_last=True, num_threads=2)
    pinned = list(BatchLoader(ds, pin_memory=True, **kw))
    plain = list(BatchLoader(ds, **kw))
    assert [int(b["_valid"]) for b in pinned] == [2, 1]
    for p, q in zip(pinned, plain):
        for k, v in q.items():
            if k == "_valid":
                continue
            assert isinstance(p[k], torch.Tensor) and p[k].is_pinned(), k
            np.testing.assert_array_equal(p[k].numpy(), v)
            on_card = p[k].to(dev, non_blocking=True)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(on_card.cpu().numpy(), v)


@pytest.mark.gpu
def test_trainer_evaluate_on_card_launches_the_kernels(tmp_path):
    """Trainer.evaluate() on the card in a bf16 model with configuration
    B's flags (backbone (3, 4, 1, 1), so that the fused guards take
    layer1_1-2 and layer2_1-3): one eval batch launches K1 2 times, K2 3
    times and K5 4 times, and gives a finite summary; one train step
    launches K5 4 times and nothing else."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                      TrainConfig)
    from dir_tpu_torch.data import synthetic
    from dir_tpu_torch.serve import CONFIG_B, flagship_mano
    from dir_tpu_torch.train.trainer import Trainer

    ml, mr = flagship_mano()
    data_dir = str(tmp_path / "data")
    for split, n in (("train", 2), ("test", 2)):
        synthetic.generate(data_dir, ml, mr, split=split, num_samples=n)
    cfg = Config(
        model=ModelConfig(backbone_layers=(3, 4, 1, 1), dtype="bfloat16",
                          fused_bottleneck_eval=True, **CONFIG_B),
        data=DataConfig(data_dir=data_dir, device_pipeline=True,
                        num_workers=2),
        train=TrainConfig(batch_size=2, total_epochs=1, print_every=1,
                          draw_every=0, output_dir=str(tmp_path / "out")))
    trainer = Trainer(cfg, ml, mr, device=dev)
    trainer.make_data()
    trainer.make_model()
    f = fb.fused_bottleneck_infer

    def counts():
        return (f.launches, f.streamed_launches, bs.bone_splat.launches)

    before = counts()
    summary = trainer.evaluate()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 3, 4)
    assert all(np.isfinite(v) for v in summary.values())
    before = counts()
    batch = next(iter(trainer.train_loader))
    dev_batch = trainer.preprocess_train(batch, trainer.aug_generator)
    trainer.state, loss = trainer.train_step(trainer.state, dev_batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (0, 0, 4)
    assert all(bool(torch.isfinite(v)) for v in loss.values())


# ------------------------------------- the kernels as torch.library ops


@pytest.mark.gpu
def test_ops_equal_the_launch_path():
    """Each ``torch.ops.dir_tpu.*`` op on CUDA tensors: bit-equal to the
    kernel's launch on the same operands, and counted as one launch."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(30)
    for bands, shape, mid in ((0, (2, 64, 64, 256), 64),
                              (4, (2, 32, 32, 512), 128)):
        x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dev, torch.bfloat16)
        ops = fb.kernel_operands(*_folded(rng, shape[-1], mid, shape[-1],
                                          False, dev), bands=bands)
        f = fb.fused_bottleneck_infer
        before = f.launches + f.streamed_launches
        out = fb.call(x, ops, bands)
        assert f.launches + f.streamed_launches == before + 1
        assert torch.equal(out, fb.launch(x, ops, bands))

    x, ws, scales = _int8_inputs(31, (2, 64, 64, 256), 64, 256, True, dev)
    ops = q8.kernel_operands(*ws[:6], *scales, *ws[6:])
    before = q8.fused_bottleneck_int8_infer.launches
    out = q8.call(x, ops)
    assert q8.fused_bottleneck_int8_infer.launches == before + 1
    assert torch.equal(out, q8.launch(x, ops))

    ws = _folded(rng, 64, 64, 256, True, dev)
    g1 = torch.ones(64, device=dev)
    t1 = torch.zeros(64, device=dev)
    x = torch.from_numpy(rng.randn(2, 64, 64, 64).astype(np.float32)).to(
        dev, torch.bfloat16)
    ops = st.kernel_operands(g1, t1, *ws)
    before = st.fused_stem_bottleneck.launches
    out = st.call(x, ops)
    assert st.fused_stem_bottleneck.launches == before + 1
    assert torch.equal(out, st.launch(x, ops))

    uv = torch.from_numpy(rng.uniform(-0.9, 0.9, (4, 21, 2)).astype(
        np.float32)).to(dev)
    feat = torch.from_numpy(rng.randn(4, 21, 64).astype(np.float32)).to(
        dev, torch.bfloat16)
    before = bs.bone_splat.launches
    out = torch.ops.dir_tpu.bone_splat(uv, feat, 32, 2.0)
    assert bs.bone_splat.launches == before + 1
    assert torch.equal(out, bs._launch(uv, feat, 32, 2.0))


@pytest.mark.gpu
def test_opcheck_on_the_cuda_implementations():
    """``torch.library.opcheck`` of each op on CUDA tensors: schema, fake
    implementation against the kernel's output, the autograd registration
    of K5."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(32)
    x = torch.from_numpy(rng.randn(1, 16, 16, 64).astype(np.float32)).to(
        dev, torch.bfloat16)
    op = fb.kernel_operands(*_folded(rng, 64, 32, 64, False, dev), bands=0)
    torch.library.opcheck(torch.ops.dir_tpu.fused_bottleneck.default,
                          (x, op.image, op.b1, op.b2, op.b3, op.bd, op.mid,
                           op.o, 0))
    x, ws, scales = _int8_inputs(33, (1, 16, 16, 64), 32, 64, False, dev)
    op = q8.kernel_operands(*ws[:6], *scales, *ws[6:])
    torch.library.opcheck(torch.ops.dir_tpu.fused_bottleneck_int8.default,
                          (x, *op[:10], op.mid, op.o))
    ws = _folded(rng, 16, 16, 64, True, dev)
    op = st.kernel_operands(torch.ones(16, device=dev),
                            torch.zeros(16, device=dev), *ws)
    x = torch.from_numpy(rng.randn(1, 16, 16, 16).astype(np.float32)).to(
        dev, torch.bfloat16)
    torch.library.opcheck(torch.ops.dir_tpu.fused_stem_bottleneck.default,
                          (x, op.image, op.vec, op.gt, op.mid, op.o))
    uv = torch.from_numpy(rng.uniform(-0.9, 0.9, (2, 21, 2)).astype(
        np.float32)).to(dev).requires_grad_(True)
    feat = torch.from_numpy(rng.randn(2, 21, 16).astype(np.float32)).to(
        dev).requires_grad_(True)
    torch.library.opcheck(torch.ops.dir_tpu.bone_splat.default,
                          (uv, feat, 16, 1.5))


@pytest.mark.gpu
def test_config_b_artifact_launches_the_kernels():
    """Configuration B exported on the card (symbolic batch): its graph
    names the ops, and each call of the program launches K1 2, K2 3 and K5
    4 times, from the counters in the ops' CUDA implementations; its
    outputs equal the live model's on the ops an export traces (the
    unfused composition: ``conv_epilogue.engages`` is False while
    exporting)."""
    _cuda_or_skip()
    from dir_tpu_torch.serve import (CONFIG_B, build_flagship,
                                     export_program, make_infer, op_counts)

    model, _, ml, mr = build_flagship(device="cuda", seed=0, **CONFIG_B)
    program = export_program(model, ml, mr)
    assert op_counts(program) == {"fused_bottleneck": 5,
                                  "fused_bottleneck_int8": 0,
                                  "fused_stem_bottleneck": 0,
                                  "bone_splat": 4}
    module = program.module()
    img = torch.randn(3, 256, 256, 3,
                      generator=torch.Generator().manual_seed(1)).cuda()
    f = fb.fused_bottleneck_infer
    before = (f.launches, f.streamed_launches, bs.bone_splat.launches)
    with torch.inference_mode():
        out = module(img)
        torch.cuda.synchronize()
    assert (f.launches - before[0], f.streamed_launches - before[1],
            bs.bone_splat.launches - before[2]) == (2, 3, 4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv_epilogue, "engages", lambda module, x: False)
        want = make_infer(model, ml, mr)(img)
    for key, value in want["stages"][-1].items():
        # the same ops on the same tensors: measured equal
        assert torch.equal(out["stages"][-1][key], value), key


@pytest.mark.gpu
def test_bone_splat_op_gradient_is_the_plain_version():
    """The gradient of ``torch.ops.dir_tpu.bone_splat`` (its
    ``register_autograd``) on the card equals the plain version's gradient
    on the card, bit for bit: both differentiate the same plain graph."""
    dev = _cuda_or_skip()
    rng = np.random.RandomState(34)
    uv = torch.from_numpy(rng.uniform(-0.9, 0.9, (4, 21, 2)).astype(
        np.float32)).to(dev).requires_grad_(True)
    feat = torch.from_numpy(rng.randn(4, 21, 64).astype(np.float32)).to(
        dev).requires_grad_(True)
    g = torch.from_numpy(rng.randn(4, 16, 16, 1280).astype(np.float32)).to(
        dev)
    got = torch.autograd.grad(torch.ops.dir_tpu.bone_splat(uv, feat, 16, 1.0),
                              (uv, feat), g)
    want = torch.autograd.grad(bs.bone_splat_plain(uv, feat, 16, 1.0),
                               (uv, feat), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_world_of_one_nccl_step_equals_no_mesh():
    """Two fp32 train steps of a cut-depth flagship with B's decoder flags
    through a mesh of one NCCL rank equal the steps without a mesh: a world
    of 1 makes every collective the identity. cuDNN's and the scatters'
    atomics sum in another order in each run, so the bound is four times
    the steps' own spread when repeated without a mesh (losses relative,
    parameters and BN statistics in each tensor's max), and at least 1e-6
    of each."""
    dev = _cuda_or_skip()
    import socket

    import torch.distributed as dist

    from dir_tpu_torch.config import ModelConfig, TrainConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.parallel import mesh as pmesh
    from dir_tpu_torch.profile_serve import train_batch
    from dir_tpu_torch.serve import (CONFIG_B, condition_random_,
                                     flagship_mano, random_init_)
    from dir_tpu_torch.train.state import create_train_state, make_optimizer
    from dir_tpu_torch.train.steps import make_train_step

    ml, mr = (m.to(dev) for m in flagship_mano())
    base = random_init_(DIR(ModelConfig(
        backbone_layers=(1, 1, 1, 1), **CONFIG_B)), seed=0).to(dev)
    condition_random_(base, ml, mr, seed=0)
    init = {k: v.clone() for k, v in base.state_dict().items()}
    batches = [train_batch(4, seed=i, device=dev) for i in range(2)]

    def run(mesh):
        model = DIR(base.cfg).to(dev)
        model.load_state_dict(init, strict=True)
        opt = make_optimizer(model, TrainConfig(), 1)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, model.cfg, ml, mr, mesh=mesh)
        losses = []
        for b in batches:
            block = b if mesh is None else pmesh.shard_batch(b, mesh)
            state, ld = step(state, block)
            losses.append(float(sum(v.double() for v in ld.values())))
        return np.array(losses), model.state_dict()

    def diff(a, b):
        loss = float(np.abs(a[0] - b[0]).max() / np.abs(b[0]).max())
        state = max(float((a[1][k].double() - w.double()).abs().max()
                          / max(float(w.double().abs().max()), 1e-30))
                    for k, w in b[1].items() if w.is_floating_point())
        return loss, state

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    pmesh.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl",
                           timeout=120)
    try:
        assert dist.get_backend() == "nccl"
        mesh = pmesh.make_mesh(1)
        assert (mesh.world, mesh.device.type) == (1, "cuda")
        got = run(mesh)
    finally:
        dist.destroy_process_group()
    want, again = run(None), run(None)
    err, spread = diff(got, want), diff(again, want)
    print(f"a world of 1 against no mesh {err}, no mesh repeated {spread}")
    for e, sp in zip(err, spread):
        assert e <= max(4 * sp, 1e-6)


@pytest.mark.gpu
def test_global_batch_norm_matches_sync_batch_norm(tmp_path):
    """The port's global BatchNorm against PyTorch's ``nn.SyncBatchNorm``
    (its CUDA statistics kernels, which refuse CPU tensors) in two gloo
    ranks sharing the card, on the same blocks of an fp32 batch with
    |mean| > std: outputs, input and parameter gradients and running
    statistics, each within 1e-5 of the reference's max |value|."""
    _cuda_or_skip()
    import os
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_port_parallel_worker import run_ranks

    from dir_tpu_torch.models.layers import BatchNorm2d

    rng = np.random.RandomState(3)
    c = 16
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c)))
        bn.bias.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, c)))
        bn.running_mean.copy_(torch.from_numpy(rng.randn(c)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c)))
    args = {"channels": c, "state": bn.state_dict(),
            "x": (rng.randn(8, c, 9, 7) * 2 + 3).astype(np.float32),
            "grad": rng.randn(8, c, 9, 7).astype(np.float32)}
    ranks = run_ranks([("sync_bn", "sync_bn", args)], 2, str(tmp_path),
                      timeout=300, device="cuda")
    for r in ranks:
        errs = r["sync_bn"]
        print(f"global BN against SyncBatchNorm: {errs}")
        assert max(errs.values()) <= 1e-5, errs


@pytest.mark.gpu
def test_bench_line_on_card():
    """``python -m dir_tpu_torch.bench`` at a cut protocol on the card: one
    JSON line, last, with bench.py's keys and the card's name, every
    number positive; the traced call's and the sync report's lines
    before it."""
    _cuda_or_skip()
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, BENCH_BATCH="8", BENCH_TRAIN_BATCH="4",
               EVAL_UNROLL="2", UNROLL="2")
    proc = subprocess.run([sys.executable, "-m", "dir_tpu_torch.bench"],
                          cwd=repo, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines))
    rec = json.loads(lines[-1])
    assert sum(ln.startswith("{") for ln in lines) == 1
    for key in ("value", "vs_baseline", "train_step_ms_b64",
                "train_img_per_sec", "serving_int8_static_img_per_sec"):
        assert rec[key] > 0, key
    assert rec["metric"] == "dir_eval_images_per_sec"
    assert "error" not in rec and "H100" in rec["device"]
    assert any("device busy" in ln for ln in lines)
    assert any("host syncs" in ln for ln in lines)


@pytest.mark.gpu
def test_bench_eval_call_launches_k1_twice_a_forward():
    """The bench's unrolled eval call on its flagship flags at cut depth:
    K1 at layer1_1 and layer1_2 of every forward, the outputs finite."""
    dev = _cuda_or_skip()
    from dir_tpu_torch import bench

    model, _, ml, mr = bench.conditioned_flagship(
        dev, **dict(bench.eval_flags(0, False, True),
                    backbone_layers=(3, 1, 1, 1)))
    img = torch.from_numpy(np.random.RandomState(0).randn(
        2, 2, 256, 256, 3).astype(np.float32)).to(dev)
    call = bench.eval_call(model, ml, mr, unroll=2)
    call(img)
    before = fb.fused_bottleneck_infer.launches
    outs = call(img)
    torch.cuda.synchronize()
    assert fb.fused_bottleneck_infer.launches - before == 4
    bench.check_finite([t for triple in outs for t in triple], "eval")


@pytest.mark.gpu
@pytest.mark.parametrize("size,distance", [(32, 2.0), (16, 1.0)])
def test_bench_components_splats_on_the_card(size, distance):
    """``tools/bench_components.py``'s ``_pallas`` splat (K5) against its
    ``_jnp`` splat (the plain version) on the tool's batch-64 draws, within
    K5's bound: one bf16 ulp outside the threshold pairs, at most 0.1 % of
    the pairs left out; one launch."""
    dev = _cuda_or_skip()
    from dir_tpu_torch.tools import bench_components as tool

    data = tool.draws(tool.BATCH)
    uv = torch.from_numpy(data["uv"]).to(dev)
    feat = torch.from_numpy(data["feat"]).to(dev, torch.bfloat16)
    before = bs.bone_splat.launches
    out = tool.splat(size, distance, True)(uv, feat)
    assert bs.bone_splat.launches == before + 1
    ref = tool.splat(size, distance, False)(uv, feat)
    torch.cuda.synchronize()
    assert bs.bone_splat.launches == before + 1
    assert out.shape == ref.shape == (tool.BATCH, size, size, 1280)
    assert torch.isfinite(out).all()
    near = bs.threshold_pairs(uv, size, distance)
    err, tol, left_out = bs.mismatch_outside_threshold(out, ref, near)
    assert left_out <= 1e-3 and err <= tol, (err, tol, left_out)
