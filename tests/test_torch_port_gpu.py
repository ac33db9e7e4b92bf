"""Tests of the port that need the card: the CUDA kernel K1 against its
plain version, and the bf16 forward with K1 against the fp32 forward.

They import nothing of JAX, so they run on a machine without it. Each
decides inside the test whether a card is present and skips without
one. On the card:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

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
def test_cuda_kernel_refuses_what_it_does_not_take():
    dev = _cuda_or_skip()
    ws = [torch.zeros(s, device=dev) for s in
          ((16, 16), (16,), (3, 3, 16, 16), (16,), (16, 16), (16,))]
    before = fb.fused_bottleneck_infer.launches
    with pytest.raises(TypeError):   # fp32 activations
        fb.fused_bottleneck_infer(torch.zeros(1, 4, 4, 16, device=dev), *ws)
    x = torch.zeros(1, 16, 4, 4, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # not NHWC-contiguous
        fb.fused_bottleneck_infer(x.permute(0, 2, 3, 1), *ws)
    assert fb.fused_bottleneck_infer.launches == before  # nothing launched


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
