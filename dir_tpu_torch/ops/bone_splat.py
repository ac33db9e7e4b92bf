"""Bone-feature splat: per-joint features projected back to image space
along the skeleton's bones (kernel K5 and its plain version).

Counterpart of ``dir_tpu/ops/bone_splat.py`` (the plain version) and of
``dir_tpu/ops/pallas_bone_splat.py`` (the kernel). For every pixel centre
and each of the 20 hand bones, pixels closer to the bone's segment than
``distance`` receive the bone's two endpoint features, interpolated by
the relative distance to the endpoints. Only the materialized splat
branch of the model (``fused_splat_conv=False``) runs it.

The kernel is the PyTorch op ``torch.ops.dir_tpu.bone_splat``: on a CUDA
tensor it launches the hand-written kernel in ``csrc/bone_splat.cu``; on a
CPU tensor it runs :func:`bone_splat_plain`; its fake implementation gives
the output's shape, so that a traced or exported graph names the op
whatever the device. There is no other fallback: a CUDA tensor the kernel
does not take raises. Its gradient (``register_autograd``) differentiates
the plain version, as the JAX package's ``custom_vjp`` does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dir_tpu_torch.device import index_tensor
from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops.splat_conv import (CHILD, PARENT, bone_distances,
                                          splat_weights)

NAME = "bone_splat"                  # csrc/bone_splat.cu
# The mask is a step: the kernel's geometry must round as the plain
# version's elementwise ops do, so a*b+c is not contracted into an FMA.
NVCC_EXTRA_FLAGS = ("-fmad=false",)
# Even so a (pixel, bone) pair within rounding of the threshold can fall on
# either side in two implementations; a comparison leaves out the pairs this
# close to it, in pixels (:func:`threshold_pairs`).
THRESHOLD_MARGIN_PX = 1e-4


def bone_splat_plain(joint_uv: torch.Tensor, joint_feat: torch.Tensor,
                     size: int, distance: float) -> torch.Tensor:
    """Plain PyTorch version, any float dtype, any device.

    Args:
        joint_uv: (B, 21, 2) joint positions in [-1, 1] image coordinates.
        joint_feat: (B, 21, C) per-joint features.
        size: side S of the output map.
        distance: threshold in pixels for a pixel to receive a bone.
    Returns:
        (B, S, S, 20*C) in the features' dtype, bone-major, channel-minor.
        The geometry runs in at least fp32; the masked weights are cast to
        the feature dtype, the two products are summed in at least fp32
        and the sum is cast once.
    """
    dt = joint_feat.dtype
    acc = torch.promote_types(dt, torch.float32)
    b, _, c = joint_feat.shape
    w_a, w_b = splat_weights(joint_uv, size, distance)
    w_a = w_a.to(dt).to(acc)[..., None]                  # (B, S, S, 20, 1)
    w_b = w_b.to(dt).to(acc)[..., None]
    dev = joint_feat.device
    fa = joint_feat[:, index_tensor(PARENT, dev)].to(acc)[:, None, None]
    fb = joint_feat[:, index_tensor(CHILD, dev)].to(acc)[:, None, None]
    out = w_a * fa + w_b * fb                            # (B, S, S, 20, C)
    return out.to(dt).reshape(b, size, size, 20 * c)


def threshold_pairs(joint_uv: torch.Tensor, size: int,
                    distance: float) -> torch.Tensor:
    """(B, S, S, 20) bool: the (pixel, bone) pairs whose distance to the
    segment, in the plain version's geometry, lies within
    THRESHOLD_MARGIN_PX of ``distance``."""
    seg_dist, _, _, _ = bone_distances(joint_uv, size)
    b = joint_uv.shape[0]
    return ((seg_dist - distance).abs() < THRESHOLD_MARGIN_PX).reshape(
        b, size, size, 20)


def mismatch_outside_threshold(out: torch.Tensor, ref: torch.Tensor,
                               near: torch.Tensor):
    """How two splat maps of one input differ away from the mask's step.

    ``near``: :func:`threshold_pairs` of the input. Returns ``(err, tol,
    share)``: the max abs difference over the elements whose (pixel, bone)
    pair is not in ``near``; one ulp of the maps' dtype at ``ref``'s max
    |value|, the tolerance to hold ``err`` to; and the share of pairs left
    out."""
    b, size, _, ch = ref.shape
    keep = ~near[..., None].expand(b, size, size, 20, ch // 20).reshape(
        ref.shape)
    err = float(((out.float() - ref.float()).abs() * keep).max())
    scale = float(ref.float().abs().max())
    tol = 0.0 if scale == 0.0 else float(
        torch.finfo(ref.dtype).eps * 2.0 ** math.floor(math.log2(scale)))
    return err, tol, float(near.float().mean())


def build() -> str:
    """Compile the kernel library if it is missing or older than its
    source; returns the ``-Xptxas -v`` report of the last build."""
    return cuda_build.build(NAME, NVCC_EXTRA_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    build()
    lib = ctypes.CDLL(cuda_build.library_path(NAME))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.bone_splat_bf16, lib.bone_splat_f32):
        fn.argtypes = [vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
        fn.restype = ci
    lib.bone_splat_max_channels.argtypes = [ci]
    lib.bone_splat_max_channels.restype = ci
    lib.bone_splat_error_string.argtypes = [ci]
    lib.bone_splat_error_string.restype = ctypes.c_char_p
    return lib


def _launch(joint_uv, joint_feat, size: int, distance: float) -> torch.Tensor:
    dt = joint_feat.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA kernel takes bf16 or fp32 features, got "
                        f"{dt}")
    if joint_uv.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes fp32 joint positions, got "
                        f"{joint_uv.dtype}")
    if joint_feat.dim() != 3 or joint_feat.shape[1] != 21:
        raise ValueError(f"joint_feat: shape {tuple(joint_feat.shape)}, "
                         "expected (B, 21, C)")
    b, _, c = joint_feat.shape
    if tuple(joint_uv.shape) != (b, 21, 2):
        raise ValueError(f"joint_uv: shape {tuple(joint_uv.shape)}, expected "
                         f"{(b, 21, 2)}")
    lib = _library()
    vec = 16 // joint_feat.element_size()
    max_c = lib.bone_splat_max_channels(joint_feat.element_size())
    if c % vec or c > max_c:
        raise ValueError(f"C={c} must be a multiple of {vec} and at most "
                         f"{max_c}")
    if not 0 < b <= 65535 or size <= 0:
        raise ValueError(f"batch {b} outside 1..65535 or size {size} <= 0")
    uv = joint_uv.contiguous()
    feat = joint_feat.contiguous()
    dev = feat.device
    out = torch.empty((b, size, size, 20 * c), dtype=dt, device=dev)
    kernel = lib.bone_splat_bf16 if dt == torch.bfloat16 else lib.bone_splat_f32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kernel(uv.data_ptr(), feat.data_ptr(), out.data_ptr(), b, size,
                    c, float(distance), stream)
    if rc != 0:
        msg = lib.bone_splat_error_string(rc).decode()
        raise RuntimeError(f"bone splat launch failed: {msg}")
    bone_splat.launches += 1
    return out


@torch.library.custom_op(
    "dir_tpu::bone_splat", mutates_args=(), device_types="cpu",
    schema="(Tensor joint_uv, Tensor joint_feat, int size, float distance) "
           "-> Tensor")
def _op(joint_uv, joint_feat, size, distance):
    """The CPU implementation: the plain version."""
    bone_splat.plain_runs += 1
    return bone_splat_plain(joint_uv, joint_feat, size, distance)


_op.register_kernel("cuda")(_launch)


@_op.register_fake
def _op_fake(joint_uv, joint_feat, size, distance):
    b, _, c = joint_feat.shape
    return joint_feat.new_empty((b, size, size, 20 * c))


def _setup_context(ctx, inputs, output):
    joint_uv, joint_feat, size, distance = inputs
    ctx.save_for_backward(joint_uv, joint_feat)
    ctx.size, ctx.distance = size, distance


def _backward(ctx, grad_out):
    """The plain version's gradient, whichever route ran the forward."""
    joint_uv, joint_feat = ctx.saved_tensors
    with torch.enable_grad():
        uv = joint_uv.detach().requires_grad_(True)
        feat = joint_feat.detach().requires_grad_(True)
        out = bone_splat_plain(uv, feat, ctx.size, ctx.distance)
        g_uv, g_feat = torch.autograd.grad(out, (uv, feat), grad_out)
    return g_uv, g_feat, None, None


_op.register_autograd(_backward, setup_context=_setup_context)


def bone_splat(joint_uv: torch.Tensor, joint_feat: torch.Tensor, size: int,
               distance: float) -> torch.Tensor:
    """The bone splat through kernel K5 (``torch.ops.dir_tpu.bone_splat``).

    Same arguments and result as :func:`bone_splat_plain`. CUDA tensors
    (fp32 ``joint_uv``; bf16 or fp32 ``joint_feat``) go to the kernel, CPU
    tensors to the plain version; the gradient is the plain version's
    either way. ``bone_splat.launches`` counts the kernel's launches only;
    ``bone_splat.plain_runs`` counts the CPU calls that ran the plain
    version in its place.
    """
    if joint_uv.device != joint_feat.device:
        raise ValueError(f"joint_uv is on {joint_uv.device}, joint_feat on "
                         f"{joint_feat.device}")
    if joint_feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bone splat for device {joint_feat.device}")
    return torch.ops.dir_tpu.bone_splat(joint_uv, joint_feat, int(size),
                                        float(distance))


bone_splat.launches = 0
bone_splat.plain_runs = 0
