"""Int8 post-training quantization of inference convolutions
(counterpart of ``dir_tpu/ops/quant.py``, same names).

Scheme: BN is folded into the conv first (exact fp32 algebra); weights are
symmetric per output channel, scale ``max|W_o| / 127``; activations are
symmetric per tensor, the scale either each batch's ``|max| / 127``
(dynamic) or a calibrated one (static); the products accumulate exactly in
int32 and are dequantized by ``act_scale * w_scale[o]`` in fp32, the bias
added after, then cast. Activations are NHWC and kernels ``(kh, kw, I, O)``
at these functions, as in the JAX package.

The s32 convolution is an im2col of shifted int8 windows and one
``torch._int_mm`` (s8 x s8 -> s32, cuBLASLt on a CUDA tensor): integer
sums are exact, so a CPU and a CUDA tensor give the same integers. The JAX
package leaves these convs to XLA, outside any kernel of its own; so they
go to a library here.

The module side: an :class:`ActAmax` owns one running ``|max|`` per conv
input of its module, under the JAX package's variable names
(``conv1_in``...), as non-persistent buffers, so a ``state_dict`` is the
same with and without int8; :func:`calibrating` turns recording on for
the forwards inside it, which is what ``mutable=["quant_stats"]`` does in
the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def quantize_weight_per_channel(w: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., O) float kernel -> (int8 kernel, fp32 scale[O]): symmetric per
    output channel, ``scale_o = max|W[..., o]| / 127``; an all-zero channel
    gets scale 1 (its quantized weights are zero anyway)."""
    w = w.float()
    amax = w.abs().reshape(-1, w.shape[-1]).amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def scale_from_amax(amax: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor scale; 1.0 for an all-zero tensor."""
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def quantize_act(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float activations -> int8 on the given symmetric per-tensor scale;
    values beyond ``127 * scale`` saturate."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def quantize_act_dynamic(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float activations -> (int8, fp32 scalar scale), the scale from the
    live ``|max|``."""
    scale = scale_from_amax(x.float().abs().max())
    return quantize_act(x, scale), scale


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) int8 @ (k, n) int8 -> (m, n) int32, exact. On CUDA
    ``torch._int_mm`` takes m > 16 and k, n multiples of 8 only: the
    operands are zero-padded up to that, which changes no sum. ``b`` goes
    in column-major (a transposed view of a contiguous (n, k) tensor): that
    is the one layout cuBLASLt's int8 product takes at every size (with a
    row-major ``b`` it refuses m = 200, k = 32, n = 32, for one)."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type == "cuda":
        pm = 32 - m if m <= 16 else 0
        pk, pn = -k % 8, -n % 8
        if pm or pk:
            a = F.pad(a, (0, pk, 0, pm))
        if pk or pn:
            b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def _pads(size: int, k: int, stride: int, pad) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis: explicit, or XLA's SAME."""
    if pad != "SAME":
        return int(pad[0]), int(pad[1])
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_s32(x_q: torch.Tensor, w_q: torch.Tensor,
             stride: Tuple[int, int] = (1, 1), padding="SAME"
             ) -> torch.Tensor:
    """s8 x s8 -> s32 NHWC conv, exact: x_q (B, H, W, I) int8, w_q
    (kh, kw, I, O) int8 -> (B, Ho, Wo, O) int32. ``padding`` is "SAME" or
    ``((top, bottom), (left, right))``, which may be asymmetric."""
    b, h, w, i = x_q.shape
    kh, kw, _, o = w_q.shape
    sh, sw = stride
    ph = _pads(h, kh, sh, padding if padding == "SAME" else padding[0])
    pw = _pads(w, kw, sw, padding if padding == "SAME" else padding[1])
    if any(ph) or any(pw):
        x_q = F.pad(x_q, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    ho = (h + ph[0] + ph[1] - kh) // sh + 1
    wo = (w + pw[0] + pw[1] - kw) // sw + 1
    # shifted windows side by side on the channel axis, tap-major like the
    # kernel's (kh, kw, I) rows
    cols = [x_q[:, dy:dy + (ho - 1) * sh + 1:sh, dx:dx + (wo - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    cols = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
    acc = int_matmul(cols.reshape(b * ho * wo, kh * kw * i),
                      w_q.reshape(kh * kw * i, o))
    return acc.reshape(b, ho, wo, o)


def conv_int8(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
              w_scale: torch.Tensor, stride: Tuple[int, int] = (1, 1),
              padding="SAME", bias: Optional[torch.Tensor] = None,
              out_dtype=torch.float32) -> torch.Tensor:
    """s8 x s8 -> s32 NHWC conv, dequantized to ``out_dtype``: the exact
    int32 sum times ``x_scale * w_scale`` in fp32, the bias added after,
    then the cast."""
    y = conv_s32(x_q, w_q, stride, padding).float() * (x_scale * w_scale)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype)


def quant_conv(x: torch.Tensor, w: torch.Tensor,
               stride: Tuple[int, int] = (1, 1), padding="SAME",
               bias: Optional[torch.Tensor] = None, out_dtype=None,
               act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize, then convolve: the int8 replacement of an inference
    ``conv(x, w) + bias``. ``act_scale``: a calibrated activation scale;
    None takes the live ``|max|``."""
    if out_dtype is None:
        out_dtype = x.dtype
    if act_scale is None:
        x_q, x_s = quantize_act_dynamic(x)
    else:
        x_q, x_s = quantize_act(x, act_scale), act_scale
    w_q, w_s = quantize_weight_per_channel(w)
    return conv_int8(x_q, w_q, x_s, w_s, stride, padding, bias, out_dtype)


class ActAmax(nn.Module):
    """The activation ``|max|`` of each conv input of one module: a scalar
    fp32 buffer per name, not persistent (no ``state_dict`` entry), and the
    set of names that a calibration pass or the weight bridge has filled.
    Under a data mesh (``parallel.mesh.replicate`` sets ``mesh``) a live
    ``|max|`` is the global batch's, as a whole-batch reduction over a
    sharded batch is in the JAX package."""

    mesh = None

    def __init__(self, names):
        super().__init__()
        self.names = tuple(names)
        for name in self.names:
            self.register_buffer(name, torch.zeros(()), persistent=False)
        self.calibrating = False
        self.filled = set()

    def set_(self, name: str, amax) -> None:
        """Store a calibrated ``amax`` (from the bridge) under ``name``."""
        getattr(self, name).copy_(torch.as_tensor(amax, dtype=torch.float32))
        self.filled.add(name)


def module_act_scale(stats: Optional[ActAmax], name: str, x: torch.Tensor,
                     static: bool) -> torch.Tensor:
    """Activation scale of the conv input ``name``.

    Dynamic (``static`` False, not calibrating): the live ``|max|``; no
    buffer is touched. Calibrating: the buffer takes the running max, and
    this call's outputs use the live scale. Static serving: the stored
    ``amax`` is read; one that was never filled raises."""
    calibrating = stats is not None and stats.calibrating
    live = None
    if not static or calibrating:
        live = x.float().abs().max()
        if stats is not None and stats.mesh is not None:
            live = stats.mesh.max(live)
    if static or calibrating:
        buf = getattr(stats, name)
        if calibrating:
            buf.copy_(torch.maximum(buf, live))
            stats.filled.add(name)
        elif name not in stats.filled:
            raise RuntimeError(
                f"static int8 scale {name!r} was never calibrated: run "
                "calibrate_static_scales first")
        else:
            live = buf
    return scale_from_amax(live)


def module_quant_conv(stats: Optional[ActAmax], name: str, x: torch.Tensor,
                      conv: nn.Conv2d, stride: Tuple[int, int] = (1, 1),
                      padding="SAME", static: bool = False, out_dtype=None,
                      bn: Optional[nn.BatchNorm2d] = None) -> torch.Tensor:
    """Int8 execution of ``conv``'s parameters on the NHWC ``x``, its scale
    kept under ``"{name}_in"``; a FOLLOWING inference BatchNorm ``bn`` is
    folded into the kernel first, also for a conv with a bias of its own:
    ``BN(conv(x, W) + b0) == conv(x, W*g) + (beta + (b0 - mean) * g)``,
    ``g = scale * rsqrt(var + eps)``."""
    w = conv.weight.float().permute(2, 3, 1, 0)          # (kh, kw, I, O)
    b = None if conv.bias is None else conv.bias.float()
    if bn is not None:
        g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        w = w * g
        b0 = torch.zeros_like(g) if b is None else b
        b = bn.bias.float() + (b0 - bn.running_mean.float()) * g
    sc = module_act_scale(stats, f"{name}_in", x, static)
    return quant_conv(x, w, stride, padding, bias=b,
                      out_dtype=out_dtype if out_dtype is not None
                      else x.dtype, act_scale=sc)


@contextlib.contextmanager
def calibrating(model: nn.Module):
    """Inside, every :class:`ActAmax` of ``model`` records the running max
    of its conv inputs (and the fused int8 kernel stands back, since only
    the unfused route sees the intermediate activations)."""
    stats = [m for m in model.modules() if isinstance(m, ActAmax)]
    for s in stats:
        s.calibrating = True
    try:
        yield
    finally:
        for s in stats:
            s.calibrating = False


def calibrate_static_scales(model: nn.Module, img: torch.Tensor, mano_l,
                            mano_r) -> nn.Module:
    """One calibration pass of an eval-mode model over ``img``: every conv
    input's ``|max|`` is folded into its buffer. The maxes accumulate, so
    further batches only widen the ranges. Returns the model."""
    with torch.no_grad(), calibrating(model):
        model(img, mano_l, mano_r)
    return model
