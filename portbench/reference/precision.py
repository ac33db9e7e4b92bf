"""A lower precision put in the reference's place, for the control that a
correct run must be told apart from: a ``round_`` function for
:func:`portbench.reference.net.set_rounding`."""

from __future__ import annotations

import torch

FP8_MAX = 448.0     # the largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its |max| at
    the format's largest value), as an fp8 matrix product with per-tensor
    scaling takes its operands; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).clamp(-FP8_MAX, FP8_MAX).to(
        torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()

