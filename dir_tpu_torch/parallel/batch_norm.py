"""Training-mode BatchNorm over the global batch of a data mesh.

``dir_tpu``'s BatchNorms take their moments over the whole sharded batch
(``TorchBatchNorm``, ``_PairBN`` in ``dir_tpu/models/layers.py``): shifted
single-pass moments around the running mean (``_batch_moments``), the
running variance updated with the unbiased factor ``n / (n - 1)`` of the
global count ``n``. Here each rank sums its block's shifted first and
second moments, the sums go through one all-reduce that autograd sees (its
backward sums the gradients over the ranks), and every rank normalizes its
block with the global mean and variance. The statistics are taken in at
least fp32 and the output is cast back to the input's dtype, as PyTorch's
own BatchNorm does with a bf16 input.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from dir_tpu_torch.parallel.mesh import Mesh


def global_batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
                      mesh: Mesh) -> torch.Tensor:
    """``bn`` in training mode on this rank's block ``x`` (N, C, ...), with
    the statistics of every rank's block; updates ``bn``'s running
    statistics and step counter as PyTorch's BatchNorm does."""
    c = x.shape[1]
    dims = [0] + list(range(2, x.dim()))
    shape = [1, c] + [1] * (x.dim() - 2)
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    shift = bn.running_mean.detach().to(acc)
    y = xf - shift.view(shape)
    sums = mesh.sum_differentiable(torch.cat([y.sum(dims),
                                              (y * y).sum(dims)]))
    n = x.numel() // c * mesh.world
    my = sums[:c] / n
    var = torch.clamp(sums[c:] / n - my * my, min=0.0)
    mean = my + shift
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1 - m).add_(
            mean.to(bn.running_mean.dtype), alpha=m)
        bn.running_var.mul_(1 - m).add_(
            (var * (n / max(n - 1, 1))).to(bn.running_var.dtype), alpha=m)
        bn.num_batches_tracked.add_(1)
    scale = torch.rsqrt(var + bn.eps) * bn.weight.to(acc)
    out = (xf - mean.view(shape)) * scale.view(shape) + bn.bias.to(
        acc).view(shape)
    return out.to(x.dtype)
