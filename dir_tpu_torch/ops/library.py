"""The kernels as PyTorch ops in the ``dir_tpu`` namespace.

Importing this module registers every op (each is defined beside its
kernel): ``torch.ops.dir_tpu.fused_bottleneck`` (K1, K2),
``fused_bottleneck_int8`` (K3), ``fused_stem_bottleneck`` (K4) and
``bone_splat`` (K5). Each has a CUDA implementation that launches the
hand-written kernel, a CPU implementation that runs the plain version and a
fake implementation that gives the output's shape, so a graph traced or
exported on either device names the op and a loaded graph finds it. A
serving artifact needs this module and no model code.
"""

from __future__ import annotations

from dir_tpu_torch.ops import (bone_splat, fused_bottleneck,  # noqa: F401
                               fused_bottleneck_int8, fused_stem_bottleneck)

# the op names, as a traced graph's nodes carry them
OPS = ("fused_bottleneck", "fused_bottleneck_int8", "fused_stem_bottleneck",
       "bone_splat")
