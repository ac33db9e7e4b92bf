"""Data parallelism on ``torch.distributed`` (counterpart of
``dir_tpu/parallel/``): the mesh, the batch's blocks, replicated
parameters, the collectives, and BatchNorm over the global batch."""

from dir_tpu_torch.parallel.mesh import (Mesh, average_gradients,
                                         init_distributed, make_mesh,
                                         replicate, shard_batch)

__all__ = ["Mesh", "average_gradients", "init_distributed", "make_mesh",
           "replicate", "shard_batch"]
