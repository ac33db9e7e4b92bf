"""PyTorch/CUDA port of dir_tpu for NVIDIA Hopper.

Imports ``torch`` only: nothing of JAX and nothing of the ``dir_tpu``
package. Layout mirrors ``dir_tpu`` (``models/``, ``ops/``, ``mano/``);
hand-written CUDA kernels live in ``csrc/`` and build at first use.
"""

from dir_tpu_torch.config import ModelConfig  # noqa: F401
