"""PyTorch/CUDA port of dir_tpu for NVIDIA Hopper.

Imports ``torch`` only: nothing of JAX and nothing of the ``dir_tpu``
package. Layout mirrors ``dir_tpu`` (``models/``, ``ops/``, ``mano/``,
``data/``, ``train/``, ``utils/``, ``apps/``); hand-written CUDA kernels
live in ``csrc/`` and build at first use.

The train step runs under deterministic algorithms
(``device.deterministic``); cuBLAS is deterministic under them only with a
fixed workspace, so ``CUBLAS_WORKSPACE_CONFIG`` is set here, before any
CUDA call, unless the caller set it.
"""

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from dir_tpu_torch.config import ModelConfig  # noqa: F401
