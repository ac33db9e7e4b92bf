"""Device selection and device-resident constants shared by the port."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no card is present; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dir_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


@functools.lru_cache(maxsize=None)
def index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor, made once per device. Indexing a CUDA
    tensor with a Python list copies the list from pageable host memory on
    every call, and such a copy first waits for the device to drain."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.int64).to(device)
