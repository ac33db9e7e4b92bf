"""Device selection and device-resident constants shared by the port."""

from __future__ import annotations

import contextlib
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


def _tracing() -> bool:
    """Whether a fake-tensor trace (``torch.export``, AOT autograd) is
    running: a constant kept from real tensors must not enter it."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant int64 index tensor, made once per device. Indexing a CUDA
    tensor with a Python list copies the list from pageable host memory on
    every call, and such a copy first waits for the device to drain. Under
    a fake-tensor trace it is made in the trace instead."""
    if _tracing():
        return torch.tensor(values, dtype=torch.int64, device=device)
    return _index_tensor(values, device)


@functools.lru_cache(maxsize=None)
def _index_tensor(values: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.int64).to(device)


def float_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant fp32 tensor, made once per device (no host copy per
    call); under a fake-tensor trace it is made in the trace instead."""
    if _tracing():
        return torch.tensor(values, dtype=torch.float32, device=device)
    return _float_constant(values, device)


@functools.lru_cache(maxsize=None)
def _float_constant(values: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.float32).to(device)


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN convolutions, restored afterwards:
    MANO, geometry, the heads and the losses run in full fp32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on, restored afterwards: PyTorch's
    deterministic mode (an op with no deterministic CUDA form raises),
    cuDNN's deterministic algorithms and no benchmark-picked ones. The
    train step runs under it, so that a step repeats bit for bit on the
    card, as the JAX package's does. cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG``, which importing the package sets."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = saved[2:]
