"""Build of the port's CUDA sources (``dir_tpu_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled with ``nvcc`` for
``sm_90a`` into ``<repo>/build/lib<name>.so`` at first use, then bound
with ``ctypes``. A failed build raises; nothing falls back.
:func:`build_many` starts one ``nvcc`` per source together, so several
kernels build in the time of the slowest.
"""

from __future__ import annotations

import glob
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str, variant: str = "") -> str:
    """The library built from ``csrc/<name>.cu``; a ``variant`` (a build
    with other flags, such as an instrumented one) has a file of its own."""
    return os.path.join(BUILD_DIR, f"lib{name}{variant}.so")


def _log_path(name: str, variant: str = "") -> str:
    return os.path.join(BUILD_DIR, f"{name}{variant}.log")


def _tmp_path(name: str, variant: str = "") -> str:
    return f"{library_path(name, variant)}.{os.getpid()}.tmp"


def start_build(name: str, extra_flags=(), variant: str = ""):
    """Start ``nvcc`` on ``csrc/<name>.cu`` if its library is missing or
    older than the source or any shared header (``csrc/*.cuh``); returns
    the process, or None when up to date."""
    lib, src = library_path(name, variant), source_path(name)
    newest = max(os.path.getmtime(f) for f in
                 [src, *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))])
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(_log_path(name, variant), "w") as log:
        return subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *extra_flags, "-o", _tmp_path(name, variant),
             src], stdout=log, stderr=subprocess.STDOUT)


def finish_build(name: str, proc, variant: str = "") -> str:
    """Wait for ``proc`` (from :func:`start_build`), move the library into
    place and return the ``-Xptxas -v`` report of the last build."""
    log_path = _log_path(name, variant)
    if proc is not None:
        rc = proc.wait()
        with open(log_path) as f:
            log = f.read()
        if rc != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu ({rc}):\n{log}")
        os.replace(_tmp_path(name, variant), library_path(name, variant))
    if not os.path.exists(log_path):
        return ""
    with open(log_path) as f:
        return f.read()


def build(name: str, extra_flags=(), variant: str = "") -> str:
    return finish_build(name, start_build(name, extra_flags, variant),
                        variant)


def build_many(specs) -> dict:
    """``specs``: (name, extra_flags) pairs. All compilers run at once;
    returns ``{name: report}``."""
    procs = [(name, start_build(name, flags)) for name, flags in specs]
    return {name: finish_build(name, proc) for name, proc in procs}
