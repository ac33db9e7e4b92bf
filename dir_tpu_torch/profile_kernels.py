"""Per-phase clock64() breakdown of the bf16 fused-bottleneck kernel (K1, K2)
on the card.

Builds ``csrc/fused_bottleneck.cu`` a second time with
``-DBOTTLENECK_PROFILE`` into a library of its own (the main path's build
never sets it), launches K1 and K2 once each at the eval-batch-256 shapes
of ``chip_smoke.py`` on operands prepared beforehand, and prints one JSON
line per kernel: the SM cycles per tile of each phase, as seen by the first
consumer thread (warpgroup 0, warp 0) and by the producer thread, summed
over all blocks and divided by the tiles they walked. The clock reads and
their sums cost a few percent of the kernel's time; the kernel time beside
them is of the instrumented build. Run on the card:

    python -m dir_tpu_torch.profile_kernels
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from dir_tpu_torch.ops import cuda_build
from dir_tpu_torch.ops import fused_bottleneck as fb

VARIANT = "_profile"
CONSUMER = ("weights wait", "conv1 waits", "conv1 products", "y1 epilogue",
            "conv2 waits", "conv2 products", "y2 to registers", "conv3 waits",
            "conv3 products", "output epilogue")
PRODUCER = ("waits for a free stage", "issuing copies")
# (name, shape, mid, bands, projection): chip_smoke.py's shapes
RUNS = (("K1", (256, 64, 64, 256), 64, 0, False),
        ("K1 projection", (256, 64, 64, 256), 64, 0, True),
        ("K2", (256, 32, 32, 512), 128, 4, False))


def _weights(g, c: int, mid: int, o: int, down: bool) -> list:
    dev = g.device

    def w(*shape):
        fan_in = 1
        for s in shape[:-1]:
            fan_in *= s
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) / fan_in ** 0.5

    def b(n):
        return torch.rand(n, generator=g, device=dev) - 0.5

    ws = [w(c, mid), b(mid), w(3, 3, mid, mid), b(mid), w(mid, o), b(o)]
    return ws + ([w(c, o), b(o)] if down else [None, None])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    cuda_build.build(fb.NAME, (*fb.NVCC_EXTRA_FLAGS, "-DBOTTLENECK_PROFILE"),
                     VARIANT)
    lib = fb.bind(cuda_build.library_path(fb.NAME, VARIANT))
    lib.fused_bottleneck_prof_read.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, shape, mid, bands, down in RUNS:
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        op = fb.kernel_operands(*_weights(g, shape[-1], mid, shape[-1], down),
                                bands=bands)
        fb.launch_on(lib, x, op, bands)              # warm-up
        torch.cuda.synchronize()
        lib.fused_bottleneck_prof_reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fb.launch_on(lib, x, op, bands)
        end.record()
        torch.cuda.synchronize()
        sums = (ctypes.c_ulonglong * 32)()
        lib.fused_bottleneck_prof_read(ctypes.addressof(sums))
        tiles = sums[15]
        consumer = {k: sums[i] / tiles for i, k in enumerate(CONSUMER)}
        producer = {k: sums[16 + i] / tiles for i, k in enumerate(PRODUCER)}
        print(json.dumps({
            "kernel": name, "shape": list(shape) + [mid],
            "projection": down, "device": smi, "tiles": tiles,
            "ms_instrumented": start.elapsed_time(end),
            "consumer_cycles_per_tile": consumer,
            "consumer_total": sum(consumer.values()),
            "producer_cycles_per_tile": producer}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
