"""Per-phase clock() breakdown of the fused-bottleneck kernels on the card:
bf16 (K1, K2), int8 (K3) and the stem's (K4).

Builds ``csrc/fused_bottleneck.cu``, ``csrc/fused_bottleneck_int8.cu`` and
``csrc/fused_stem_bottleneck.cu`` a second time with ``-DBOTTLENECK_PROFILE``
into libraries of their own (the main path's build never sets it), launches
K1, K2, K3 (identity residual) and K4 once each at the eval-batch-256 shapes
of ``chip_smoke.py`` on operands prepared beforehand, and prints one JSON
line per run: the SM cycles per tile of each phase, as seen by the first
consumer thread (warpgroup 0, warp 0) and by the producer thread, summed
over all blocks and divided by the tiles they walked. The clock reads and
their sums cost a few percent of the kernel's time (at K3's mid 128 ptxas
serializes the instrumented build's wgmma, so its products read high); the
kernel time beside them is of the instrumented build. Run on the card:

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
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops import fused_stem_bottleneck as st

VARIANT = "_profile"
# the phases of both kernels' consumers (K3's conv1 products include the
# quantization of its A)
CONSUMER = ("weights wait", "conv1 waits", "conv1 products", "y1 epilogue",
            "conv2 waits", "conv2 products", "y2 to registers", "conv3 waits",
            "conv3 products", "output epilogue")
# K4's consumers: "strip waits" and "pool" count the next tile's strips
# pooled during conv3 too, "conv3 + projection products" only the wait after
# them, and "y2 to registers" the barrier after conv2
STEM_CONSUMER = ("weights wait", "strip waits", "pool", "conv1 products",
                 "y1 epilogue", "conv2 products", "y2 to registers",
                 "conv3 + projection products", "output epilogue")
PRODUCER = ("waits for a free stage", "issuing copies")
# (name, shape, mid, bands, projection): chip_smoke.py's shapes
RUNS = (("K1", (256, 64, 64, 256), 64, 0, False),
        ("K1 projection", (256, 64, 64, 256), 64, 0, True),
        ("K2", (256, 32, 32, 512), 128, 4, False))
RUNS_INT8 = (("K3 layer1", (256, 64, 64, 256), 64),
             ("K3 layer2", (256, 32, 32, 512), 128))
# K4: the raw stem output, mid, O
RUN_STEM = ("K4", (256, 128, 128, 64), 64, 256)


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


def _scales(x, ws) -> list:
    """Static scales as a calibration would leave them (chip_smoke.py's):
    the |max| of each conv's input over the first samples / 127."""
    xs = x[:8].float()
    y1 = torch.relu(xs @ ws[0] + ws[1])
    y2 = torch.relu(torch.nn.functional.conv2d(
        y1.permute(0, 3, 1, 2), ws[2].permute(3, 2, 0, 1), ws[3], padding=1))
    return [t.abs().max() / 127 for t in (x.float(), y1, y2)]


def _profile(lib, launch, report: dict, consumer_names) -> None:
    """One warm-up launch, then one timed launch with the sums reset; prints
    ``report`` with the cycles per tile of each phase."""
    launch()
    torch.cuda.synchronize()
    lib.fused_bottleneck_prof_reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    sums = (ctypes.c_ulonglong * 32)()
    lib.fused_bottleneck_prof_read(ctypes.addressof(sums))
    tiles = sums[15]
    consumer = {k: sums[i] / tiles for i, k in enumerate(consumer_names)}
    producer = {k: sums[16 + i] / tiles for i, k in enumerate(PRODUCER)}
    print(json.dumps({
        **report, "tiles": tiles, "ms_instrumented": start.elapsed_time(end),
        "consumer_cycles_per_tile": consumer,
        "consumer_total": sum(consumer.values()),
        "producer_cycles_per_tile": producer}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: no CUDA device")
    flags = "-DBOTTLENECK_PROFILE",
    procs = [(m, cuda_build.start_build(m.NAME, (*m.NVCC_EXTRA_FLAGS, *flags),
                                        VARIANT)) for m in (fb, q8, st)]
    libs = {}
    for m, proc in procs:
        cuda_build.finish_build(m.NAME, proc, VARIANT)
        libs[m] = m.bind(cuda_build.library_path(m.NAME, VARIANT))
        libs[m].fused_bottleneck_prof_read.argtypes = [ctypes.c_void_p]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for name, shape, mid, bands, down in RUNS:
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        op = fb.kernel_operands(*_weights(g, shape[-1], mid, shape[-1], down),
                                bands=bands)
        _profile(libs[fb], lambda: fb.launch_on(libs[fb], x, op, bands),
                 {"kernel": name, "shape": list(shape) + [mid],
                  "projection": down, "device": smi}, CONSUMER)
    for name, shape, mid in RUNS_INT8:
        report = {"kernel": name, "shape": list(shape) + [mid],
                  "projection": False, "device": smi}
        x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
        ws = _weights(g, shape[-1], mid, shape[-1], False)
        op = q8.kernel_operands(*ws[:6], *_scales(x, ws))
        _profile(libs[q8], lambda: q8.launch_on(libs[q8], x, op), report,
                 CONSUMER)
    name, shape, mid, o = RUN_STEM
    c = shape[-1]
    x = torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    g1 = torch.rand(c, generator=g, device=dev) + 0.5
    t1 = torch.rand(c, generator=g, device=dev) - 0.5
    op = st.kernel_operands(g1, t1, *_weights(g, c, mid, o, True))
    _profile(libs[st], lambda: st.launch_on(libs[st], x, op),
             {"kernel": name, "shape": list(shape) + [mid, o],
              "projection": True, "device": smi}, STEM_CONSUMER)
    return 0


if __name__ == "__main__":
    sys.exit(main())
