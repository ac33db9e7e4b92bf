"""Cells cut to a size the CPU runs in seconds, for the benchmark's own
tests: the one-block-a-stage backbone at 64x64, batches of a few images.
The timed path is the program's plain PyTorch route on the CPU, in
float32: the limits were set from bf16 at the cells' own sizes, and at
this size a sound run is held to them only at float32, so that the tests
see the faults and the control, not the trunk's rounding."""

from __future__ import annotations

import torch

from portbench import build, harness, run

SEED = 2 ** 31 + 4242


def tiny_cell(workload: str):
    entry, cfg, traffic = build.cell(workload)
    cfg = dict(cfg, backbone_layers=[1, 1, 1, 1], image_size=64,
               program=dict(cfg["program"], dtype="float32"))
    traffic = dict(traffic, pool=min(traffic["pool"], 4), trace_units=2)
    if traffic["driver"] == "closed_loop":
        traffic.update(batch=min(traffic["batch"], 2), compare=1,
                       compare_from=2)
    elif traffic["driver"] == "train":
        traffic.update(batch=4)
    return entry, cfg, traffic


def tiny_run(workload: str, trace: bool = False, seconds: float = 1.5,
             seed: int = SEED, cell=None, **faults) -> dict:
    torch.set_num_threads(4)
    r = harness.Run(workload, seed, seconds, trace, "cpu",
                    cell or tiny_cell(workload))
    return run.measure(r, **faults)
