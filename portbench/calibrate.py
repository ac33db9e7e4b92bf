"""Readings that the limits of ``correct`` are set from: the program's
numbers over many seeds, the control's (the plain reference computed in
the next precision below the configuration's, float8 for its bfloat16
trunk, in the program's place), and for a training cell the faults'.
All in one process, at the cell's own sizes, on the card.

    python -m portbench.calibrate --workload <name> --seeds 12 \\
        --controls 3 [--faults half_batch] [--seconds 1]

Prints one JSON line per run (``kind``, ``seed``, ``numbers``), then a
summary: the largest program reading and the smallest control and fault
reading of each number.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import torch

from portbench import build, harness, run as prun
from portbench.reference import compare
from portbench.reference.net import set_rounding
from portbench.reference.precision import fp8

FIRST_SEED = 3_000_000_000


def control_infer(infer, ref, pair):
    """The fp8 reference in the program's place: ``img -> outputs``."""
    model = set_rounding(copy.deepcopy(ref), fp8)
    dev = next(model.parameters()).device

    def call(img):
        out = compare.reference_outputs(
            model, pair, torch.as_tensor(img), block=256)
        return {"stages": [{k: v.to(dev) for k, v in s.items()}
                           for s in out["stages"]],
                "seg": out["seg"].to(dev), "dense": out["dense"].to(dev)}

    return call


def control_trainer(run, start, hands, ref, pair):
    from portbench.drivers.train import ReferenceTrainer

    model = set_rounding(copy.deepcopy(ref), fp8)
    model.load_state_dict(start)
    return ReferenceTrainer(run, model, pair)


def faults(driver: str, kind: str) -> dict:
    if kind == "control":
        return ({"trainer_fault": control_trainer} if driver == "train"
                else {"infer_fault": control_infer})
    if kind == "half_batch":
        return {"trainer_fault": {"half_batch": True}}
    return {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--first_seed", type=int, default=FIRST_SEED)
    args = p.parse_args(argv)
    entry, cfg, traffic = build.cell(args.workload)
    for key, rel in prun.CACHES.items():
        os.environ[key] = os.path.join(build.ROOT, rel)
    plan = [("program", i) for i in range(args.seeds)]
    plan += [("control", i) for i in range(args.controls)]
    plan += [(f, i) for f in filter(None, args.faults.split(","))
             for i in range(args.controls)]
    rows = []
    for kind, i in plan:
        seed = args.first_seed + 7919 * i
        run = harness.Run(args.workload, seed, args.seconds, False, "cuda",
                          (entry, cfg, traffic))
        driver = __import__(f"portbench.drivers.{traffic['driver']}",
                            fromlist=["run_cell"])
        result = driver.run_cell(run, **faults(traffic["driver"], kind))
        row = {"kind": kind, "seed": seed, "numbers": result["numbers"],
               "e2e": result["e2e"], "setup_s": run.setup_s}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del result, run
        torch.cuda.empty_cache()
    summary = {}
    for name in rows[0]["numbers"]:
        summary[name] = {"program_max": max(
            r["numbers"][name] for r in rows if r["kind"] == "program")}
        for kind in {r["kind"] for r in rows} - {"program"}:
            summary[name][f"{kind}_min"] = min(
                r["numbers"][name] for r in rows if r["kind"] == kind)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
