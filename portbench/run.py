"""Run one cell of the benchmark once.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell's configuration, traffic and metrics are found by the names in
``BENCHMARK.json``: ``portbench/configs/<config>.json``,
``portbench/traffic/<traffic>.json`` (whose ``driver`` names the module of
``portbench/drivers/`` that runs it), ``portbench/metrics/<metric>.py``
(or the file of the metric's stem, the part before its first dot) and
``portbench/limits/<workload>.json``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``, each compared number
beside its limit. Without enough CUDA devices, or when the run loaded JAX
or the JAX package, it prints no result and exits with another code than
0.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

from portbench import build, harness

# Build and kernel caches of the program, at fixed paths inside the
# checkout, so that only a checkout's first run builds.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TRITON_CACHE_DIR": "build/triton_cache"}


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(run: harness.Run, **faults) -> dict:
    """Run the cell and return its result line (without printing it);
    ``faults`` go to the driver (the tests' broken paths)."""
    driver = importlib.import_module(
        f"portbench.drivers.{run.traffic['driver']}")
    result = driver.run_cell(run, **faults)
    correct, checks = harness.judge(run.workload, result["numbers"])
    if run.trace:
        metrics = harness.per_layer_metrics(run, result["found"])
    else:
        units = {m["name"]: m["unit"]
                 for m in build.benchmark()["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in result["e2e"].items() if k in units}
        metrics["setup_s"] = {"value": run.setup_s, "unit": units["setup_s"]}
    return harness.result_line(
        run, correct=correct, attempted=result["attempted"],
        failed=result["failed"], metrics=metrics, checks=checks,
        memory_peak=result["memory"], trace=result["trace"])


def main(argv=None) -> int:
    args = parse(argv)
    entry, cfg, traffic = build.cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < entry["chips"]):
        harness.say(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                    f"{torch.cuda.device_count()} available")
        return 2
    for key, rel in CACHES.items():
        os.environ[key] = os.path.join(build.ROOT, rel)
    harness.say(f"{torch.cuda.get_device_name(0)}, power limit "
                f"{harness.power_limit()}")
    run = harness.Run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", (entry, cfg, traffic))
    return harness.finish(run, measure(run))


if __name__ == "__main__":
    sys.exit(main())
