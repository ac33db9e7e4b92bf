"""Serving the port under concurrent load: single flight against
micro-batched (counterpart of ``tools/bench_serve_concurrent.py``).

``dir_tpu_torch.tools.bench_serve_latency`` times the bare step per batch
size; this tool measures the HTTP daemon (``dir_tpu_torch/apps/
serve_http.py``) end to end the way a serving deployment sees it: C
concurrent clients each posting batch-1 images in a closed loop. Two modes
over the same loaded artifact (``serve.export_infer`` of the flagship with
a symbolic batch, written to a temporary directory and loaded back with
``serve.load``):

  single-flight  - every request is its own device dispatch behind the
                   device lock
  micro-batched  - ``MicroBatcher`` coalesces concurrent requests into one
                   dispatch of up to MB images, padded up to the warmed
                   bucket sizes (``serve_http --microbatch``)

Prints per-request p50/p99 latency, aggregate img/s, and the realized
average dispatch batch (``/stats``' ``avg_batch``). Knobs, as in the JAX
tool: CLIENTS, REQS (per client), MB (largest micro-batch), WINDOW_MS,
BUCKETS; QUANT / QUANT_STATIC (the int8 serving artifact, the fused
bottleneck off under quant); TINY=1 (the ``(1,1,1,1)`` backbone, fp32,
no fused kernel). The model is ``serve.build_flagship``'s with seeded
weights conditioned by ``serve.condition_random_``. Runs on the card;
``BENCH_DEVICE=cpu`` on the CPU:

    python -m dir_tpu_torch.tools.bench_serve_concurrent
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np

CLIENTS = int(os.environ.get("CLIENTS", "32"))
REQS = int(os.environ.get("REQS", "20"))
MB = int(os.environ.get("MB", "32"))
WINDOW_MS = float(os.environ.get("WINDOW_MS", "3.0"))
BUCKETS = tuple(int(b) for b in
                os.environ.get("BUCKETS", "1,8,32").split(","))
TINY = os.environ.get("TINY", "0") == "1"


def _run_mode(mod, infer, batcher, tag) -> dict:
    lock = threading.Lock()
    stats = {"requests": 0, "images": 0, "dispatches": 0, "lat_sum": 0.0}
    if batcher is not None:
        # rebind the live batcher's stats so each mode reports its own
        batcher.stats = stats
    srv = ThreadingHTTPServer(
        ("127.0.0.1", 0), mod.make_handler(infer, lock, stats, False,
                                           batcher))
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}/infer"

    rng = np.random.RandomState(0)
    img = rng.randn(1, 256, 256, 3).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, img)
    payload = buf.getvalue()

    lats = [[] for _ in range(CLIENTS)]
    errors = []
    barrier = threading.Barrier(CLIENTS)

    def client(i):
        barrier.wait()
        try:
            for _ in range(REQS):
                t0 = time.perf_counter()
                r = urllib.request.urlopen(url, payload, timeout=600)
                r.read()
                lats[i].append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    srv.shutdown()
    srv.server_close()
    if errors:
        raise RuntimeError(f"{tag}: {len(errors)} clients failed: "
                           f"{errors[0]!r}")

    flat = np.sort(np.concatenate(lats)) * 1e3
    n = CLIENTS * REQS
    rec = {
        "mode": tag, "clients": CLIENTS, "reqs": n,
        "p50_ms": round(float(np.percentile(flat, 50)), 2),
        "p99_ms": round(float(np.percentile(flat, 99)), 2),
        "img_per_sec": round(n / wall, 1),
        "dispatches": stats["dispatches"],
        "avg_batch": round(stats["images"] / max(stats["dispatches"], 1), 2),
    }
    print(f"{tag:14s}: p50 {rec['p50_ms']:8.2f} ms  "
          f"p99 {rec['p99_ms']:8.2f} ms  {rec['img_per_sec']:8.1f} img/s  "
          f"avg_batch {rec['avg_batch']:.1f} "
          f"({rec['dispatches']} dispatches)", flush=True)
    return rec


def serve_both(infer) -> list:
    """Warm ``infer`` (an ``img -> outputs`` callable with a ``device``) at
    every bucket, then serve both modes; prints each mode's line and the
    ``RESULTS`` line and returns the records."""
    from dir_tpu_torch.apps import serve_http

    for b in BUCKETS:  # pay every padded size's first call before timing
        t0 = time.perf_counter()
        serve_http.warmup(infer, (b,))
        print(f"warmup b={b}: {time.perf_counter() - t0:.1f}s", flush=True)

    results = [_run_mode(serve_http, infer, None, "single-flight")]
    lock = threading.Lock()
    stats = {"requests": 0, "images": 0, "dispatches": 0, "lat_sum": 0.0}
    batcher = serve_http.MicroBatcher(infer, lock, stats, False, MB,
                                      WINDOW_MS, BUCKETS)
    try:
        results.append(_run_mode(serve_http, infer, batcher,
                                 "micro-batched"))
    finally:
        batcher.stop()
    print("RESULTS " + json.dumps(results), flush=True)
    return results


def main(**overrides) -> list:
    """Export, load and serve; ``overrides`` are further ``ModelConfig``
    fields."""
    from dir_tpu_torch import serve
    from dir_tpu_torch.bench import bench_device, conditioned_flagship

    dev = bench_device()
    q = int(os.environ.get("QUANT", "0"))
    qs = os.environ.get("QUANT_STATIC", "0") == "1"
    flags = dict(dtype="float32" if TINY else "bfloat16",
                 fused_bottleneck_eval=(not TINY) and q == 0,
                 quant_backbone_eval=q >= 1, quant_decoder_eval=q >= 2,
                 quant_aux_eval=q >= 3, quant_static=qs)
    if TINY:
        flags["backbone_layers"] = (1, 1, 1, 1)
    model, _, mano_l, mano_r = conditioned_flagship(
        dev, **dict(flags, **overrides))
    if qs:
        calib = np.random.RandomState(1).randn(8, 256, 256, 3)
        serve.calibrate_static_scales(model, calib.astype(np.float32),
                                      mano_l, mano_r)
    with tempfile.TemporaryDirectory(prefix="bench_serve_concurrent_") as d:
        path = os.path.join(d, "dir.pt2")
        serve.save(path, serve.export_infer(model, mano_l, mano_r,
                                            batch_size=None))
        del model
        infer = serve.load(path)
    return serve_both(infer)


if __name__ == "__main__":
    main()
