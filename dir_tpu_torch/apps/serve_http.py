"""HTTP serving daemon for the port's exported artifacts (counterpart of
``apps/serve_http.py``).

Loads the artifact that ``dir_tpu_torch.apps.export`` writes and serves it
over plain HTTP with no model code on the host (``serve.load``: the
kernels' op registrations and the exported program).

Protocol (stdlib-only on both ends):
    GET  /healthz          -> 200 "ok"
    GET  /stats            -> JSON {requests, images, dispatches,
                              avg_latency_ms, avg_queue_wait_ms,
                              avg_batch}; avg_queue_wait_ms is a
                              request's wait from its arrival at the
                              micro-batcher to its dispatch's start
                              (null without --microbatch)
    POST /infer            -> body: .npy of (B, 256, 256, 3) float32
                              (normalized image crops, NHWC);
                              response: .npz with the final refinement
                              stage's outputs: mesh_xyz_left/right
                              (B, 778, 3), joint_xyz_left/right
                              (B, 21, 3), offset (B, 3), plus seg/dense
                              (B, 32, 32, 3) when --full.

Client example:
    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.save(buf, imgs)
    r = urllib.request.urlopen("http://host:8000/infer", buf.getvalue())
    out = np.load(io.BytesIO(r.read()))
    verts_l = out["mesh_xyz_left"]

Device work is serialized behind one lock; HTTP I/O threads overlap with
it. Export with --batch 0 (symbolic) so that one artifact serves every
request size, and pass --warmup with the expected sizes to pay their first
calls (the kernels' build, cuDNN's choice of algorithm) before traffic.

Usage:
    python -m dir_tpu_torch.apps.serve_http --artifact dir.pt2 \
        --port 8000 [--warmup 1,32] [--full] [--microbatch 32 --window_ms 3]

--microbatch N coalesces concurrent requests into one device dispatch of
up to N images (MicroBatcher below): under concurrent small-batch load the
device runs one batched forward instead of a queue of batch-1 forwards.
The warmed sizes double as padding buckets, so ragged micro-batches run
at sizes already warmed.
"""

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# Default limit of an /infer body, rejected before it is buffered (batch
# 1024 of float32 256x256x3 is ~800 MB; anything larger is a mistake
# or abuse, not a workload this host can hold twice in memory).
# ``make_server(max_body=...)`` and ``--max_body`` set another.
MAX_BODY_BYTES = 1 << 30


def _numpy(v) -> np.ndarray:
    """A response array: floating tensors as fp32 (numpy has no bf16)."""
    if hasattr(v, "detach"):
        v = v.detach()
        return (v.float() if v.is_floating_point() else v).cpu().numpy()
    return np.asarray(v)


def _final_outputs(out: dict, full: bool) -> dict:
    f = out["stages"][-1]
    resp = {
        "mesh_xyz_left": f["pd_mesh_xyz_left"],
        "mesh_xyz_right": f["pd_mesh_xyz_right"],
        "joint_xyz_left": f["pd_joint_xyz_left"],
        "joint_xyz_right": f["pd_joint_xyz_right"],
        "offset": f["pd_offset"],
    }
    if full:
        resp["seg"] = out["seg"]
        resp["dense"] = out["dense"]
    return resp


class MicroBatcher:
    """Coalesce concurrent /infer requests into one device dispatch.

    The single-flight path serializes requests behind the device lock:
    under concurrent b=1 load every request pays a whole forward's launches
    and the card runs at batch-1 utilization. This dispatcher queues
    requests, waits up to ``window_ms`` after the first arrival (or
    until ``max_batch`` images are pending), concatenates them along the
    batch axis, runs ONE inference, and slices the outputs back per
    request. Correct because the network is batch-parallel in eval mode
    (BN uses running stats; attention is over each sample's own 42
    joint tokens — no cross-batch mixing).

    :meth:`submit_timed` also returns the request's queue wait: seconds
    from its arrival to the start of its dispatch (the device lock
    taken), which the server adds up for ``/stats``.

    ``buckets``: sorted batch sizes to zero-pad a coalesced batch up to
    (pad rows sliced away before responding). cuDNN picks its algorithms
    per distinct size on the first call; padding to the warmed sizes keeps
    those first calls out of ragged traffic.
    """

    def __init__(self, infer, lock, stats, full: bool, max_batch: int,
                 window_ms: float, buckets=()):
        self.infer = infer
        self.lock = lock
        self.stats = stats
        self.full = full
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.buckets = tuple(sorted(b for b in buckets if b > 0))
        self.q = queue.SimpleQueue()
        # _stop_lock orders submit() against stop(): the stopped flag is
        # set under the same lock that guards q.put, so no request can
        # land behind the shutdown sentinel (whose slot event would
        # never be set — a permanently hung handler thread).
        self._stop_lock = threading.Lock()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        with self._stop_lock:
            self._stopped = True
            self.q.put(None)
        self._thread.join(timeout=10)

    def submit(self, img: np.ndarray) -> dict:
        return self.submit_timed(img)[0]

    def submit_timed(self, img: np.ndarray) -> tuple[dict, float]:
        """:meth:`submit`, and the request's seconds from here to the
        start of its dispatch (its last, where a failed group was retried
        one request at a time)."""
        t0 = time.perf_counter()
        slot = {"event": threading.Event(), "out": None, "err": None}
        with self._stop_lock:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            self.q.put((img, slot))
        slot["event"].wait()
        if slot["err"] is not None:
            raise slot["err"]
        return slot["out"], slot["t_dispatch"] - t0

    def _collect(self):
        """Block for the first request, then gather more until the
        window closes or max_batch images are pending. Returns the
        group, or None on the shutdown sentinel."""
        first = self.q.get()
        if first is None:
            return None
        group = [first]
        total = first[0].shape[0]
        deadline = time.monotonic() + self.window_s
        while total < self.max_batch:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self.q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                self.q.put(None)  # re-post for the next _collect
                break
            group.append(nxt)
            total += nxt[0].shape[0]
        return group

    @staticmethod
    def _dispatched(slots) -> None:
        """Stamp a dispatch's start on its requests."""
        now = time.perf_counter()
        for slot in slots:
            slot["t_dispatch"] = now

    def _dispatch_single(self, img: np.ndarray, slot) -> dict:
        # Pad to a warmed bucket just like the group path: a raw-size
        # dispatch would pay a first call at a fresh size while the
        # batcher thread, and every queued request, waits.
        n_real = int(img.shape[0])
        pad_to = next((b for b in self.buckets if b >= n_real), n_real)
        if pad_to > n_real:
            img = np.concatenate(
                [img, np.zeros((pad_to - n_real,) + img.shape[1:],
                               img.dtype)])
        with self.lock:
            self._dispatched([slot])
            out = self.infer(img)
            resp = {k: _numpy(v)[:n_real] for k, v in
                    _final_outputs(out, self.full).items()}
            self.stats["dispatches"] += 1
            self.stats["images"] += n_real
        return resp

    def _loop(self):
        while True:
            group = self._collect()
            if group is None:
                return
            # The whole coalesce+dispatch runs under try: the handler
            # validates only (B, H, W, 3), so mixed-resolution groups
            # fail at np.concatenate — an uncaught exception here kills
            # the batcher thread and hangs every future request.
            try:
                batch = (np.concatenate([g[0] for g in group])
                         if len(group) > 1 else group[0][0])
                n_real = batch.shape[0]
                pad_to = next((b for b in self.buckets if b >= n_real),
                              n_real)
                if pad_to > n_real:
                    batch = np.concatenate(
                        [batch,
                         np.zeros((pad_to - n_real,) + batch.shape[1:],
                                  batch.dtype)])
                with self.lock:
                    self._dispatched([g[1] for g in group])
                    out = self.infer(batch)
                    resp = {k: _numpy(v) for k, v in
                            _final_outputs(out, self.full).items()}
                    self.stats["dispatches"] += 1
                    self.stats["images"] += n_real
            except Exception:  # noqa: BLE001 — isolate the bad request
                # Group dispatch failed (shape mismatch, device error):
                # retry each request alone so one malformed request
                # doesn't poison its neighbors — only IT gets the 400.
                for img, slot in group:
                    try:
                        slot["out"] = self._dispatch_single(img, slot)
                    except Exception as e:  # noqa: BLE001 — per-request
                        slot["err"] = e
                    slot["event"].set()
                continue
            ofs = 0
            for img, slot in group:
                n = img.shape[0]
                slot["out"] = {k: v[ofs:ofs + n] for k, v in resp.items()}
                ofs += n
                slot["event"].set()


def make_handler(infer, lock, stats, full: bool, batcher=None,
                 max_body: int = MAX_BODY_BYTES):
    class Handler(BaseHTTPRequestHandler):
        # quiet per-request stderr lines (stats endpoint replaces them)
        def log_message(self, fmt, *args):  # noqa: N802
            pass

        def _send(self, code, body, ctype="application/octet-stream"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/stats":
                with lock:
                    s = dict(stats)
                s["avg_latency_ms"] = (
                    round(1e3 * s.pop("lat_sum") / s["requests"], 2)
                    if s["requests"] else None)
                wait = s.pop("queue_wait_sum", 0.0)
                s["avg_queue_wait_ms"] = (
                    round(1e3 * wait / s["requests"], 2)
                    if s["requests"] and batcher is not None else None)
                s["avg_batch"] = (
                    round(s["images"] / s["dispatches"], 2)
                    if s["dispatches"] else None)
                self._send(200, json.dumps(s).encode(), "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):  # noqa: N802
            if self.path != "/infer":
                self._send(404, b"not found", "text/plain")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                if n > max_body:
                    self._send(413, json.dumps(
                        {"error": f"body {n} B exceeds the "
                                  f"{max_body} B limit"}).encode(),
                        "application/json")
                    return
                img = np.load(io.BytesIO(self.rfile.read(n)),
                              allow_pickle=False)
                if img.ndim != 4 or img.shape[-1] != 3:
                    raise ValueError(f"expected (B, H, W, 3), got "
                                     f"{img.shape}")
                t0 = time.perf_counter()
                if batcher is not None:
                    resp, wait = batcher.submit_timed(
                        img.astype(np.float32))
                    with lock:
                        stats["requests"] += 1
                        stats["lat_sum"] += time.perf_counter() - t0
                        stats["queue_wait_sum"] = stats.get(
                            "queue_wait_sum", 0.0) + wait
                else:
                    with lock:  # one device; serialize dispatch
                        out = infer(img.astype(np.float32))
                        resp = {k: _numpy(v) for k, v in
                                _final_outputs(out, full).items()}
                        stats["requests"] += 1
                        stats["dispatches"] += 1
                        stats["images"] += int(img.shape[0])
                        stats["lat_sum"] += time.perf_counter() - t0
                buf = io.BytesIO()
                np.savez(buf, **resp)
                self._send(200, buf.getvalue())
            except Exception as e:  # noqa: BLE001 — report to client
                self._send(400, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")

    return Handler


def make_server(artifact, host: str = "127.0.0.1", port: int = 8000,
                full: bool = False, max_batch: int = 0,
                window_ms: float = 3.0, buckets=(),
                max_body: int = MAX_BODY_BYTES):
    """Build (but don't start) the server; also the test entry point.

    ``artifact`` is the path of an exported artifact, or the callable that
    ``serve.load`` returned for one. ``max_batch > 0`` enables request
    micro-batching (see MicroBatcher); 0 keeps the single-flight path. An
    /infer body above ``max_body`` bytes is answered 413 unread."""
    from dir_tpu_torch import serve

    infer = serve.load(artifact) if isinstance(artifact, str) else artifact
    lock = threading.Lock()
    stats = {"requests": 0, "images": 0, "dispatches": 0, "lat_sum": 0.0,
             "queue_wait_sum": 0.0}
    batcher = (MicroBatcher(infer, lock, stats, full, max_batch,
                            window_ms, buckets)
               if max_batch > 0 else None)
    srv = ThreadingHTTPServer(
        (host, port),
        make_handler(infer, lock, stats, full, batcher, max_body))
    srv.infer = infer  # exposed for warmup
    srv.batcher = batcher
    return srv


def warmup(infer, sizes, log=None) -> None:
    """One call of ``infer`` at each batch size, waited for."""
    import torch

    for b in sizes:
        t0 = time.perf_counter()
        infer(np.zeros((b, 256, 256, 3), np.float32))
        if infer.device.type == "cuda":
            torch.cuda.synchronize(infer.device)
        if log is not None:
            log(f"warmed batch {b} in {time.perf_counter() - t0:.1f} s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", type=str, required=True)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--warmup", type=str, default="",
                    help="comma-separated batch sizes to run once before "
                         "accepting traffic")
    ap.add_argument("--full", action="store_true",
                    help="include seg/dense maps in responses")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="coalesce concurrent requests into one device "
                         "dispatch of up to this many images (0 = off)")
    ap.add_argument("--window_ms", type=float, default=3.0,
                    help="how long a micro-batch waits for more "
                         "requests after the first arrives")
    ap.add_argument("--max_body", type=int, default=MAX_BODY_BYTES,
                    help="largest /infer body in bytes; a larger one is "
                         "answered 413")
    opt = ap.parse_args(argv)

    from dir_tpu_torch.utils.logger import setup_logger
    logger = setup_logger(name="dir_tpu_torch.serve")

    warm = ([int(x) for x in opt.warmup.split(",")] if opt.warmup else [])
    # warmed sizes double as the padding buckets: micro-batches pad up
    # to a warmed size
    srv = make_server(opt.artifact, opt.host, opt.port, opt.full,
                      max_batch=opt.microbatch, window_ms=opt.window_ms,
                      buckets=warm, max_body=opt.max_body)
    warmup(srv.infer, warm, logger.info)
    logger.info("serving %s on %s:%d", opt.artifact, opt.host, opt.port)
    srv.serve_forever()


if __name__ == "__main__":
    main()
