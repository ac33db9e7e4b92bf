"""The kernels as ``torch.ops.dir_tpu.*`` ops and the serving artifact of
the port (``dir_tpu_torch/ops/library.py``, ``dir_tpu_torch/serve.py``),
on the CPU, against their plain versions and the JAX package.

Each op's CPU implementation is the plain version, bit for bit, and passes
``torch.library.opcheck`` with its fake implementation. The exported
programs of configurations A and B (``serve.export_program``, symbolic
batch; C and A's fixed batch in ``test_torch_port_artifact_int8.py``) name
the ops the live model runs and, loaded back (``serve.load``), equal the
live model. B's artifact agrees with ``dir_tpu``'s exported artifact of
the same weights and is served over HTTP (``apps/serve_http.py``: round
trip, micro-batching). The export CLI writes B at a fixed batch from a
reference-layout ``.pth`` of the same weights.

An export costs 10-30 s here, a load 10-25 s and an artifact about 310 MB
(the decoder's 67 M parameters at fp32), so each is made once: B's
symbolic artifact once a session (``torch_port_artifact_helpers.py``).
"""

import io
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu import serve as jserve
from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.train import checkpoint as jckpt

from dir_tpu_torch import serve
from dir_tpu_torch.apps import export as export_app
from dir_tpu_torch.apps import serve_http
from dir_tpu_torch.ops import bone_splat as bs
from dir_tpu_torch.ops import fused_bottleneck as fb
from dir_tpu_torch.ops import fused_bottleneck_int8 as q8
from dir_tpu_torch.ops import fused_stem_bottleneck as st

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_artifact_helpers import (LAYERS, OPS,  # noqa: E402
                                         assert_equal, check_fixed_batch,
                                         export_round_trip, image, live)
from torch_port_artifact_helpers import (exported_b,  # noqa: E402,F401
                                         seeded_weights)
from torch_port_helpers import (max_err, numpy_tree,  # noqa: E402
                                torch_threads)
from torch_port_train_helpers import jax_manos  # noqa: E402

T = torch.from_numpy


@pytest.fixture(scope="module", autouse=True)
def _four_threads():
    with torch_threads(4):
        yield


# ---------------------------------------------------------------- the ops


def _folded(rng, c, mid, o, down):
    def w(*shape):
        return T((rng.uniform(-1, 1, shape)
                  / np.sqrt(np.prod(shape[:-1]))).astype(np.float32))

    def b(n):
        return T(rng.uniform(-0.5, 0.5, n).astype(np.float32))

    ws = [w(c, mid), b(mid), w(3, 3, mid, mid), b(mid), w(mid, o), b(o)]
    return ws + ([w(c, o), b(o)] if down else [None, None])


def _k1_args(down, dtype, bands):
    rng = np.random.RandomState(10 + down)
    c, mid = 32, 16
    x = T(rng.randn(2, 8, 8, c).astype(np.float32)).to(dtype)
    ws = _folded(rng, c, mid, 2 * c if down else c, down)
    op = fb.pack(*ws, bands=bands, dtype=dtype)
    return x, ws, (x, op.image, op.b1, op.b2, op.b3, op.bd, op.mid, op.o,
                   bands)


def _k3_args(down, dtype):
    rng = np.random.RandomState(20 + down)
    c, mid = 64, 32
    x = T(rng.randn(2, 8, 8, c).astype(np.float32)).to(dtype)
    ws = _folded(rng, c, mid, 2 * c if down else c, down)
    scales = [torch.tensor(s) for s in (0.03, 0.02, 0.015)]
    op = q8.kernel_operands(*ws[:6], *scales, *ws[6:])
    return x, ws, scales, (x, *op[:10], op.mid, op.o)


def _k4_args(dtype):
    rng = np.random.RandomState(30)
    c, mid, o = 16, 16, 64
    x = T(rng.randn(1, 16, 12, c).astype(np.float32)).to(dtype)
    g1 = T(rng.uniform(0.5, 1.5, c).astype(np.float32))
    t1 = T(rng.uniform(-0.5, 0.5, c).astype(np.float32))
    ws = _folded(rng, c, mid, o, True)
    op = st.pack(g1, t1, *ws, dtype=dtype)
    return x, [g1, t1, *ws], (x, op.image, op.vec, op.gt, op.mid, op.o)


def _k5_args(dtype, grad=False):
    rng = np.random.RandomState(40)
    uv = T(rng.uniform(-0.9, 0.9, (2, 21, 2)).astype(np.float32))
    feat = T(rng.randn(2, 21, 8).astype(np.float32)).to(dtype)
    if grad:
        uv.requires_grad_(True)
        feat.requires_grad_(True)
    return (uv, feat, 8, 1.5)


@pytest.mark.parametrize("bands", [0, 2])
@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bottleneck_op_is_the_plain_version(down, dtype, bands):
    """K1/K2's op on the CPU: the plain version on the unpacked image, bit
    for bit (an fp32 image holds the fp32 weights exactly; a bf16 one
    rounds them as the plain version casts them); the CPU run counted."""
    x, ws, args = _k1_args(down, dtype, bands)
    runs = fb.fused_bottleneck_infer.plain_runs
    out = torch.ops.dir_tpu.fused_bottleneck(*args)
    assert fb.fused_bottleneck_infer.plain_runs == runs + 1
    assert torch.equal(out, fb.fused_bottleneck_infer_plain(x, *ws))


@pytest.mark.parametrize("down", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bottleneck_int8_op_is_the_plain_version(down, dtype):
    x, ws, scales, args = _k3_args(down, dtype)
    runs = q8.fused_bottleneck_int8_infer.plain_runs
    out = torch.ops.dir_tpu.fused_bottleneck_int8(*args)
    assert q8.fused_bottleneck_int8_infer.plain_runs == runs + 1
    assert torch.equal(out, q8.fused_bottleneck_int8_infer_plain(
        x, *ws[:6], *scales, *ws[6:]))


def test_int8_pack_at_any_mid_unpacks_exactly():
    """Widths the kernel does not take (mid 8) are laid out with zero
    channels up to 32 for the plain route; the unpacked int8 weights are
    the quantized ones."""
    rng = np.random.RandomState(5)
    ws = _folded(rng, 32, 8, 40, True)
    scales = [torch.tensor(0.1)] * 3
    op = q8.pack(*ws[:6], *scales, *ws[6:])
    got = q8.unpack_weights(op.image, 32, 8, 40, True)
    want = q8._quantized_operands(ws[0], ws[2], ws[4], ws[6], *scales)[:4]
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)
    with pytest.raises(ValueError):
        q8.kernel_operands(*ws[:6], *scales, *ws[6:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_stem_bottleneck_op_is_the_plain_version(dtype):
    x, ws, args = _k4_args(dtype)
    runs = st.fused_stem_bottleneck.plain_runs
    out = torch.ops.dir_tpu.fused_stem_bottleneck(*args)
    assert st.fused_stem_bottleneck.plain_runs == runs + 1
    assert torch.equal(out, st.fused_stem_bottleneck_plain(x, *ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bone_splat_op_is_the_plain_version_with_its_gradient(dtype):
    """K5's op on the CPU, forward and the gradient of its
    ``register_autograd``: both the plain version's, bit for bit."""
    args = _k5_args(dtype, grad=True)
    runs = bs.bone_splat.plain_runs
    out = torch.ops.dir_tpu.bone_splat(*args)
    assert bs.bone_splat.plain_runs == runs + 1
    ref_args = tuple(a.detach().clone().requires_grad_(True)
                     if isinstance(a, torch.Tensor) else a for a in args)
    ref = bs.bone_splat_plain(*ref_args)
    assert torch.equal(out, ref)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    got = torch.autograd.grad(out, args[:2], g)
    want = torch.autograd.grad(ref, ref_args[:2], g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _opcheck(op, args):
    torch.library.opcheck(op, args)


def test_opcheck_fused_bottleneck():
    for down, bands in ((False, 0), (True, 2)):
        _opcheck(torch.ops.dir_tpu.fused_bottleneck.default,
                 _k1_args(down, torch.float32, bands)[2])


def test_opcheck_fused_bottleneck_int8():
    for down in (False, True):
        _opcheck(torch.ops.dir_tpu.fused_bottleneck_int8.default,
                 _k3_args(down, torch.float32)[3])


def test_opcheck_fused_stem_bottleneck():
    _opcheck(torch.ops.dir_tpu.fused_stem_bottleneck.default,
             _k4_args(torch.float32)[2])


def test_opcheck_bone_splat():
    """With inputs that require grad: the autograd registration too."""
    _opcheck(torch.ops.dir_tpu.bone_splat.default,
             _k5_args(torch.float32, grad=True))


# ----------------------------------------------------------- the artifacts


@pytest.fixture(scope="module")
def exported_a(seeded_weights, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("artifact_a") / "a.pt2")
    yield export_round_trip(seeded_weights[1], "A", path)
    os.remove(path)


@pytest.fixture(scope="module", params=["A", "B"])
def symbolic(request):
    return request.getfixturevalue(f"exported_{request.param.lower()}")


def test_artifact_names_the_kernel_ops(symbolic):
    assert serve.op_counts(symbolic.program) == OPS[symbolic.name]


def test_artifact_equals_the_live_model_at_any_batch(symbolic):
    """Measured max abs err 0 at batch 1 and 3: the same ops on the same
    tensors, so the bound is equality; the artifact runs the ops' CPU
    implementations as the live model does."""
    name, model, (ml, mr) = symbolic.name, symbolic.model, symbolic.manos
    live_infer = serve.make_infer(model, ml, mr)
    counts = (fb.fused_bottleneck_infer.plain_runs,
              bs.bone_splat.plain_runs)
    for b, seed in ((1, 1), (3, 2)):
        img = image(b, seed)
        assert_equal(symbolic.infer(img), live_infer(img))
    runs = (fb.fused_bottleneck_infer.plain_runs - counts[0],
            bs.bone_splat.plain_runs - counts[1])
    assert runs == (4 * OPS[name]["fused_bottleneck"],
                    4 * OPS[name]["bone_splat"])


def test_load_rejects_a_foreign_blob():
    with pytest.raises(ValueError, match="bad magic"):
        serve.load_infer(b"not an artifact")
    with pytest.raises(ValueError, match="bad magic"):
        serve.load_infer(jserve._MAGIC + b"\x00" * 16)


# Configuration B's artifact against dir_tpu's exported artifact of the
# same weights (its unfused blocks and materialized plain splat: the plain
# references of K1, K2 and K5) at batch 2, all three stages. Measured max
# abs error: xyz 1.1e-7 m (values ~0.15), uv 4.8e-7, the other stage
# outputs 8.3e-7, seg and dense 1.2e-6; the bounds are the whole-slice
# test's (tests/test_torch_port_model.py), 5 to 45 times these.
SLICE_TOL = {"xyz": 5e-6, "uv": 1e-5, "other": 2e-5, "head": 2e-5}


def test_artifact_matches_dir_tpu_artifact(seeded_weights, exported_b):
    variables = seeded_weights[0]
    jl, jr = jax_manos()
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS,
                               fused_splat_conv=False))
    jfn = jserve.load_infer(jserve.export_infer(
        jmodel, variables, jl, jr, batch_size=2))
    img = image(2, 4)
    ref = jax.tree.map(np.asarray, jfn(jnp.asarray(img)))
    out = exported_b.infer(img)
    errs = {}
    for r, o in zip(ref["stages"], out["stages"]):
        assert sorted(o) == sorted(r)
        for key, r_val in r.items():
            kind = ("xyz" if "xyz" in key else "uv" if "uv" in key
                    else "other")
            errs[kind] = max(errs.get(kind, 0.0), max_err(o[key], r_val))
    errs["head"] = max(max_err(out[k], ref[k]) for k in ("seg", "dense"))
    for kind, err in errs.items():
        assert err < SLICE_TOL[kind], (kind, err)


# ----------------------------------- the export CLI: B at a fixed batch


@pytest.fixture(scope="module")
def cli_b(seeded_weights, tmp_path_factory):
    """The export CLI on B's weights as a reference-layout ``.pth``
    (``dir_tpu``'s export under "net"), B's kernel flags, a fixed batch of
    2 and ``--check`` (the reloaded artifact against the live model)."""
    root = tmp_path_factory.mktemp("cli_b")
    variables = seeded_weights[0]
    sd = jckpt.export_torch_dir_state(numpy_tree(variables["params"]),
                                      numpy_tree(variables["batch_stats"]),
                                      LAYERS)
    pth = str(root / "DIR.pth")
    torch.save({"net": {k: torch.from_numpy(np.array(v))
                        for k, v in sd.items()}}, pth)
    path = str(root / "b2.pt2")
    result = export_app.main([
        "--model", pth, "--device", "cpu", "--synthetic_mano",
        "--backbone_layers", ",".join(map(str, LAYERS)), "--batch", "2",
        "--fused_bottleneck", "--fused_l2_bands", "4", "--bone_splat",
        "--out", path, "--check"])
    yield path, result
    os.remove(path)


def test_export_cli_check(cli_b):
    path, result = cli_b
    # measured 0: the same ops on the same tensors
    assert result["check_err"] == 0.0
    assert result["path"] == path
    assert result["bytes"] == os.path.getsize(path)
    assert result["ops"] == OPS["B"]


def test_fixed_batch_artifact_round_trip_b(seeded_weights, cli_b):
    """The CLI's artifact against the live B on the same weights (from the
    state_dict, not the .pth): equal at batch 2, batch 3 refused."""
    model, ml, mr = live(seeded_weights[1], "B")
    check_fixed_batch(serve.load(cli_b[0]), model, ml, mr)


# ------------------------------------------------------- the HTTP server


def _post(base, img):
    buf = io.BytesIO()
    np.save(buf, img)
    r = urllib.request.urlopen(f"{base}/infer", buf.getvalue(), timeout=600)
    return dict(np.load(io.BytesIO(r.read())))


def test_http_server_roundtrip(exported_b):
    """healthz, /infer with an .npy body -> .npz equal to the live model,
    /stats accounting, a 400 on a malformed body and a 413 beyond the
    server's body limit (4 MiB here; batch 2 is 1.5 MB)."""
    model, (ml, mr) = exported_b.model, exported_b.manos
    srv = serve_http.make_server(exported_b.infer, port=0, full=True,
                                 max_body=1 << 22)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert urllib.request.urlopen(f"{base}/healthz").read() == b"ok"
        img = image(2, 1)
        out = _post(base, img)
        want = serve.make_infer(model, ml, mr)(img)
        # the artifact equals the live model (measured 0)
        np.testing.assert_array_equal(
            out["mesh_xyz_left"],
            want["stages"][-1]["pd_mesh_xyz_left"].numpy())
        np.testing.assert_array_equal(out["seg"], want["seg"].numpy())
        assert out["offset"].shape == (2, 3)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["requests"] == 1 and stats["images"] == 2
        assert stats["avg_latency_ms"] > 0 and stats["avg_batch"] == 2
        # no micro-batcher, no queue of its own
        assert stats["avg_queue_wait_ms"] is None
        assert "queue_wait_sum" not in stats
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{base}/infer", b"garbage")
        assert err.value.code == 400 and "error" in json.loads(
            err.value.read())
        req = urllib.request.Request(
            f"{base}/infer", b"x", headers={
                "Content-Length": str((1 << 22) + 1)})
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req)
        assert err.value.code == 413
    finally:
        srv.shutdown()
        srv.server_close()


def test_http_microbatching(exported_b):
    """Concurrent batch-1 requests coalesce into fewer dispatches, pad up
    to the bucket, and each request gets its own rows, equal to the live
    model on the four images as one batch of 8 (padded with zeros)."""
    model, (ml, mr) = exported_b.model, exported_b.manos
    srv = serve_http.make_server(exported_b.infer, port=0, max_batch=8,
                                 window_ms=2000.0, buckets=(8,))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        imgs = [image(1, 10 + i) for i in range(4)]
        outs = [None] * 4

        def post(i):
            outs[i] = _post(base, imgs[i])

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert all(o is not None for o in outs)
        padded = np.concatenate(imgs + [np.zeros_like(imgs[0])] * 4)
        want = serve.make_infer(model, ml, mr)(padded)["stages"][-1][
            "pd_mesh_xyz_left"].numpy()
        for i, out in enumerate(outs):
            # rows of another batch composition: the CPU's fp32 sums may
            # order differently; measured max abs err 0 here
            np.testing.assert_allclose(out["mesh_xyz_left"],
                                       want[i:i + 1], rtol=0, atol=1e-6)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats").read())
        assert stats["requests"] == 4 and stats["images"] == 4
        assert stats["dispatches"] < 4 and stats["avg_batch"] > 1
        # a request waits in the batcher's queue until its dispatch, at
        # most the 2 s window and the dispatch before it
        assert 0 < stats["avg_queue_wait_ms"] < stats["avg_latency_ms"]
    finally:
        srv.batcher.stop()
        srv.shutdown()
        srv.server_close()
