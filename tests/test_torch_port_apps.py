"""The port's apps and their helpers on the CPU, against ``dir_tpu``:
the HTTP server's micro-batcher (``dir_tpu_torch/apps/serve_http.py``),
the infer, demo and train CLIs, the reference ``.pth`` loader, the
rasterizer, the mesh overlay, the InterHand converter and the profiling
timer. The export CLI and the HTTP server run on configuration B's
artifact in ``test_torch_port_artifact.py``.

The CLI smokes run the tiny backbone with ``--device cpu``.
"""

import json
import os
import pickle
import sys
import threading

import cv2 as cv
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.data.prepare import prepare_split as jprepare_split
from dir_tpu.data.rasterizer import render_two_hands as jrender_two_hands
from dir_tpu.mano import TIPS_DATA as JTIPS_DATA
from dir_tpu.mano import fix_left_shapedirs as jfix
from dir_tpu.mano import synthetic_mano as jsynthetic_mano
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.train import checkpoint as jckpt
from dir_tpu.utils.visualize import render_mesh_overlay as jrender_overlay

from dir_tpu_torch import serve
from dir_tpu_torch.apps import demo as demo_app
from dir_tpu_torch.apps import infer as infer_app
from dir_tpu_torch.apps import serve_http
from dir_tpu_torch.apps import train as train_app
from dir_tpu_torch.config import ModelConfig
from dir_tpu_torch.data import synthetic
from dir_tpu_torch.data.prepare import prepare_split
from dir_tpu_torch.data.rasterizer import (dense_colors, mask_colors,
                                           render_two_hands)
from dir_tpu_torch.mano.assets import (TIPS_DATA, fix_left_shapedirs,
                                       synthetic_mano)
from dir_tpu_torch.models.dir import DIR
from dir_tpu_torch.train import checkpoint as ckpt
from dir_tpu_torch.utils import profiling
from dir_tpu_torch.utils.visualize import render_mesh_overlay

sys.path.insert(0, os.path.dirname(__file__))
from torch_port_helpers import numpy_tree, torch_threads  # noqa: E402
from torch_port_train_helpers import (jax_manos, jax_variables,  # noqa: E402
                                      port_manos)

LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module", autouse=True)
def _four_threads():
    with torch_threads(4):
        yield


def _image(b, seed):
    return np.random.RandomState(seed).randn(b, 256, 256, 3).astype(
        np.float32)


# ------------------------------------------------------- the micro-batcher


def _fake_infer(batch):
    """Stands in for serve.load(): batch-shaped outputs, stages layout;
    rejects any resolution but 8x8 as an artifact rejects a shape it was
    not exported for."""
    b = batch.shape[0]
    if batch.shape[1:] != (8, 8, 3):
        raise ValueError(f"artifact expects (B, 8, 8, 3), got {batch.shape}")
    row = torch.arange(b, dtype=torch.float32)
    return {"stages": [{
        "pd_mesh_xyz_left": row[:, None, None].expand(b, 4, 3),
        "pd_mesh_xyz_right": torch.zeros(b, 4, 3),
        "pd_joint_xyz_left": torch.zeros(b, 2, 3),
        "pd_joint_xyz_right": torch.zeros(b, 2, 3),
        "pd_offset": torch.zeros(b, 3),
    }]}


def _make_batcher(max_batch=8, window_ms=500.0, buckets=()):
    stats = {"requests": 0, "images": 0, "dispatches": 0, "lat_sum": 0.0}
    return serve_http.MicroBatcher(_fake_infer, threading.Lock(), stats,
                                   False, max_batch, window_ms,
                                   buckets), stats


def test_mixed_shape_group_isolates_bad_request():
    """A request at the wrong resolution gets its own error; its group
    neighbour gets its rows, and the batcher keeps serving."""
    batcher, _ = _make_batcher()
    try:
        results = {}

        def post(tag, shape):
            try:
                results[tag] = batcher.submit(np.zeros(shape, np.float32))
            except Exception as e:  # noqa: BLE001 — recorded for asserts
                results[tag] = e

        threads = [
            threading.Thread(target=post, args=("good", (1, 8, 8, 3))),
            threading.Thread(target=post, args=("bad", (1, 4, 4, 3))),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert isinstance(results["bad"], ValueError)
        assert results["good"]["mesh_xyz_left"].shape == (1, 4, 3)
        after = batcher.submit(np.zeros((2, 8, 8, 3), np.float32))
        assert after["mesh_xyz_left"].shape == (2, 4, 3)
    finally:
        batcher.stop()


def test_submit_after_stop_raises_instead_of_hanging():
    batcher, _ = _make_batcher()
    batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit(np.zeros((1, 8, 8, 3), np.float32))


def test_rows_route_back_per_request_after_fallback():
    batcher, _ = _make_batcher(window_ms=5000.0)
    try:
        with pytest.raises(ValueError):
            batcher.submit(np.zeros((1, 5, 5, 3), np.float32))
        outs = {}

        def post(i, n):
            outs[i] = batcher.submit(np.zeros((n, 8, 8, 3), np.float32))

        threads = [threading.Thread(target=post, args=(0, 1)),
                   threading.Thread(target=post, args=(1, 2))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert outs[0]["mesh_xyz_left"].shape == (1, 4, 3)
        assert outs[1]["mesh_xyz_left"].shape == (2, 4, 3)
        r1 = [float(outs[1]["mesh_xyz_left"][j, 0, 0]) for j in range(2)]
        assert r1[1] == r1[0] + 1
        got = {float(outs[0]["mesh_xyz_left"][0, 0, 0])} | set(r1)
        assert got in ({0.0, 1.0, 2.0}, {0.0, 1.0}), got
    finally:
        batcher.stop()


# ------------------------------------------------------- the .pth loader


# Keys the reference's .pth carries and the port does not hold: STE block 0
# of each refine stage (unused by the reference's forward).
_UNMAPPED = ("decoder.projecter_4.interaction.STEblocks.0.norm1.weight",
             "decoder.projecter_3.interaction.STEblocks.0.attn.qkv.weight")


def test_reference_pth_loads_as_in_dir_tpu(tmp_path):
    """A reference-layout .pth (dir_tpu's export plus keys the port does
    not hold, under "net") through the port's loader and through
    dir_tpu's: the two models give the same outputs."""
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS))
    img = _image(1, 3)
    variables = jax_variables(jmodel, img)
    sd = jckpt.export_torch_dir_state(numpy_tree(variables["params"]),
                                      numpy_tree(variables["batch_stats"]),
                                      LAYERS)
    net = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    for k in _UNMAPPED:
        net[k] = torch.ones(3)
    path = str(tmp_path / "DIR.pth")
    torch.save({"net": net, "epoch": 3}, path)

    loaded = ckpt.load_torch_dir_checkpoint(path, LAYERS)
    assert not set(_UNMAPPED) & set(loaded)
    model = DIR(ModelConfig(backbone_layers=LAYERS))
    assert ckpt.load_model_weights(model, path) == "reference checkpoint"
    ml, mr = port_manos()
    out = serve.make_infer(model, ml, mr)(img)["stages"][-1]

    params, stats = jckpt.load_torch_dir_checkpoint(path, LAYERS)
    jl, jr = jax_manos()
    jvars = {"params": jckpt.prune_to_target(params, variables["params"]),
             "batch_stats": jckpt.prune_to_target(
                 stats, variables["batch_stats"])}
    ref = jmodel.apply(jvars, jnp.asarray(img), jl, jr,
                       train=False)["stages"][-1]
    for key in ("pd_mesh_xyz_left", "pd_mesh_xyz_right", "pd_offset"):
        # the whole-slice bound of tests/test_torch_port_model.py
        # (measured there 3.5e-7 m on values ~0.15)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=5e-6, err_msg=key)

    bad = dict(loaded)
    bad.pop("backbone.conv1.weight")
    with pytest.raises(KeyError):
        ckpt.prune_to_target(bad, model)


def test_import_torch_resnet50_keeps_the_backbone_keys():
    """torchvision's resnet50 keys (here the port's own backbone's, plus
    fc and the step counters) become the backbone's state_dict."""
    model = DIR(ModelConfig(backbone_layers=(3, 4, 6, 3)))
    sd = dict(model.backbone.state_dict())
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    got = ckpt.import_torch_resnet50(sd)
    assert "fc.weight" not in got
    assert not any(k.endswith("num_batches_tracked") for k in got)
    model.backbone.load_state_dict(ckpt.prune_to_target(got, model.backbone),
                                   strict=True)


# ----------------------------------- rasterizer, overlay and the converter


def _cam(size=64, f=100.0):
    return np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]],
                    np.float32)


def _hands(rng, n=50):
    verts_l = rng.randn(n, 3).astype(np.float32) * 0.05
    verts_l[:, 2] += 1.0
    verts_r = verts_l + np.array([0.15, 0, 0.1], np.float32)
    faces = np.stack([rng.choice(n, 3, replace=False)
                      for _ in range(40)]).astype(np.int32)
    return verts_l, verts_r, faces


def test_rasterizer_bit_equal_to_dir_tpu():
    rng = np.random.RandomState(0)
    verts_l, verts_r, faces = _hands(rng)
    for colors in ((mask_colors(50, "left"), mask_colors(50, "right")),
                   (dense_colors(verts_l), dense_colors(verts_r))):
        got = render_two_hands(verts_l, verts_r, faces, _cam(), 64, *colors)
        want = jrender_two_hands(verts_l, verts_r, faces, _cam(), 64,
                                 *colors)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (got[0] > 0).any()


def test_render_mesh_overlay_bit_equal_to_dir_tpu():
    rng = np.random.RandomState(1)
    verts_l, verts_r, faces = _hands(rng)
    image = rng.randint(0, 255, (64, 64, 3)).astype(np.uint8)
    for alpha in (1.0, 0.85):
        got = render_mesh_overlay(image, verts_l, verts_r, faces, _cam(),
                                  alpha=alpha)
        want = jrender_overlay(image, verts_l, verts_r, faces, _cam(),
                               alpha=alpha)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.uint8 and (got != image).any()


def _raw_interhand(root: str, rng) -> str:
    """A micro raw InterHand2.6M release (as tests/test_render_prepare.py
    fabricates it)."""
    split = "test"
    ann = os.path.join(root, "annotations", split)
    os.makedirs(ann)
    images, annotations = [], []
    for i in range(3):
        name = f"cap0/cam0/{i}.jpg"
        os.makedirs(os.path.join(root, "images", split, "cap0", "cam0"),
                    exist_ok=True)
        cv.imwrite(os.path.join(root, "images", split, name),
                   rng.randint(0, 255, (512, 334, 3)).astype(np.uint8))
        images.append({"capture": 0, "camera": "0", "frame_idx": i,
                       "file_name": name})
        annotations.append({"hand_type": "interacting",
                            "hand_type_valid": 1})
    cameras = {"0": {"campos": {"0": [0.0, 0.0, -800.0]},
                     "camrot": {"0": np.eye(3).tolist()},
                     "focal": {"0": [400.0, 400.0]},
                     "princpt": {"0": [167.0, 256.0]}}}
    mano = {"0": {str(i): {hand: {
        "pose": (rng.randn(48) * 0.2).tolist(),
        "shape": (rng.randn(10) * 0.3).tolist(),
        "trans": [0.03 if hand == "right" else -0.03, 0.0, 0.0]}
        for hand in ("left", "right")} for i in range(3)}}
    for kind, obj in (("data", {"images": images,
                                "annotations": annotations}),
                      ("camera", cameras), ("MANO_NeuralAnnot", mano)):
        with open(os.path.join(ann, f"InterHand2.6M_{split}_{kind}.json"),
                  "w") as f:
            json.dump(obj, f)
    return root


def test_prepare_split_bit_equal_to_dir_tpu(tmp_path):
    """The converter on the synthetic raw release: every file the port
    writes equals dir_tpu's, byte for byte (the images through the same
    cv2 encoder) and value for value (the annotation pickles)."""
    raw = _raw_interhand(str(tmp_path / "raw"), np.random.RandomState(25))
    right = synthetic_mano("right", seed=0, tips=TIPS_DATA)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0, tips=TIPS_DATA),
                              right)
    jright = jsynthetic_mano("right", seed=0, tips=JTIPS_DATA)
    jleft = jfix(jsynthetic_mano("left", seed=0, tips=JTIPS_DATA), jright)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    assert prepare_split(raw, out, "test", left, right) == 3
    assert jprepare_split(raw, jout, "test", jleft, jright) == 3
    for sub in ("img", "mask", "dense", "hms"):
        names = sorted(os.listdir(os.path.join(jout, "test", sub)))
        assert names == sorted(os.listdir(os.path.join(out, "test", sub)))
        assert names
        for name in names:
            with open(os.path.join(out, "test", sub, name), "rb") as f, \
                    open(os.path.join(jout, "test", sub, name), "rb") as g:
                assert f.read() == g.read(), (sub, name)
    for i in range(3):
        with open(os.path.join(out, "test", "anno", f"{i}.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(jout, "test", "anno", f"{i}.pkl"), "rb") as f:
            want = pickle.load(f)
        flat_g, spec_g = jax.tree.flatten(got)
        flat_w, spec_w = jax.tree.flatten(want)
        assert spec_g == spec_w
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------- the CLI smokes


def test_infer_cli(tmp_path):
    img = (np.random.RandomState(0).rand(256, 256, 3) * 255).astype(np.uint8)
    cv.imwrite(str(tmp_path / "crop.png"), img)
    out = str(tmp_path / "out")
    final = infer_app.main([
        "--image", str(tmp_path / "crop.png"), "--device", "cpu",
        "--synthetic_mano", "--backbone_layers", ",".join(map(str, LAYERS)),
        "--out", out])
    for name in infer_app.OUTPUTS:
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    assert final["pd_mesh_xyz_left"].shape == (778, 3)
    assert all(np.isfinite(v).all() for v in final.values())
    with open(os.path.join(out, "hand_left.obj")) as f:
        lines = f.read().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == 778


def test_demo_cli(tmp_path):
    out = str(tmp_path / "demo.png")
    panels = demo_app.main(["--device", "cpu", "--out", out,
                            "--mano_path", str(tmp_path / "none")])
    assert panels.shape == (256, 768, 3)
    assert (cv.imread(out) == panels).all()
    # mask (green, red), dense and skeleton panels are all drawn
    assert all(panels[:, 256 * i:256 * (i + 1)].any() for i in range(3))


def test_train_cli(tmp_path):
    """One epoch of 2 steps at 64x64 on the synthetic split, its in-loop
    eval and checkpoints; --devices above 1 names the missing port."""
    right = synthetic_mano("right", seed=0)
    left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
    data = str(tmp_path / "data")
    synthetic.generate(data, left, right, split="train", num_samples=4,
                       img_size=64)
    synthetic.generate(data, left, right, split="test", num_samples=2,
                       seed=5, img_size=64)
    out = str(tmp_path / "out")
    args = ["--device", "cpu", "--synthetic_mano", "--data_dir", data,
            "--output", out, "--batch_size", "2", "--epochs", "1",
            "--backbone_layers", ",".join(map(str, LAYERS)), "--img_size",
            "64", "--num_workers", "2"]
    best = train_app.main(args)
    assert np.isfinite(best)
    assert os.path.exists(os.path.join(out, "checkpoint", "latest.pt"))
    with pytest.raises(SystemExit):
        train_app.parse_args(args + ["--devices", "2"])
    import shutil
    shutil.rmtree(out)


def test_time_fn_on_the_host_clock():
    calls = []
    seconds = profiling.time_fn(lambda: calls.append(1) or torch.ones(2),
                                iters=4, warmup=2)
    assert len(calls) == 6 and seconds >= 0
    assert profiling.throughput(lambda: torch.ones(2), batch=8, iters=2,
                                warmup=1) > 0
