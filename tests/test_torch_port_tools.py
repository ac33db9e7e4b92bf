"""The port's counterparts of dir_tpu's workflow tools (``tools/*.py``) as
CLIs under ``dir_tpu_torch/apps/``, on synthetic inputs, against what
dir_tpu's own functions write: ``convert_mano`` (MANO pickles to ``.npz``),
``prepare_interhand`` (a raw InterHand2.6M release to the training layout),
``build_sample_cache`` (the packed decode-once cache), ``convert_checkpoint``
(a reference ``.pth`` to a port checkpoint and back) and ``convergence``
(AdamW steps on one fixed batch, here at the tiny backbone on the CPU).
"""

import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from dir_tpu.config import ModelConfig as JModelConfig
from dir_tpu.data import sample_cache as jcache
from dir_tpu.data.prepare import prepare_split as jprepare_split
from dir_tpu.mano import assets as jassets
from dir_tpu.models.dir import DIR as JDIR
from dir_tpu.train import checkpoint as jck

from dir_tpu_torch.apps import (build_sample_cache, convergence,
                                convert_checkpoint, convert_mano,
                                prepare_interhand)
from dir_tpu_torch.data import sample_cache as tcache
from dir_tpu_torch.data import synthetic as tsynthetic
from dir_tpu_torch.mano import assets as tassets
from dir_tpu_torch.train import checkpoint as tck

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_apps import _raw_interhand  # noqa: E402
from test_torch_port_data import _chumpy_pickle  # noqa: E402
from torch_port_helpers import numpy_tree, torch_threads  # noqa: E402
from torch_port_train_helpers import LAYERS, jax_variables  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    with torch_threads(2):
        yield


def _jax_pair():
    right = jassets.synthetic_mano("right", seed=0)
    return jassets.fix_left_shapedirs(
        jassets.synthetic_mano("left", seed=0), right), right


@pytest.fixture(scope="module")
def mano_dir(tmp_path_factory):
    """Official-style MANO pickles of the synthetic pair."""
    d = str(tmp_path_factory.mktemp("mano"))
    for side, model in zip(("LEFT", "RIGHT"), _jax_pair()):
        _chumpy_pickle(os.path.join(d, f"MANO_{side}.pkl"), model)
    return d


def _same_files(got_dir: str, want_dir: str) -> None:
    names = sorted(os.listdir(want_dir))
    assert names and names == sorted(os.listdir(got_dir))
    for name in names:
        with open(os.path.join(got_dir, name), "rb") as g, \
                open(os.path.join(want_dir, name), "rb") as w:
            assert g.read() == w.read(), name


def test_convert_mano_cli_matches_jax(tmp_path, mano_dir):
    out = str(tmp_path / "port")
    written = convert_mano.main(["--mano_dir", mano_dir, "--out", out])
    assert [os.path.basename(p) for p in written] == ["MANO_LEFT.npz",
                                                      "MANO_RIGHT.npz"]
    for side in ("LEFT", "RIGHT"):
        want_path = str(tmp_path / f"jax_{side}.npz")
        jassets.convert_mano_pkl(os.path.join(mano_dir, f"MANO_{side}.pkl"),
                                 want_path, side.lower())
        with np.load(os.path.join(out, f"MANO_{side}.npz")) as got, \
                np.load(want_path) as want:
            assert got.files == want.files
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("flags", [[], ["--max_samples", "2", "--no-render"]])
def test_prepare_interhand_cli_matches_jax(tmp_path, mano_dir, flags):
    raw = _raw_interhand(str(tmp_path / "raw"), np.random.RandomState(25))
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    written = prepare_interhand.main(
        ["--data_path", raw, "--save_path", out, "--mano_path", mano_dir,
         "--splits", "test"] + flags)
    jleft, jright = jassets.load_mano_pair(mano_dir, tips_style="data")
    n = jprepare_split(raw, jout, "test", jleft, jright,
                       max_samples=2 if flags else None,
                       render=not flags)
    assert written == {"test": n} and n == (2 if flags else 3)
    subs = sorted(os.listdir(os.path.join(jout, "test")))
    assert subs == sorted(os.listdir(os.path.join(out, "test")))
    for sub in subs:
        if sub == "anno":
            continue
        if os.listdir(os.path.join(jout, "test", sub)):
            _same_files(os.path.join(out, "test", sub),
                        os.path.join(jout, "test", sub))
    for i in range(n):
        with open(os.path.join(out, "test", "anno", f"{i}.pkl"), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(jout, "test", "anno", f"{i}.pkl"), "rb") as f:
            want = pickle.load(f)
        flat_g, spec_g = jax.tree.flatten(got)
        flat_w, spec_w = jax.tree.flatten(want)
        assert spec_g == spec_w
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_build_sample_cache_cli_matches_jax(tmp_path):
    """A split written by the port's writer (data-side tips), cached by the
    CLI with ``--synthetic_mano`` and by dir_tpu's ``build_cache`` with the
    same MANO pair, as ``tools/build_sample_cache.py`` builds it."""
    right = tassets.synthetic_mano("right", seed=0, tips=tassets.TIPS_DATA)
    left = tassets.fix_left_shapedirs(
        tassets.synthetic_mano("left", seed=0, tips=tassets.TIPS_DATA), right)
    for tag in ("port", "jax"):
        tsynthetic.generate(str(tmp_path / tag), left, right, split="test",
                            num_samples=3)
    out = build_sample_cache.main(["--data_path", str(tmp_path / "port"),
                                   "--split", "test", "--synthetic_mano"])
    assert out == tcache.cache_dir(str(tmp_path / "port"), "test")
    jl, jr = _jax_pair()
    want = jcache.build_cache(str(tmp_path / "jax"), "test", jl, jr,
                              log_every=0)
    _same_files(out, want)


def test_convert_checkpoint_cli_round_trip(tmp_path):
    """A reference ``.pth`` of dir_tpu's tiny DIR weights (written by
    ``export_torch_dir_state``) becomes a port checkpoint that holds them,
    and exporting that checkpoint writes the same ``net``."""
    jmodel = JDIR(JModelConfig(backbone_layers=LAYERS))
    variables = jax_variables(jmodel, np.zeros((1, 64, 64, 3), np.float32))
    want = jck.export_torch_dir_state(numpy_tree(variables["params"]),
                                      numpy_tree(variables["batch_stats"]))
    pth = str(tmp_path / "DIR.pth")
    torch.save({"net": {k: torch.from_numpy(np.array(v))
                        for k, v in want.items()}}, pth)
    layers = ["--backbone_layers", ",".join(map(str, LAYERS))]
    ckpt_dir = str(tmp_path / "ckpt")
    path = convert_checkpoint.main(
        ["--torch", pth, "--out", os.path.join(ckpt_dir, "latest")] + layers)
    assert path == os.path.join(ckpt_dir, "latest.pt")
    held = tck.load_checkpoint_weights(ckpt_dir, "latest")
    assert set(held) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(held[k].numpy(), v, err_msg=k)
    out = str(tmp_path / "export.pth")
    assert convert_checkpoint.main(["--checkpoint", ckpt_dir, "--name",
                                    "latest", "--out", out] + layers) == out
    net = torch.load(out, weights_only=True)["net"]
    assert set(net) == set(want)
    for k, v in want.items():
        assert net[k].dtype == torch.from_numpy(np.array(v)).dtype, k
        np.testing.assert_array_equal(net[k].numpy(), v, err_msg=k)
    with pytest.raises(SystemExit):
        convert_checkpoint.main(["--out", out])


def test_convergence_cli_repeats_on_the_cpu(capsys):
    """Four steps of the tiny backbone at batch 2: finite losses, a closing
    JSON line with the summary, and a second run equal to the bit."""
    argv = ["--device", "cpu", "--steps", "4", "--batch", "2",
            "--backbone_layers", "1,1,1,1"]
    runs = []
    for _ in range(2):
        summary = convergence.main(argv)
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[0].startswith("step=   4 loss=")
        assert lines[-1].startswith("{") and '"final_loss"' in lines[-1]
        runs.append(summary)
    for key in ("first_loss", "final_loss", "loss_min"):
        assert np.isfinite(runs[0][key])
        assert runs[0][key] == runs[1][key], key
    assert runs[0]["steps"] == 4 and runs[0]["device"] == "cpu"
    assert runs[0]["ms_per_step_median"] > 0
