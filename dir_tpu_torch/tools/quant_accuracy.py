"""Accuracy cost of the port's int8 serving modes and of the bf16 trunk
(counterpart of ``tools/quant_accuracy.py``).

Runs the port's eval app (``dir_tpu_torch/apps/eval.py``: the reference's
root-centered, bone-length-scale-aligned mm errors) on a synthetic test
split once per row of ``MODES`` (fp; bf16 trunk; int8 backbone; int8
backbone and decoder; the same with static scales; with the auxiliary
convs too) and prints a table of the absolute metrics of each row's
``SUMMARY`` line and their deltas against fp. Each row runs in this
process, its metric block captured.

The network is the seeded random init (``--model random``); the released
DIR.pth is licensed and absent, so the deltas measure the numeric drift of
int8 quantization through the 53-conv network, not the trained model's
task accuracy. Every row has the same weights: the deltas are the modes'
own effects. The random weights (the eval app's ``weights.random_init_``,
seed 0) are drawn once and handed to every row as a checkpoint. ``--fused_bottleneck`` (this tool only) runs the bf16 row with
the fused bottleneck kernel (K1) at layer1, as serving does.

Usage:
    python -m dir_tpu_torch.tools.quant_accuracy [--samples 16] [--bs 4] \
        [--backbone_layers 3,4,6,3] [--data_path DIR] [--model random] \
        [--modes static,aux] [--fused_bottleneck] [--device cpu]

Runs on the card unless ``--device`` names another device. The last line
is ``TABLE {json}``: each row's summary by mode name.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

MODES = [
    ("fp (QUANT=0)", []),
    ("bf16 trunk", ["--dtype", "bfloat16"]),
    ("int8 backbone (QUANT=1)", ["--quant_backbone"]),
    ("int8 bb+decoder (QUANT=2)", ["--quant_backbone", "--quant_decoder"]),
    ("int8 bb+dec static (QUANT=2+S)",
     ["--quant_backbone", "--quant_decoder", "--quant_static"]),
    ("int8 bb+dec+aux static (QUANT=3+S)",
     ["--quant_backbone", "--quant_decoder", "--quant_aux",
      "--quant_static"]),
]
KEYS = ["joint_mean_all_mm", "vert_mean_all_mm", "joint2d_mean_all_px",
        "vert2d_mean_all_px", "root_mean_mm"]


def run_mode(data_dir, out_root, extra, bs, backbone, model="random",
             device=None) -> dict:
    """One eval app run; its ``SUMMARY`` line's dict."""
    import torch

    from dir_tpu_torch.apps import eval as eval_app

    out = os.path.join(out_root, "_".join(extra) or "fp")
    argv = ["--model", model, "--data_path", data_dir, "--out", out,
            "--bs", str(bs), "--synthetic_mano", "--backbone_layers",
            backbone] + extra
    if device is not None:
        argv += ["--device", device]
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        eval_app.main(argv)
    torch.cuda.empty_cache()
    line = next(ln for ln in captured.getvalue().splitlines()
                if ln.startswith("SUMMARY "))
    return json.loads(line[len("SUMMARY "):])


def random_checkpoint(root: str, backbone: str) -> str:
    """``--model random`` drawn once: the eval app's seeded random weights
    written as ``<root>/random/latest.pt``; returns the directory, which
    the eval app reads as a checkpoint."""
    import torch

    from dir_tpu_torch.config import ModelConfig
    from dir_tpu_torch.models.dir import DIR
    from dir_tpu_torch.train.checkpoint import model_state_dict
    from dir_tpu_torch.weights import random_init_

    layers = tuple(int(x) for x in backbone.split(","))
    model = random_init_(DIR(ModelConfig(backbone_layers=layers)), seed=0)
    ckpt_dir = os.path.join(root, "random")
    os.makedirs(ckpt_dir)
    torch.save({"model": model_state_dict(model)},
               os.path.join(ckpt_dir, "latest.pt"))
    return ckpt_dir


def main(argv=None) -> list:
    """Print the table; return ``[(mode name, summary), ...]``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--bs", type=int, default=4)
    ap.add_argument("--backbone_layers", type=str, default="3,4,6,3",
                    help="full depth by default: quantization error "
                         "accumulates per conv, a truncated backbone "
                         "understates it")
    ap.add_argument("--data_path", type=str, default=None,
                    help="existing prepared dataset; default: generate a "
                         "synthetic split")
    ap.add_argument("--model", type=str, default="random",
                    help="the eval app's --model: pass a converged "
                         "checkpoint to measure deltas on trained weights "
                         "(static calibration is range-sensitive)")
    ap.add_argument("--modes", type=str, default=None,
                    help="comma-separated substrings; run only matching "
                         "MODES rows (fp always runs: it is the delta base)")
    ap.add_argument("--fused_bottleneck", action="store_true",
                    help="the bf16 row with the fused bottleneck at layer1")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    modes = MODES
    if args.modes:
        pats = [p.strip() for p in args.modes.split(",")]
        modes = [MODES[0]] + [
            m for m in MODES[1:] if any(p in m[0] for p in pats)]
    if args.fused_bottleneck:
        modes = [(name, extra + ["--fused_bottleneck"]
                  if "--dtype" in extra else extra) for name, extra in modes]

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = args.data_path
        if data_dir is None:
            from dir_tpu_torch.data import synthetic
            from dir_tpu_torch.mano.assets import (fix_left_shapedirs,
                                                   synthetic_mano)
            right = synthetic_mano("right", seed=0)
            left = fix_left_shapedirs(synthetic_mano("left", seed=0), right)
            data_dir = os.path.join(tmp, "data")
            synthetic.generate(data_dir, left, right, split="test",
                               num_samples=args.samples)

        model = (random_checkpoint(tmp, args.backbone_layers)
                 if args.model == "random" else args.model)
        rows = []
        for name, extra in modes:
            s = run_mode(data_dir, os.path.join(tmp, "out"), extra,
                         args.bs, args.backbone_layers, model=model,
                         device=args.device)
            rows.append((name, s))
            print(f"done: {name}: joint {s['joint_mean_all_mm']:.4f} mm",
                  file=sys.stderr, flush=True)

    base = rows[0][1]
    print(f"{'mode':32s} " + " ".join(f"{k:>22s}" for k in KEYS))
    for name, s in rows:
        print(f"{name:32s} " + " ".join(f"{s[k]:>22.4f}" for k in KEYS))
    print()
    print(f"{'mode':32s} " + " ".join(f"{'d_' + k:>22s}" for k in KEYS))
    for name, s in rows[1:]:
        print(f"{name:32s} " + " ".join(
            f"{s[k] - base[k]:>+22.4f}" for k in KEYS))
    print("TABLE " + json.dumps({name: s for name, s in rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
