"""What decides ``correct``: the plain reference agrees with the program
at float32; the control (the reference in float8 in the program's place)
breaks the limits; and each fault a cell can have, planted in the timed
path, makes ``correct`` false."""

import copy

import numpy as np
import pytest
import torch

from portbench import build
from portbench.calibrate import control_infer, control_trainer
from portbench.reference import compare
from portbench.tests import tiny


def test_reference_agrees_with_the_program_at_fp32():
    torch.set_num_threads(4)
    for name in ("dir_r50_a", "dir_r50_b"):
        cfg = dict(build.read_json(f"portbench/configs/{name}.json"),
                   backbone_layers=[1, 1, 1, 1], image_size=64)
        ref, hands, pair = build.seeded_reference(cfg, 12345, "cpu")
        model, _ = build.program_model(cfg, ref.state_dict(), "cpu",
                                       dtype="float32")
        ml, mr = build.program_mano(hands, "cpu")
        img = torch.randn(3, 64, 64, 3, generator=torch.Generator()
                          .manual_seed(0))
        with torch.no_grad():
            got = model(img, ml, mr)
        want = compare.reference_outputs(ref, pair, img)
        n = compare.serving_numbers(got, want)
        assert max(n[f"mm.s{i}"] for i in range(3)) < 1e-3
        assert n["seg_flip"] == 0.0 and n["dense_rel"] < 1e-5


@pytest.mark.parametrize("w", ["a_eval_b1024"])
def test_control_breaks_the_limits(w):
    assert tiny.tiny_run(w, infer_fault=control_infer)["correct"] is False


def test_training_control_breaks_the_limits():
    line = tiny.tiny_run("b_train_b64", trainer_fault=control_trainer)
    assert line["correct"] is False


def _alter_one_answer(infer, ref, pair):
    """A fault: one image's answer is altered where it is produced."""
    def call(img):
        out = infer(img)
        out = dict(out, stages=[dict(s) for s in out["stages"]])
        last = out["stages"][-1]
        for k in compare.POINTS:
            moved = last[k].clone()
            moved[0] += 0.005             # 5 mm
            last[k] = moved
        return out
    return call


@pytest.mark.parametrize("w", ["a_eval_b1024"])
def test_an_altered_answer_is_not_correct(w):
    assert tiny.tiny_run(w)["correct"] is True
    assert tiny.tiny_run(w, infer_fault=_alter_one_answer)["correct"] is False


def _double_three_leaves(run, start, hands, ref, pair):
    """A fault: the update of three leaves applied twice, every step."""
    from portbench.drivers.train import ProgramTrainer

    prog = ProgramTrainer(run, start, hands)
    step = prog.step
    leaves = [p for _, p in prog.model.named_parameters()][:3]

    def doubled(batch):
        before = [p.detach().clone() for p in leaves]
        loss = step(batch)
        with torch.no_grad():
            for p, b in zip(leaves, before):
                p.add_(p - b)
        return loss

    prog.step = doubled
    return prog


@pytest.mark.parametrize("fault", [{"frozen": True}, {"half_batch": True},
                                   _double_three_leaves])
def test_a_broken_train_step_is_not_correct(fault):
    line = tiny.tiny_run("b_train_b64", trainer_fault=fault)
    assert line["correct"] is False
