"""A run with its timed path broken underneath must come out not correct,
and so must the control, at sizes a test run holds.

The CPU tests drive each cell's driver at ``tiny_config()`` widths (the
port's plain kernels), skipping only the look for a card, with one fault
planted where the output is produced: an answer altered (one scene's boxes
moved), half of the batch left out (its rows answered by the other half's,
or a step on half the rows), a step that leaves the state unchanged. The
cell's own limits judge them. The control (the reference one precision
below the configuration's) is read at the tiny widths on the CPU for the
mixed cell and on the card for the float32 cell, where TF32 exists.

Run: ``python -m pytest portbench/tests -q`` (``-m gpu`` on the card).
"""

import dataclasses
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.yardstick.compare import judge  # noqa: E402

CPU = torch.device("cpu")


def lst(v):
    return [lst(x) for x in v] if isinstance(v, tuple) else v


# (configuration, traffic) of each cell of BENCHMARK.json
CELLS = {"eval_f32_b64": ("votenet_sunrgbd_f32", "eval_b64_cache1024"),
         "train_mixed_b32": ("votenet_sunrgbd_mixed", "train_b32_pool8")}


def cell_of(name):
    conf, traffic = CELLS[name]
    files = harness.BENCH
    return harness.Cell({"name": name, "config": conf, "traffic": traffic, "chips": 1},
                        harness.load_json(files / "configs" / f"{conf}.json"),
                        harness.load_json(files / "traffic" / f"{traffic}.json"),
                        harness.load_json(files / "limits" / f"{name}.json"),
                        harness.load_json(harness.ROOT / "BENCHMARK.json"))


def tiny(name, **traffic):
    """The cell at ``tiny_config()``'s widths with seeded weights."""
    from votenet_tpu_torch.config import tiny_config

    cell = cell_of(name)
    t = tiny_config()
    model = {k: lst(getattr(t, k)) for k in cell.model}
    model.update(max_detections=t.proposal_num, mixed_precision=cell.model["mixed_precision"])
    return dataclasses.replace(cell, config=dict(cell.config, config=model),
                               traffic=dict(cell.traffic, weights="seeded", **traffic))


def run(cell, control=None, seed=2 ** 31 + 77):
    args = types.SimpleNamespace(seed=seed, seconds=0.01, trace=0)
    obs = harness.import_driver(cell.traffic["entry"]).run(cell, args, 0.0, CPU, control=control)
    return judge(obs["numbers"], cell.limits)[0], obs["numbers"]


EVAL = dict(batch=4, scenes=8)
TRAIN = dict(batch=4, pool=5)


def moved(out):
    """One scene's boxes moved by 5 cm where the forward hands them over."""
    out = dict(out)
    key = "packed" if "packed" in out else "bboxes"
    t = out[key].clone()
    if key == "packed":
        t[0, :, :24] += 0.05
    else:
        t[0] += 0.05
    out[key] = t
    return out


def half(out):
    """The batch's second half answered with the first half's rows."""
    out = {k: v.clone() for k, v in out.items()}
    for v in out.values():
        n = v.shape[0] // 2
        v[n:2 * n] = v[:n]
    return out


def test_sound_detections_pass():
    ok, numbers = run(tiny("eval_f32_b64", **EVAL))
    assert ok, numbers


@pytest.mark.parametrize("fault", [moved, half], ids=["answer_altered", "half_batch"])
def test_eval_faults_are_not_correct(fault):
    ok, numbers = run(tiny("eval_f32_b64", **EVAL), control=lambda predict: (lambda pts: fault(predict(pts))))
    assert not ok, numbers


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_are_not_correct(fault):
    B = TRAIN["batch"]
    control = {"break_step": True} if fault == "state_unchanged" else \
        {"break_batch": lambda b: {k: v[:B // 2] for k, v in b.items()}}
    ok, numbers = run(tiny("train_mixed_b32", **TRAIN), control=control)
    assert not ok, numbers


def test_the_mixed_control_is_not_correct():
    from portbench.control import control_training

    cell = tiny("train_mixed_b32", **TRAIN)
    for seed in (1, 2, 3):
        ok, _ = judge(control_training(cell, seed, CPU), cell.limits)
        assert not ok


@pytest.mark.gpu
def test_the_float32_control_is_not_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32, the float32 cell's control, exists only on the card")
    from portbench.control import control_detections

    cell = cell_of("eval_f32_b64")
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, scenes=cell.traffic["batch"]))  # what a run checks
    dev = torch.device("cuda")
    for seed in (1, 2, 3):
        nums = control_detections(cell, seed, dev)
        assert not judge(nums, cell.limits)[0], nums
