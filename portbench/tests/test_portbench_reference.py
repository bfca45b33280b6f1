"""The benchmark's plain reference against the port, on the CPU at
``tiny_config()`` with seeded weights: the eval forward, the head's boxes and
keep mask, one training step's loss and gradients and the step's Adam
update, within the port's own test tolerances (``chip_smoke.py``:
``REL_TOL`` 1e-4 of scale on a forward, ``GRAD_TOL`` 5e-3 of scale on a
gradient).

Run: ``python -m pytest portbench/tests -q``.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.reference import head_ref, votenet_ref  # noqa: E402
from portbench.reference.weights import seeded_weights  # noqa: E402
from portbench.yardstick.scenes import labels, make_scenes  # noqa: E402

REL_TOL = 1e-4
GRAD_TOL = 5e-3


def lst(v):
    return [lst(x) for x in v] if isinstance(v, tuple) else v


@pytest.fixture(scope="module")
def tiny():
    from votenet_tpu_torch.config import tiny_config

    t = tiny_config()
    keys = [k for k in t.__dataclass_fields__ if k not in ("data_root", "cache_dir", "train_idx_range",
                                                           "val_idx_range", "mesh_shape", "mesh_axis_names")]
    cfg = {k: lst(getattr(t, k)) for k in keys}
    cfg["max_detections"] = t.proposal_num
    return t, cfg


def scale_gap(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def port_model(t, sd, **over):
    from votenet_tpu_torch.models.votenet import VoteNet

    m = VoteNet(t.replace(**over))
    m.load_state_dict(sd)
    return m


def data(cfg, seed, n):
    sc = make_scenes(seed, n, cfg, torch.device("cpu"))
    return sc, labels(sc, cfg)


F32 = {k: "float32" for k in ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2", "voting", "proposal")}


def test_eval_forward_and_head_match_the_port(tiny):
    from votenet_tpu_torch.models.decode import predict_boxes

    t, cfg = tiny
    sd = seeded_weights(3, cfg, torch.device("cpu"))
    sd = {k: (v + 0.1 * torch.rand(v.shape, generator=torch.Generator().manual_seed(1)) if "running" in k else v)
          for k, v in sd.items()}  # running statistics away from 0 and 1
    sc, _ = data(cfg, 5, 4)
    model = port_model(t, sd)
    with torch.no_grad():
        want = model(sc["points"])
        got = votenet_ref.eval_forward(sd, sc["points"], cfg, votenet_ref.Precision(F32))
    assert torch.equal(got["seeds_xyz"], want["seeds_xyz"])
    for k in ("votes_xyz", "proposals_xyz", "proposals_output"):
        assert scale_gap(got[k], want[k]) < REL_TOL, k
    mine = head_ref.predict(got, cfg)
    port = predict_boxes(want, t)
    assert torch.equal(mine["keep"], port["keep"])
    assert scale_gap(mine["bboxes"], port["bboxes"]) < REL_TOL
    assert torch.equal(mine["class"], torch.argmax(port["class_scores"], -1))


def test_a_training_step_matches_the_port(tiny):
    from votenet_tpu_torch.train.loop import Trainer
    from votenet_tpu_torch.train.state import create_train_state

    t, cfg = tiny
    sd = seeded_weights(4, cfg, torch.device("cpu"))
    sc, lab = data(cfg, 6, 4)
    batch = dict(lab, points=sc["points"].numpy())
    state = create_train_state(t, steps_per_epoch=10 ** 6, device="cpu")
    state.model.load_state_dict(sd)
    trainer = Trainer(t, state)
    start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    trainer.train_epoch([batch])
    params = {k: v.clone() for k, v in sd.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses, first, change = votenet_ref.train_steps(params, [tb], cfg, votenet_ref.Precision(F32), 1)
    assert losses[0] == pytest.approx(trainer.logger.moving.buffers["total_cost"][-1], rel=1e-5)
    norms = votenet_ref.leaf_norms(first)
    median = sorted(norms.values())[len(norms) // 2]
    for n, p in state.model.named_parameters():
        g = state.optimizer.state[p]["exp_avg"] / 0.1  # Adam's first moment after one step: 0.1 of the gradient
        assert scale_gap(g, first[n]) < GRAD_TOL, n
        if norms[n] < 1e-3 * median:  # a dense bias ahead of batch norm: its gradient is rounding
            continue
        # the update, lr * sign(g), where the gradient is well above rounding
        big = first[n].abs() > 1e-3 * first[n].abs().max()
        assert scale_gap((p.detach() - start[n])[big], change[n][big]) < 1e-6, n


def test_the_mixed_reference_rounds_where_the_port_does(tiny):
    t, cfg = tiny
    sd = seeded_weights(4, cfg, torch.device("cpu"))
    sc, _ = data(cfg, 6, 4)
    mixed = dict(F32, sa2="bfloat16", sa3="bfloat16", sa4="bfloat16")
    model = port_model(t, sd, mixed_precision=True)
    with torch.no_grad():
        want = model(sc["points"])
        got = votenet_ref.eval_forward(sd, sc["points"], cfg, votenet_ref.Precision(mixed))
        f32 = votenet_ref.eval_forward(sd, sc["points"], cfg, votenet_ref.Precision(F32))
        fp8 = votenet_ref.eval_forward(sd, sc["points"], cfg, votenet_ref.Precision(mixed, low="fp8"))
    assert torch.equal(got["seeds_xyz"], want["seeds_xyz"])
    gap = scale_gap(got["votes_xyz"], want["votes_xyz"])
    # bf16 rounding at the same points: closer to the port than f32 and fp8 are
    assert gap < 0.5 * scale_gap(f32["votes_xyz"], want["votes_xyz"])
    assert gap < 0.2 * scale_gap(fp8["votes_xyz"], want["votes_xyz"])
