"""The port against the JAX package on the committed trained model.

``.scratch/r4_heldout/checkpoint_0000000081.msgpack`` (full SUN RGB-D
widths, 20480 points) is read with ``flax.serialization.msgpack_restore``,
its ``params``/``batch_stats`` converted with ``convert_flax_variables``, and
2 synthetic scenes go through ``__graft_entry__``-style JAX inference
(``VoteNet.apply`` + ``predict_boxes``, jitted, on the CPU) and through the
port on the CPU.

Tolerance: FPS indices and everything gathered from the input cloud
(seeds_xyz) must be equal, and so must the classes and the NMS keep mask.
Floats must agree to 2e-5 of each tensor's scale: the f32 matmuls of the two
frameworks sum in different orders and XLA on the CPU fuses multiply-adds,
~1e-6 of the scale per layer over ~15 layers (measured: <= 1.5e-6).

One training step at B=2 from the checkpoint's ``params``, ``batch_stats``
and ``opt_state`` (``convert_flax_opt_state``; 512 steps an epoch, so step
41472 runs at lr 1e-4) goes through the JAX ``make_train_step`` and the
port's: losses, masks and assignments, gradients and updates are held as in
``tests/test_torch_train.py``.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from votenet_tpu.config import default_config
from votenet_tpu.data.synthetic import synthetic_scenes
from votenet_tpu_torch import ops
from votenet_tpu_torch.models import VoteNet, convert_flax_variables, predict_boxes

CKPT = Path(__file__).resolve().parents[1] / ".scratch" / "r4_heldout" / "checkpoint_0000000081.msgpack"
REL = 2e-5


def close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def run():
    from flax.serialization import msgpack_restore

    from votenet_tpu.models.decode import predict_boxes as jax_predict
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet

    cfg = default_config()
    tree = msgpack_restore(CKPT.read_bytes())
    variables = {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    points = np.stack([s["points"] for s in synthetic_scenes(0, cfg, 2)])

    jm = JaxVoteNet(cfg)

    @jax.jit
    def jax_forward(p):
        end_points = jm.apply(variables, p, train=False)
        return end_points, jax_predict(end_points, cfg)

    je, jp = jax.tree_util.tree_map(np.array, jax_forward(points))
    model = VoteNet(cfg)
    convert_flax_variables(variables, model)
    with torch.no_grad():
        pe = model(torch.from_numpy(points))
        pp = predict_boxes(pe, cfg)
    return cfg, model, je, jp, pe, pp


def test_checkpoint_end_points(run):
    _, _, je, _, pe, _ = run
    np.testing.assert_array_equal(pe["seeds_xyz"].numpy(), je["seeds_xyz"])
    for k in je:
        close(pe[k], je[k])


def test_checkpoint_boxes_and_keep(run):
    _, _, _, jp, _, pp = run
    for k in ("size_cls", "heading_cls", "keep"):
        np.testing.assert_array_equal(pp[k].numpy(), jp[k])
    for k in ("bboxes", "class_scores", "objectness", "nms_scores"):
        close(pp[k], jp[k])
    # the trained model detects, and NMS suppresses some candidates
    n_cand = int((jp["objectness"][..., 1] > jp["objectness"][..., 0]).sum())
    assert 0 < int(pp["keep"].sum()) < n_cand


def test_checkpoint_proposal_layer_on_jax_votes(run):
    """The proposal layer is the one place a vote a few ulps off could move
    a point across a ball boundary between the frameworks. Fed JAX's own
    votes, the port's proposal module must agree with JAX's output, and its
    ball query with JAX's; and on these scenes no slot flips between the two
    frameworks' votes."""
    from votenet_tpu.ops.grouping import _query_ball_point_dense

    cfg, model, je, _, pe, _ = run
    with torch.no_grad():
        _, out, idx = model.proposal(
            torch.from_numpy(je["votes_xyz"]), torch.from_numpy(je["votes_points"]),
            sample_xyz=torch.from_numpy(je["seeds_xyz"]),
        )
    close(out, je["proposals_output"])
    # JAX's proposal centres are gathered votes, exact copies
    jax_idx, _ = _query_ball_point_dense(
        cfg.proposal_radius, cfg.proposal_nsample, "exact", je["votes_xyz"], je["proposals_xyz"]
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_idx))

    fps = ops.farthest_point_sample(cfg.proposal_num, pe["seeds_xyz"])
    own_idx, _ = ops.query_ball_point(
        cfg.proposal_radius, cfg.proposal_nsample, pe["votes_xyz"], ops.gather_point(pe["votes_xyz"], fps)
    )
    assert int((own_idx != idx).sum()) == 0


@pytest.fixture(scope="module")
def train_step_run():
    import copy

    from flax.serialization import from_state_dict, msgpack_restore

    from tests.test_torch_train import jax_step_and_grads
    from votenet_tpu.data.dataflow import batch_scenes
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet
    from votenet_tpu.train.optimizer import make_optimizer
    from votenet_tpu.train.state import TrainState
    from votenet_tpu_torch.models import convert_flax_opt_state
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step

    cfg = default_config()
    tree = msgpack_restore(CKPT.read_bytes())
    jstate = TrainState.create(
        apply_fn=JaxVoteNet(cfg).apply, params=tree["params"], batch_stats=tree["batch_stats"],
        tx=make_optimizer(cfg, 512),
    )
    jstate = jstate.replace(step=int(tree["step"]), opt_state=from_state_dict(jstate.opt_state, tree["opt_state"]))
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    jgrads, jep, jparams, jstats, jmetrics = jax_step_and_grads(cfg, jstate, batch, "reference")

    state = create_train_state(cfg, 512)
    convert_flax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, state.model)
    state.step = convert_flax_opt_state(tree["opt_state"], state.model, state.optimizer)
    old = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    probe = copy.deepcopy(state.model)
    forward_backward(probe, batch, cfg)
    grads = {k: v.grad.detach().clone() for k, v in probe.named_parameters()}
    probe = copy.deepcopy(state.model).train()
    with torch.no_grad():
        pep = probe(torch.from_numpy(batch["points"]))
    metrics = make_train_step(cfg)(state, batch)
    return dict(cfg=cfg, batch=batch, state=state, old=old, grads=grads, pep=pep, metrics=metrics,
                jgrads=jgrads, jep=jep, jparams=jparams, jstats=jstats, jmetrics=jmetrics)


def test_checkpoint_train_step_losses_and_assignments(train_step_run):
    """Losses to 2e-5 of scale (the full-width step is closer than the tiny
    one: trained batch norm has no near-degenerate channels); masks and
    assignments equal; the trained model has positives to learn from."""
    from tests.test_torch_train import assignment_masks

    r = train_step_run
    assert r["state"].step == 41473
    for k in r["metrics"]:
        np.testing.assert_allclose(float(r["metrics"][k]), float(r["jmetrics"][k]), rtol=0,
                                   atol=2e-5 * max(1.0, abs(float(r["jmetrics"][k]))))
    ours = assignment_masks({k: v.numpy() for k, v in r["pep"].items()}, r["batch"], r["cfg"])
    theirs = assignment_masks(r["jep"], r["batch"], r["cfg"])
    assert ours["positive"].sum() > 50
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_checkpoint_train_step_gradients_and_updates(train_step_run):
    """Gradients norm-wise per leaf; parameters after the step with Adam's
    moments carried over (lr 1e-4; see ``check_update``); running statistics
    to 2e-5 of scale. With moments carried, a gradient gap δg moves an update
    by lr * 0.1 δg / sqrt(v), and on a live element δg < |g| / 100 while
    |g| / sqrt(v) can pass 1: hence 1e-2 lr (measured 1.3e-3 lr)."""
    from tests.test_torch_train import check_grads, check_update, jax_leaf

    r = train_step_run
    probe = copy_with_grads(r["state"].model, r["grads"])
    check_grads(probe, r["jgrads"])
    assert r["state"].schedule(41472) == pytest.approx(1e-4, rel=1e-6)
    check_update(r["state"].model, r["old"], r["grads"], r["jparams"], r["jgrads"], lr=1e-4, tight=1e-2)
    for name, buf in r["state"].model.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        want = jax_leaf(r["jstats"], "/".join(mod.split(".") + ["mean" if leaf == "running_mean" else "var"]))
        close(buf, want)


def copy_with_grads(model, grads):
    import copy

    probe = copy.deepcopy(model)
    for name, p in probe.named_parameters():
        p.grad = grads[name]
    return probe
