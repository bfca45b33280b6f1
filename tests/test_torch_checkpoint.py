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
