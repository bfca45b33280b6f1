"""Parity of the port's model (votenet_tpu_torch.models) with the JAX model.

``tiny_config()`` widths; the flax modules are initialised by flax, their
batch-norm parameters and statistics replaced with seeded random values (so
eval batch norm is not the identity), and the same variables are passed
through ``convert_flax_variables`` into the port. Both run on the CPU, JAX
through its XLA twins.

Tolerance: integer end points (indices, classes, keep masks) and gathered
coordinates must be equal. Floats must agree to 2e-5 of the tensor's scale:
the two frameworks' f32 matmuls sum in different orders and XLA on the CPU
fuses multiply-adds, which moves each layer's output by ~1e-6 of its scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from votenet_tpu.config import tiny_config
from votenet_tpu.data.synthetic import synthetic_scenes
from votenet_tpu_torch.models import VoteNet, check_supported, convert_flax_variables, predict_boxes
from votenet_tpu_torch.models.pointnet2 import PointNetFPModule, PointNetSAModule
from votenet_tpu_torch.models.votenet import VotingModule

REL = 2e-5


def close(got, want, rel=REL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def randomize_bn(variables, seed=1):
    """Replace batch-norm leaves with seeded random values."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name, parent = path[-1].key, path[-2].key
        x = np.asarray(x)
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.2, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias" and "bn" in parent:
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, variables)


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def points(cfg):
    return np.stack([s["points"] for s in synthetic_scenes(0, cfg, 2)])


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- modules

@pytest.mark.parametrize("layer", ["sa1", "sa2"])
def test_sa_backbone_layer(cfg, points, layer):
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    i = int(layer[-1]) - 1
    rng = np.random.RandomState(10 + i)
    n_in = cfg.point_num if i == 0 else cfg.sa_npoints[i - 1]
    xyz = points[:, :n_in]
    feats = xyz if i == 0 else rng.randn(2, n_in, cfg.sa_mlps[i - 1][-1]).astype(np.float32)
    kw = dict(npoint=cfg.sa_npoints[i], radius=cfg.sa_radii[i], nsample=cfg.sa_nsamples[i], mlp=cfg.sa_mlps[i])
    jm = JaxSA(coord_grad=False, **kw)
    v = randomize_bn(jm.init(jax.random.PRNGKey(i), xyz, feats, False))
    jx, jf, jidx = jm.apply(v, xyz, feats, False)

    pm = PointNetSAModule(kw["npoint"], kw["radius"], kw["nsample"], feats.shape[-1], kw["mlp"],
                          torch.Generator().manual_seed(0))
    convert_flax_variables(v, pm)
    with torch.no_grad():
        px, pf, pidx = pm(t(xyz), t(feats))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    close(pf, jf)


def test_sa_proposal_layer_with_sample_xyz_and_head(cfg, points):
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    rng = np.random.RandomState(20)
    seeds = points[:, : cfg.sa_npoints[1]]
    votes = (seeds + rng.normal(0, 0.1, seeds.shape)).astype(np.float32)
    feats = rng.randn(*seeds.shape[:2], cfg.fp_mlps[1][-1]).astype(np.float32)
    mlp2 = tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,)
    jm = JaxSA(npoint=cfg.proposal_num, radius=cfg.proposal_radius, nsample=cfg.proposal_nsample,
               mlp=cfg.proposal_mlp, mlp2=mlp2)
    v = randomize_bn(jm.init(jax.random.PRNGKey(3), votes, feats, False, sample_xyz=seeds))
    jx, jf, jidx = jm.apply(v, votes, feats, False, sample_xyz=seeds)

    pm = PointNetSAModule(cfg.proposal_num, cfg.proposal_radius, cfg.proposal_nsample, feats.shape[-1],
                          cfg.proposal_mlp, torch.Generator().manual_seed(0), mlp2=mlp2)
    convert_flax_variables(v, pm)
    with torch.no_grad():
        px, pf, pidx = pm(t(votes), t(feats), sample_xyz=t(seeds))
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    assert pf.shape[-1] == cfg.num_proposal_channels
    close(pf, jf)


def test_fp_module(cfg, points):
    from votenet_tpu.models.pointnet2 import PointNetFPModule as JaxFP

    rng = np.random.RandomState(30)
    xyz1, xyz2 = points[:, :64], points[:, 64:96]
    p1 = rng.randn(2, 64, 24).astype(np.float32)
    p2 = rng.randn(2, 32, 40).astype(np.float32)
    jm = JaxFP(mlp=(48, 32))
    v = randomize_bn(jm.init(jax.random.PRNGKey(4), xyz1, xyz2, p1, p2, False))
    want = jm.apply(v, xyz1, xyz2, p1, p2, False)
    pm = PointNetFPModule(64, (48, 32), torch.Generator().manual_seed(0))
    convert_flax_variables(v, pm)
    with torch.no_grad():
        close(pm(t(xyz1), t(xyz2), t(p1), t(p2)), want)


def test_voting_module(cfg):
    from votenet_tpu.models.votenet import VotingModule as JaxVoting

    seeds = np.random.RandomState(40).randn(2, 32, 67).astype(np.float32)
    jm = JaxVoting(units=tuple(cfg.vote_units))
    v = randomize_bn(jm.init(jax.random.PRNGKey(5), seeds, False))
    want = jm.apply(v, seeds, False)
    pm = VotingModule(67, cfg.vote_units, torch.Generator().manual_seed(0), cfg.bn_eps)
    convert_flax_variables(v, pm)
    with torch.no_grad():
        close(pm(t(seeds)), want)


# ------------------------------------------------------------ whole model

@pytest.fixture(scope="module")
def both_models(cfg, points):
    from votenet_tpu.models.decode import predict_boxes as jax_predict
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet

    jm = JaxVoteNet(cfg)
    v = randomize_bn(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(points))))
    # raise the objectness logit so that NMS has candidates to keep and suppress
    head = v["params"]["proposal"]["mlp2"]["dense2"]
    head["bias"] = np.array(head["bias"]) + np.eye(1, head["bias"].shape[0], 1, dtype=np.float32)[0] * 3.0
    je = jm.apply(v, points, train=False)
    jp = jax_predict(je, cfg)
    pm = VoteNet(cfg)
    convert_flax_variables(v, pm)
    with torch.no_grad():
        pe = pm(t(points))
        pp = predict_boxes(pe, cfg)
    return v, je, jp, pe, pp


def test_votenet_end_points(both_models):
    _, je, _, pe, _ = both_models
    assert sorted(pe) == sorted(je)
    np.testing.assert_array_equal(pe["seeds_xyz"].numpy(), np.asarray(je["seeds_xyz"]))
    for k in je:
        close(pe[k], je[k])


def test_votenet_predict_boxes(both_models):
    _, _, jp, _, pp = both_models
    for k in ("size_cls", "heading_cls", "keep"):
        assert pp[k].dtype == {"keep": torch.bool}.get(k, torch.int32)
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
    for k in ("bboxes", "class_scores", "objectness", "nms_scores", "center_pred", "size_pred", "heading_pred"):
        close(pp[k], jp[k])
    assert pp["keep"].any()


def test_max_detections_cap(both_models, cfg):
    from votenet_tpu.models.decode import predict_boxes as jax_predict

    _, je, _, pe, _ = both_models
    capped = cfg.replace(max_detections=3)
    keep = predict_boxes(pe, capped)["keep"]
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jax_predict(je, capped)["keep"]))
    assert int(keep.sum(-1).max()) <= 3


def test_predictor_matches_jax_predictor(both_models, cfg, points):
    from votenet_tpu.predictor import VoteNetPredictor as JaxPredictor
    from votenet_tpu_torch.predictor import VoteNetPredictor

    v = both_models[0]
    jpred = JaxPredictor(cfg, variables=v, batch_size=2)
    ppred = VoteNetPredictor(cfg, convert_flax_variables(v), device="cpu", batch_size=2)
    scenes = [points[0], points[1], points[0]]  # 3 scenes: the second chunk is padded
    want, got = jpred.detect_batch(list(scenes)), ppred.detect_batch(list(scenes))
    assert len(got) == len(want) == 3
    for gs, ws in zip(got, want):
        assert [d[0] for d in gs] == [d[0] for d in ws]
        for (_, gc, gscore), (_, wc, wscore) in zip(gs, ws):
            close(gc, wc)
            assert gscore == pytest.approx(wscore, rel=REL, abs=REL)
    single = ppred.detect(points[1])
    assert [d[0] for d in single] == [d[0] for d in want[1]]
    raw = ppred(points)
    assert raw["keep"].dtype == torch.bool and tuple(raw["bboxes"].shape) == (2, cfg.proposal_num, 8, 3)
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


# ---------------------------------------------------- conversion and scope

def test_convert_rejects_leftover_missing_and_misshaped_leaves(both_models, cfg):
    v = both_models[0]
    model = VoteNet(cfg)
    extra = {"params": {**v["params"], "stray": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="left over"):
        convert_flax_variables(extra, model)
    missing = {"params": {k: p for k, p in v["params"].items() if k != "fp1"}, "batch_stats": v["batch_stats"]}
    with pytest.raises(ValueError, match="missing"):
        convert_flax_variables(missing, model)
    odd = {"params": {"sa1": {"mlp": {"dense0": {"weird": np.zeros(3)}}}}}
    with pytest.raises(ValueError, match="cannot convert"):
        convert_flax_variables(odd)
    bad = jax.tree_util.tree_map(lambda x: x, v)
    bad["params"]["fp1"]["mlp"]["dense1"]["kernel"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert_flax_variables(bad, model)


def test_convert_transposes_kernels(both_models):
    v = both_models[0]
    sd = convert_flax_variables(v)
    np.testing.assert_array_equal(sd["sa1.mlp.dense0.weight"].numpy(), np.asarray(v["params"]["sa1"]["mlp"]["dense0"]["kernel"]).T)
    np.testing.assert_array_equal(sd["voting.voting0_bn.running_var"].numpy(), np.asarray(v["batch_stats"]["voting"]["voting0_bn"]["var"]))
    np.testing.assert_array_equal(sd["proposal.mlp2.dense2.bias"].numpy(), np.asarray(v["params"]["proposal"]["mlp2"]["dense2"]["bias"]))


@pytest.mark.parametrize(
    "override",
    [dict(compute_dtype="bfloat16"), dict(mixed_precision=True), dict(bq_precision="fast_bf16"), dict(samlp="on")],
)
def test_unsupported_modes_raise(cfg, override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_supported(cfg.replace(**override))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VoteNet(cfg.replace(**override))


def test_training_mode_raises(cfg):
    model = VoteNet(cfg)
    assert not model.training
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.train()
    model.eval()  # switching to eval stays allowed


def test_init_is_seeded_by_the_generator(cfg):
    a = VoteNet(cfg, torch.Generator().manual_seed(3)).state_dict()
    b = VoteNet(cfg, torch.Generator().manual_seed(3)).state_dict()
    c = VoteNet(cfg, torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sa1.mlp.dense0.weight"], c["sa1.mlp.dense0.weight"])
    w = a["sa2.mlp.dense1.weight"]  # he-normal: std sqrt(2 / fan_in), cut at 2 std
    assert float(w.abs().max()) <= 2 * (2 / w.shape[1]) ** 0.5 / 0.87962566 + 1e-6
    assert float(w.std()) == pytest.approx((2 / w.shape[1]) ** 0.5, rel=0.1)


def test_entry_full_width_on_cpu():
    from votenet_tpu_torch.entry import entry

    forward, (points,) = entry("cpu")
    assert tuple(points.shape) == (1, 20480, 3)
    bboxes, class_scores, keep = forward(points)
    assert tuple(bboxes.shape) == (1, 256, 8, 3) and tuple(class_scores.shape) == (1, 256, 10)
    assert tuple(keep.shape) == (1, 256) and keep.dtype == torch.bool
    assert torch.isfinite(bboxes).all() and torch.isfinite(class_scores).all()
