"""Group-Free 3D on the port (``models/groupfree.py``) against the benchmark's
plain reference (``portbench/reference/groupfree_ref.py``), on the CPU at
``tiny_groupfree_config()``'s widths with seeded weights (the benchmark's
convention, ``portbench/reference/groupfree_weights.py``; batch-norm
statistics and biases then drawn away from 0 and 1 so that every affine
step shows).

Tolerances: floats within 1e-4 of the tensor's scale (the benchmark's
reference test's ``REL_TOL``): the port sums its products in other orders
than the reference (the SA layers project before they gather, the keys and
values come from one product, batch norm adds the dense bias in its
prologue), and a difference grows through the post-norm layers and the
heads; the attention alone within 1e-5 of scale (the same formula, the
batched product against the reference's head by head). Integer end points
(the sampled seeds, the keep mask) are equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.reference import groupfree_ref as R
from portbench.reference import head_ref
from portbench.reference.groupfree_weights import seeded_weights
from votenet_tpu_torch import ops
from votenet_tpu_torch.models.decode import predict_boxes
from votenet_tpu_torch.models.groupfree import (
    DecoderLayer,
    GroupFree3D,
    MultiheadAttention,
    groupfree_config,
    tiny_groupfree_config,
)
from votenet_tpu_torch.models.pointnet2 import PointNetSAModule
from votenet_tpu_torch.ops.cuda import attention as attention_mod

REL = 1e-4


def close(got, want, rel=REL):
    got, want = got.detach().double(), want.detach().double()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= rel * max(1.0, float(want.abs().max()))


def flat(gcfg):
    """The configuration file's flat dict of a ``GroupFreeConfig``."""
    def lst(v):
        return [lst(x) for x in v] if isinstance(v, tuple) else v

    out = {k: lst(v) for k, v in dataclasses.asdict(gcfg.base).items()}
    out.update({k: v for k, v in dataclasses.asdict(gcfg).items() if k != "base"})
    return out


def weights(cfg, seed):
    """Seeded weights, with the batch norms' statistics, scales and the
    biases drawn too."""
    sd = seeded_weights(seed, cfg, "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=g)
        elif k.endswith(("running_mean", "bias")):
            sd[k] = 0.2 * torch.randn(v.shape, generator=g)
        elif v.dim() == 1:  # batch-norm and LayerNorm scales
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
    return sd


def cloud(B, N, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(B, N, 3, generator=g) * torch.tensor([6.0, 3.0, 6.0]) - torch.tensor([3.0, 1.0, 0.0])
    return torch.cat([xyz, xyz[..., 1:2] + 1.0], dim=-1)


@pytest.fixture(scope="module")
def tiny():
    gcfg = tiny_groupfree_config(num_layers=3)
    cfg = flat(gcfg)
    sd = weights(cfg, 8)  # about half the proposals candidates (objectness > 0)
    model = GroupFree3D(gcfg)
    model.load_state_dict(sd, strict=True)
    points = cloud(2, gcfg.base.point_num, 9)
    with torch.no_grad():
        ep = model(points)
    return gcfg, cfg, sd, model, points, ep, R.eval_forward(sd, points, cfg)


# ---------------------------------------------------------------- attention

@pytest.mark.parametrize("Lq, Lk", [(13, 1), (16, 7), (16, 77), (5, 1000)])
def test_attention_matches_the_reference_head_by_head(Lq, Lk):
    """The port's attention (the op's plain version on the CPU) at key counts
    that are no multiple of the kernel's tiles (64) or chunks (16)."""
    d, nhead = 48, 4
    g = torch.Generator().manual_seed(Lk)
    m = MultiheadAttention(d, nhead, g)
    with torch.no_grad():
        m.in_proj_bias.normal_(0.0, 0.1, generator=g)
    P = {f"a.{k}": v for k, v in m.state_dict().items()}
    query, key = torch.randn(2, Lq, d, generator=g), torch.randn(2, Lk, d, generator=g)
    with torch.no_grad():
        close(m(query, key), R.attention(P, "a", query, key, nhead), rel=1e-5)
        close(m(query, query), R.attention(P, "a", query, query, nhead), rel=1e-5)


def test_attention_takes_strided_views_and_launches_no_kernel_on_the_cpu():
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 9, 3 * 72, generator=g)
    q, k, v = qkv.split(72, dim=-1)
    before = attention_mod.multi_head_attention_cuda.launches
    got = ops.multi_head_attention(q, k, v, 2)
    want = attention_mod.multi_head_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), 2)
    assert torch.equal(got, want) and attention_mod.multi_head_attention_cuda.launches == before
    s = (q[..., :36] / 6.0) @ k[..., :36].transpose(1, 2)
    close(got[..., :36], torch.softmax(s, -1) @ v[..., :36], rel=1e-5)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 36)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        attention_mod.multi_head_attention_cuda(q, q, q, 1)


# ---------------------------------------------------------------- layers

def test_one_decoder_layer_matches_the_reference(tiny):
    gcfg, cfg, sd, model, points, _, _ = tiny
    g = torch.Generator().manual_seed(4)
    K, S, d = gcfg.num_queries, gcfg.base.sa_npoints[1], gcfg.d_model
    query, key = torch.randn(2, K, d, generator=g), torch.randn(2, S, d, generator=g)
    qpos, kpos = torch.rand(2, K, 6, generator=g), torch.rand(2, S, 3, generator=g)
    layer = model.decoder[1]
    assert isinstance(layer, DecoderLayer)
    from portbench.reference.votenet_ref import Layers, Precision

    L = Layers(sd, cfg, Precision({}), train=False)
    with torch.no_grad():
        close(layer(query, key, qpos, kpos), R.decoder_layer(L, "decoder.1", query, key, qpos, kpos, cfg))


def test_sampling_takes_the_top_logits_ties_to_the_lower_seed(tiny):
    """Seeds repeated within a scene score equal logits (on each side; the
    two sides' logits differ by rounding): the sampled indices equal the
    reference's, and among equal logits the lower seed index comes first."""
    gcfg, cfg, sd, model, points, _, _ = tiny
    B, S, d = 2, gcfg.base.sa_npoints[1], gcfg.d_model
    g = torch.Generator().manual_seed(6)
    base = torch.randn(B, S // 4, d, generator=g)
    seeds = base.repeat(1, 4, 1)[:, torch.randperm(S, generator=g)]
    from portbench.reference.votenet_ref import Layers, Precision

    L = Layers(sd, cfg, Precision({}), train=False)
    with torch.no_grad():
        logits = model.points_obj_cls(seeds)[..., 0]
        want_logits = L.mlp(seeds, "points_obj_cls", (d, d, 1), None, final_activation=False)[..., 0]
    inds = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :gcfg.num_queries]
    want = torch.sort(want_logits, dim=1, descending=True, stable=True).indices[:, :gcfg.num_queries]
    close(logits, want_logits, rel=1e-5)
    assert torch.equal(inds, want)
    for b in range(B):
        vals = logits[b, inds[b]]
        ties = vals[1:] == vals[:-1]
        assert ties.any()
        assert bool((inds[b, 1:][ties] > inds[b, :-1][ties]).all())


@pytest.mark.parametrize("prefix", ["proposal_", "0head_", "1head_", "last_"])
def test_each_head_matches_the_reference(tiny, prefix):
    *_, ep, ref = tiny
    for part in ("head", "center", "size"):
        close(ep[prefix + part], ref[prefix + part])


def test_seven_heads_at_the_published_depth():
    """``groupfree_config()``'s six layers give the proposal head and six
    more, the last one's under ``last_``."""
    gcfg = groupfree_config()
    assert (gcfg.num_layers, gcfg.num_queries, gcfg.d_model, gcfg.nhead, gcfg.dim_feedforward) == (6, 256, 288, 8,
                                                                                                     2048)
    assert gcfg.base.sa_nsamples == (64, 32, 16, 16) and gcfg.base.fp_mlps[1][-1] == 288
    small = tiny_groupfree_config(num_layers=6)
    with torch.no_grad():
        ep = GroupFree3D(small)(cloud(1, small.base.point_num, 1))
    heads = sorted(k[:-len("head")] for k in ep if k.endswith("head"))
    assert heads == sorted(["proposal_", "0head_", "1head_", "2head_", "3head_", "4head_", "last_"])


def test_the_forward_matches_the_reference(tiny):
    *_, ep, ref = tiny
    for k, want in ref.items():
        if want.dtype.is_floating_point:
            close(ep[k], want)
        else:
            assert torch.equal(ep[k].long(), want.long()), k


def test_detections_match_the_reference(tiny):
    gcfg, cfg, *_, ep, ref = tiny
    got = predict_boxes(ep, gcfg.base)
    want = head_ref.predict(ref, cfg)
    assert torch.equal(got["keep"], want["keep"]) and bool(want["keep"].any())
    close(got["bboxes"], want["bboxes"].float())


def test_two_logit_objectness_keeps_what_sigmoid_keeps(tiny):
    """Objectness handed over as (0, x): the head's candidates and its keep
    mask are those of ``sigmoid(x) > 0.5``."""
    gcfg, cfg, *_, ep, _ = tiny
    x = ep["last_head"][..., 0]
    out = ep["proposals_output"]
    assert torch.equal(out[..., 0], torch.zeros_like(x)) and torch.equal(out[..., 1:], ep["last_head"])
    assert torch.equal(out[..., 1] > out[..., 0], torch.sigmoid(x) > 0.5)
    d = head_ref.decode({k: ep[k].double() for k in ("proposals_output", "proposals_xyz")}, cfg)
    by_sigmoid = head_ref.nms_keep(d["bboxes"], d["score"], torch.sigmoid(x.double()) > 0.5, cfg["nms_iou"])
    assert torch.equal(predict_boxes(ep, gcfg.base)["keep"], by_sigmoid)


# ---------------------------------------------------------------- the SA layer

def sa_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(2, 128, 3, generator=g) * 2.0, torch.randn(2, 128, 5, generator=g)


@pytest.mark.parametrize("train", [False, True])
def test_the_sa_layer_without_normalisation_keeps_todays_bits(train):
    """``normalize_xyz=False`` (the default, VoteNet's layers) composes the
    layer as before it had the option: the MLP on the coordinates and the
    centres as they are, equal bit for bit."""
    g = torch.Generator().manual_seed(2)
    sa = PointNetSAModule(32, 0.4, 8, 5, (16, 16, 32), g, coord_grad=False)
    assert not sa.normalize_xyz
    xyz, feats = sa_inputs(1)
    sa.train(train)
    new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(32, xyz))
    idx, _ = ops.query_ball_point(0.4, 8, xyz, new_xyz)
    both = torch.cat([xyz, feats], dim=-1)
    with torch.no_grad():
        got = sa(xyz, feats)
        grouped = ops.group_point(both, idx) if train else both
        want = sa.mlp(grouped, center=new_xyz, idx=None if train else idx, pool="max")
    assert torch.equal(got[0], new_xyz) and torch.equal(got[2], idx) and torch.equal(got[1], want)


@pytest.mark.parametrize("train", [False, True])
def test_the_sa_layer_divides_its_offsets_by_the_radius(train):
    g = torch.Generator().manual_seed(2)
    sa = PointNetSAModule(32, 0.4, 8, 5, (16, 16, 32), g, coord_grad=False, normalize_xyz=True)
    plain = PointNetSAModule(32, 0.4, 8, 5, (16, 16, 32), torch.Generator().manual_seed(2), coord_grad=False)
    xyz, feats = sa_inputs(3)
    sa.train(train)
    plain.train(train)
    with torch.no_grad():
        got, ref = sa(xyz, feats), plain(xyz, feats)
        new_xyz, _, idx = ref
        offsets = (ops.group_point(xyz, idx) - new_xyz[:, :, None, :]) / 0.4
        x = torch.cat([offsets, ops.group_point(feats, idx)], dim=-1)
        want = sa.mlp(x, pool="max")
    assert torch.equal(got[0], new_xyz) and torch.equal(got[2], idx)
    assert not torch.equal(got[1], ref[1])
    close(got[1], want, rel=1e-5)


def test_the_sa_layer_refuses_normalisation_off_the_fused_path():
    with pytest.raises(ValueError, match="fused path"):
        PointNetSAModule(8, 0.4, 8, 5, (16, 32), torch.Generator(), group_all=True, normalize_xyz=True)


# ---------------------------------------------------------------- the normal path

def test_the_evaluator_and_predictor_run_the_model_with_no_branch(tiny):
    """``make_packed_predict_fn`` over a ``DeviceSceneCache`` and
    ``VoteNetPredictor(model=...)`` give the detections of
    ``predict_boxes`` on the model's end points."""
    from votenet_tpu_torch.eval.evaluator import DeviceSceneCache, Evaluator, make_packed_predict_fn, \
        make_predict_fn
    from votenet_tpu_torch.predictor import VoteNetPredictor

    gcfg, cfg, sd, model, points, ep, _ = tiny
    host = points.numpy()
    ev = Evaluator(gcfg.base, {}, batch_size=2)
    packed = ev.predictions_for_scenes(make_packed_predict_fn(model, gcfg.base),
                                       DeviceSceneCache(((i, host[i]) for i in range(2)), 2, device="cpu"))
    plain = ev.predictions_for_scenes(make_predict_fn(model, gcfg.base), [(i, host[i]) for i in range(2)])
    pred = VoteNetPredictor(gcfg.base, device="cpu", batch_size=2, model=model)
    served = pred.detect_batch([host[0], host[1]])
    keep = predict_boxes(ep, gcfg.base)["keep"]
    for i in range(2):
        assert len(packed[i]) == len(plain[i]) == len(served[i]) == int(keep[i].sum()) > 0
        for (n1, c1, s1), (n2, c2, s2), (n3, c3, s3) in zip(packed[i], plain[i], served[i]):
            assert n1 == n2 == n3 and s1 == s2 == s3
            np.testing.assert_array_equal(c1, c2)
            np.testing.assert_array_equal(c1, c3)


def test_the_model_records_its_spans(tiny):
    from votenet_tpu_torch.utils import profiling

    gcfg, _, _, model, points, *_ = tiny
    with profiling.record() as rec, torch.no_grad():
        model(points)
    names = [(s.name, s.unit) for s in rec.spans]
    assert names[:3] == [("votenet.gf.backbone", None), ("votenet.gf.sampling", None), ("votenet.gf.decoder", None)]
    layers = [s for s in rec.spans if s.name == "votenet.gf.layer"]
    assert [s.unit for s in layers] == list(range(gcfg.num_layers))
    assert all(rec.spans[s.parent].name == "votenet.gf.decoder" for s in layers)


def test_training_mode_is_not_ported(tiny):
    model = tiny[3]
    with pytest.raises(NotImplementedError):
        model.train()
    assert not model.training and not any(m.training for m in model.modules())


@pytest.mark.parametrize("over, match", [(dict(d_model=40), "d_model"), (dict(num_queries=8), "num_queries"),
                                         (dict(nhead=5), "nhead")])
def test_inconsistent_settings_raise(over, match):
    with pytest.raises(ValueError, match=match):
        GroupFree3D(tiny_groupfree_config(**over))
