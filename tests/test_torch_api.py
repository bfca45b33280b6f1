"""The reference API's other paths, ported (on no path of the model), on
the CPU against the JAX package.

``PointNetSAModule``'s ``pooling`` ("avg", "weighted_avg", "max_and_avg"),
``group_all``, ``knn``, ``use_xyz=False`` and ``use_bn=False``, a layer
without features, and ``PointNetSAModuleMSG``, each in eval and in train
mode, against the flax module whose variables ``convert_flax_variables``
loads: indices bit-equal, floats within 1e-5 of scale (f32 sums in another
order), in training also the updated batch statistics and the gradients
(inputs within 1e-5 of scale, parameters norm-wise per leaf as
``check_grads``). Then the ops ``knn_point`` (tied distances),
``select_top_k``, ``query_ball_point_topk``, ``prob_sample`` and
``sample_and_group_all``, bit-equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import close, jax_leaf, port_leaf_np, t
from votenet_tpu_torch import ops
from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.synthetic import synthetic_scene
from votenet_tpu_torch.models import convert_flax_variables
from votenet_tpu_torch.models.convert import flax_param_path, flax_variables_from_model
from votenet_tpu_torch.models.pointnet2 import PointNetSAModule, PointNetSAModuleMSG, sample_and_group_all

N, C, NPOINT, RADIUS, NSAMPLE, MLP = 256, 8, 32, 0.4, 8, (16, 16)


def inputs(seed):
    rng = np.random.RandomState(seed)
    xyz = synthetic_scene(rng, tiny_config(point_num=N))["points"][None].repeat(2, 0)
    xyz[1] = xyz[1, rng.permutation(N)]
    feats = rng.randn(2, N, C).astype(np.float32)
    return xyz.astype(np.float32), feats, rng


def stats_path(name):
    mod, leaf = name.rsplit(".", 1)
    return "/".join(mod.split(".") + ["mean" if leaf == "running_mean" else "var"])


def check_param_grads(model, jgrads, rel=5e-3):
    """Per leaf, norm-wise, as ``tests/test_torch_train.py::check_grads``:
    ||port - jax|| < rel * max(||jax||, 1e-2 sqrt(size)). A dense bias
    followed by a training batch norm has gradient 0 in exact arithmetic
    (the norm removes the mean): both sides hold f32 noise, whose size
    depends on the sum order, so there each side's norm must stay below
    1e-3 of its dense kernel's gradient norm instead."""
    bad = []
    for name, p in model.named_parameters():
        a = port_leaf_np(model, name, p.grad).astype(np.float64)
        b = jax_leaf(jgrads, flax_param_path(name, model)).astype(np.float64)
        mod, leaf = name.rsplit(".", 1)
        parent, layer = mod.rsplit(".", 1)
        bn = f"{parent}.bn{layer.removeprefix('dense')}"
        if leaf == "bias" and layer.startswith("dense") and bn in dict(model.named_modules()):
            w = float(np.linalg.norm(jax_leaf(jgrads, flax_param_path(f"{mod}.weight", model))))
            if max(np.linalg.norm(a), np.linalg.norm(b)) >= 1e-3 * w:
                bad.append((name, "noise", float(np.linalg.norm(a)), float(np.linalg.norm(b)), w))
            continue
        if np.linalg.norm(a - b) >= rel * max(np.linalg.norm(b), 1e-2 * np.sqrt(b.size)):
            bad.append((name, float(np.linalg.norm(b)), float(np.linalg.norm(a - b))))
    assert not bad, bad


def compare(jm, pm, args, train, rng, width):
    """Run the flax module and the port's from one set of variables; hold
    the outputs (and in training the statistics and gradients)."""
    xyz, feats = args
    variables = jm.init(jax.random.PRNGKey(5), xyz, feats, False)
    convert_flax_variables(variables, pm)
    jv = flax_variables_from_model(pm)
    assert jax.tree_util.tree_structure(jv) == jax.tree_util.tree_structure(
        {"params": variables["params"], "batch_stats": variables.get("batch_stats", {})})
    pm.train(train)
    tx = t(xyz).requires_grad_(True)
    tf = None if feats is None else t(feats).requires_grad_(True)
    out = pm(tx, tf)
    if not train:
        jout = jm.apply(variables, xyz, feats, False)
        for got, want in zip(out, jout):
            (np.testing.assert_array_equal if got.dtype == torch.int32 else
             lambda a, b: close(a.detach(), b, 1e-5))(got.numpy() if got.dtype == torch.int32 else got, np.asarray(want))
        return
    w = rng.randn(*out[1].shape).astype(np.float32)
    has_stats = "batch_stats" in variables

    def f(params, x, p):
        v = {"params": params, **({"batch_stats": variables["batch_stats"]} if has_stats else {})}
        res, mut = jm.apply(v, x, p, True, mutable=["batch_stats"])
        return jnp.sum(res[1] * w), (res, mut.get("batch_stats", {}))

    (_, (jres, jstats)), grads = jax.value_and_grad(f, argnums=(0, 1, 2) if feats is not None else (0, 1),
                                                    has_aux=True)(variables["params"], xyz, feats)
    (out[1] * t(w)).sum().backward()
    close(out[0].detach(), jres[0], 1e-5)
    close(out[1].detach(), jres[1], 1e-5)
    if len(out) > 2:
        np.testing.assert_array_equal(out[2].numpy(), np.asarray(jres[2]))
    # JAX differentiates weighted_avg's norm at a centre's own slot (a zero
    # vector) to NaN; torch's norm has the subgradient 0 there. No gradient
    # reaches xyz (None) where only the centres' unused coordinates read it.
    gx = np.asarray(grads[1])
    finite = np.isfinite(gx)
    tgx = torch.zeros_like(tx) if tx.grad is None else tx.grad
    assert torch.isfinite(tgx).all()
    close(tgx[torch.from_numpy(finite)], gx[finite], 1e-5)
    if feats is not None:
        close(tf.grad, grads[2], 1e-5)
    check_param_grads(pm, grads[0])
    for name, buf in pm.named_buffers():
        close(buf, jax_leaf(jstats, stats_path(name)), 1e-5)
    assert out[1].shape[-1] == width


SA_VARIANTS = {
    "avg": dict(pooling="avg"),
    "weighted_avg": dict(pooling="weighted_avg"),
    "max_and_avg": dict(pooling="max_and_avg", mlp2=(16, 8)),
    "group_all": dict(group_all=True),
    "knn": dict(knn=True),
    "no_xyz": dict(use_xyz=False),
    "no_bn": dict(use_bn=False, mlp2=(16, 8)),
    "no_points": dict(pooling="avg"),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", list(SA_VARIANTS))
def test_sa_module_variant_matches_flax(variant, train):
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    kw = SA_VARIANTS[variant]
    xyz, feats, rng = inputs(list(SA_VARIANTS).index(variant))
    if variant == "no_points":
        feats = None
    jm = JaxSA(npoint=NPOINT, radius=RADIUS, nsample=NSAMPLE, mlp=MLP, **kw)
    pm = PointNetSAModule(NPOINT, RADIUS, NSAMPLE, 0 if feats is None else C, MLP, torch.Generator().manual_seed(0),
                          samlp=True, **kw)
    # the fused eval kernel takes max pooling with batch norm on the fused path (knn's too) only
    assert pm.samlp == (variant == "knn")
    width = (kw.get("mlp2") or MLP)[-1] * (2 if kw.get("pooling") == "max_and_avg" and "mlp2" not in kw else 1)
    compare(jm, pm, (xyz, feats), train, rng, width)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kw", [dict(), dict(use_xyz=False, use_bn=False)], ids=["default", "no_xyz_no_bn"])
def test_msg_module_matches_flax(kw, train):
    """Two scales; the reversed concat ``[grouped, grouped_xyz]``; the flax
    ``mlp_scale{i}`` trees (and, without batch norm, dense layers alone)
    convert by name."""
    from votenet_tpu.models.pointnet2 import PointNetSAModuleMSG as JaxMSG

    xyz, feats, rng = inputs(21)
    mlps = ((8, 16), (16, 16))
    jm = JaxMSG(npoint=NPOINT, radius_list=(0.2, 0.4), nsample_list=(8, 16), mlp_list=mlps, **kw)
    pm = PointNetSAModuleMSG(NPOINT, (0.2, 0.4), (8, 16), C, mlps, torch.Generator().manual_seed(0), **kw)
    assert [k for k in pm.state_dict() if "mlp_scale1" in k][0].startswith("mlp_scale1.dense0")
    compare(jm, pm, (xyz, feats), train, rng, 32)


def test_samlp_gate_and_refusals():
    """The fused eval kernel stays on for max pooling with batch norm and is
    skipped for the rest, as the JAX gate; an unknown pooling raises the
    JAX module's ValueError (at construction here); a point-sharded layer
    refuses knn and group_all."""
    g = torch.Generator().manual_seed(0)
    assert PointNetSAModule(NPOINT, RADIUS, NSAMPLE, C, MLP, g, samlp=True).samlp
    for name, kw in SA_VARIANTS.items():
        assert PointNetSAModule(NPOINT, RADIUS, NSAMPLE, C, MLP, g, samlp=True, **kw).samlp == (name == "knn")
    with pytest.raises(ValueError, match="unknown pooling 'min'"):
        PointNetSAModule(NPOINT, RADIUS, NSAMPLE, C, MLP, g, pooling="min")
    for kw in (dict(knn=True), dict(group_all=True)):
        with pytest.raises(ValueError, match="knn/group_all"):
            PointNetSAModule(NPOINT, RADIUS, NSAMPLE, C, MLP, g, sp=True, **kw)


def test_sample_and_group_all_matches_jax():
    from votenet_tpu.models.pointnet2 import sample_and_group_all as jax_sga

    xyz, feats, _ = inputs(3)
    for use_xyz in (True, False):
        for p in (feats, None):
            got = sample_and_group_all(t(xyz), None if p is None else t(p), use_xyz)
            want = jax_sga(xyz, p, use_xyz)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def lattice(rng, B, n):
    """Points on a coarse integer lattice: many exactly tied distances."""
    g = np.stack(np.meshgrid(np.arange(6), np.arange(6), np.arange(4), indexing="ij"), -1).reshape(-1, 3)
    return np.stack([g[rng.permutation(len(g))][:n] for _ in range(B)]).astype(np.float32)


@pytest.mark.parametrize("k", [1, 7, 26])
def test_knn_point_matches_jax_with_ties(k):
    """Tied distances take the lower index first, as ``lax.top_k``."""
    from votenet_tpu.ops.grouping import knn_point as jax_knn

    rng = np.random.RandomState(k)
    xyz = lattice(rng, 2, 120)
    q = xyz[:, :17] + np.float32(0.5)
    d, idx = ops.knn_point(k, t(xyz), t(q))
    jd, jidx = jax_knn(k, xyz, q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert idx.dtype == torch.int32
    assert k == 1 or (np.diff(d.numpy(), axis=-1) == 0).any()


def test_select_top_k_matches_jax():
    from votenet_tpu.ops.grouping import select_top_k as jax_select

    rng = np.random.RandomState(4)
    dist = rng.randint(0, 9, (2, 5, 40)).astype(np.float32)  # ties everywhere
    idx, d = ops.select_top_k(6, t(dist))
    jidx, jd = jax_select(6, dist)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


@pytest.mark.parametrize("radius,nsample", [(0.2, 8), (0.8, 32), (3.0, 64)])
def test_query_ball_point_topk_matches_jax_and_the_query(radius, nsample):
    from votenet_tpu.ops.grouping import query_ball_point_topk as jax_topk

    xyz, _, rng = inputs(int(radius * 10))
    q = np.concatenate([xyz[:, :30], np.full((2, 2, 3), 50.0, np.float32)], axis=1)  # two empty balls
    got = ops.query_ball_point_topk(radius, nsample, t(xyz), t(q))
    want = jax_topk(radius, nsample, xyz, q)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got, ops.query_ball_point(radius, nsample, t(xyz), t(q), "exact")):
        assert torch.equal(a, b)


def test_prob_sample_matches_jax():
    """Integer-valued probabilities, whose running sums are exact in f32 in
    any order; draws on the sums themselves (the side="right" rule) and
    between them."""
    from votenet_tpu.ops.sampling import prob_sample as jax_prob

    rng = np.random.RandomState(6)
    p = rng.randint(0, 5, (3, 50)).astype(np.float32)
    total = p.sum(-1, keepdims=True)
    r = np.concatenate([np.floor(rng.uniform(0, 1, (3, 20)) * total), rng.uniform(0, 1, (3, 20)) * total],
                       axis=1).astype(np.float32)
    got = ops.prob_sample(t(p), t(r))
    want = np.asarray(jax_prob(p, r))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
