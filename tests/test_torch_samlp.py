"""The fused SA-layer MLP + max-pool of the port (``samlp``) against the JAX
package's, on the CPU.

The JAX side runs its Pallas kernel in interpret mode
(``dispatch.set_samlp("on")`` + ``dispatch.samlp_interpreted()``, restored
afterwards, as ``tests/test_pallas.py`` does); the port runs the kernel's
plain version (``ops/cuda/samlp.py``), as every CPU tensor does.

Tolerances: the fused function alone to ``rtol=1e-5, atol=1e-6``, the
JAX test's own (the matmuls sum in another order). The SA layers and the
tiny VoteNet as in ``tests/test_torch_model.py``: integer end points equal,
floats within 2e-5 of the tensor's scale (the fold reassociates the affine
arithmetic, and each framework's matmuls round in their own order).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import chain_inputs
from tests.test_torch_model import close, randomize_bn, t
from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.synthetic import synthetic_scenes
from votenet_tpu_torch import ops
from votenet_tpu_torch.models import VoteNet, convert_flax_variables
from votenet_tpu_torch.models.pointnet2 import PointNetSAModule
from votenet_tpu_torch.ops.cuda import samlp as samlp_mod


@contextlib.contextmanager
def jax_samlp_on():
    """The JAX package's fused eval path, its kernel interpreted on the CPU."""
    from votenet_tpu.ops import dispatch

    prev = dispatch.samlp_enabled()
    try:
        dispatch.set_samlp("on")
        with dispatch.samlp_interpreted():
            yield
    finally:
        dispatch.set_samlp("on" if prev else "off")


@pytest.fixture
def port_calls(monkeypatch):
    """Count the port's fused calls (``ops.fused_sa_mlp_pool``)."""
    calls = []
    orig = ops.fused_sa_mlp_pool

    def counting(*a):
        calls.append(tuple(a[0].shape))
        return orig(*a)

    monkeypatch.setattr(ops, "fused_sa_mlp_pool", counting)
    return calls


@pytest.fixture
def jax_calls(monkeypatch):
    """Count the JAX package's fused kernel calls."""
    from votenet_tpu.ops.pallas import samlp as jax_samlp

    calls = []
    orig = jax_samlp.fused_sa_mlp_pool

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jax_samlp, "fused_sa_mlp_pool", counting)
    return calls


def torch_args(h_all, idx, sh0, s0, layers):
    return t(h_all), t(idx), t(sh0), t(s0), [tuple(t(a) for a in lay) for lay in layers]


# the three shapes of tests/test_pallas.py, then the proposal layer's widths
SHAPES = [
    (2, 192, 64, [64, 64, 128]),
    (1, 256, 64, [128, 128, 256]),
    (2, 64, 16, [16, 16, 32]),
    (2, 256, 64, [128, 128, 128]),
]


@pytest.mark.parametrize("B,M,S,widths", SHAPES, ids=["sa1-widths", "sa2-widths", "tiny-widths", "proposal-widths"])
def test_plain_matches_the_jax_kernel(B, M, S, widths):
    from votenet_tpu.ops.pallas.samlp import fused_sa_mlp_pool

    N = 3 * M
    h_all, idx, sh0, s0, layers = chain_inputs(B + M + S, B, N, M, S, widths)
    h0 = h_all[np.arange(B)[:, None, None], idx]  # the JAX kernel takes the gathered rows
    want = np.asarray(fused_sa_mlp_pool(
        jnp.asarray(h0), jnp.asarray(sh0), jnp.asarray(s0),
        [tuple(jnp.asarray(a) for a in lay) for lay in layers], interpret=True,
    ))
    got = samlp_mod.fused_sa_mlp_pool_plain(*torch_args(h_all, idx, sh0, s0, layers))
    assert tuple(got.shape) == (B, M, widths[-1])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_dispatch_on_cpu_is_the_plain_version():
    args = torch_args(*chain_inputs(0, 2, 50, 7, 5, [6, 9, 13]))
    before = samlp_mod.fused_sa_mlp_pool_cuda.launches
    assert torch.equal(ops.fused_sa_mlp_pool(*args), samlp_mod.fused_sa_mlp_pool_plain(*args))
    assert samlp_mod.fused_sa_mlp_pool_cuda.launches == before == 0


@pytest.mark.parametrize(
    "S,widths,want",
    [
        (64, [64, 64, 128], (1, 1, (64, 128), (64, 64), 32, 4)),
        (64, [128, 128, 256], (1, 1, (128, 256), (128, 128), 32, 2)),
        (8, [16, 16, 32], (8, 1, (32, 32), (32, 32), 32, 4)),
        (7, [6, 9, 13], (9, 1, (32, 32), (32, 32), 32, 4)),
        (100, [128, 256, 64], (1, 2, (256, 64), (128, 256), 16, 2)),
    ],
)
def test_samlp_plan(S, widths, want):
    """Centres a 64-row tile takes (or tiles a centre), each layer's wgmma N
    and K, the weight slice and the ring's stages; shared memory as the
    kernel lays it out: the ring, two warpgroups' A-fragment slots and pooled
    rows, the affine vectors, the mbarriers."""
    plan = samlp_mod.samlp_plan(S, widths)
    assert tuple(plan[:6]) == want
    T, _, npad, kpad, ks, stages = want
    affine = kpad[0] + 2 * sum(npad)
    fixed = 2 * (max(kpad) // 8) * 128 * 16 + 2 * T * npad[-1] * 4 + affine * 4 + 2 * samlp_mod.MAX_STAGES * 8
    assert plan.smem == fixed + stages * max(npad) * ks * 8
    assert plan.smem <= samlp_mod.SMEM_LIMIT


# ---------------------------------------------------------------- modules

@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def points(cfg):
    return np.stack([s["points"] for s in synthetic_scenes(0, cfg, 2)])


@pytest.mark.parametrize("layer", ["sa1", "sa2", "proposal"])
def test_sa_module_samlp_matches_jax_samlp(cfg, points, layer, port_calls, jax_calls):
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    rng = np.random.RandomState(50)
    if layer == "proposal":
        xyz = (points[:, : cfg.sa_npoints[1]] + rng.normal(0, 0.1, (2, cfg.sa_npoints[1], 3))).astype(np.float32)
        feats = rng.randn(2, cfg.sa_npoints[1], cfg.fp_mlps[1][-1]).astype(np.float32)
        sample = points[:, : cfg.sa_npoints[1]]
        kw = dict(npoint=cfg.proposal_num, radius=cfg.proposal_radius, nsample=cfg.proposal_nsample,
                  mlp=cfg.proposal_mlp, mlp2=tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,))
    else:
        i = int(layer[-1]) - 1
        n_in = cfg.point_num if i == 0 else cfg.sa_npoints[i - 1]
        xyz = points[:, :n_in]
        feats = xyz if i == 0 else rng.randn(2, n_in, cfg.sa_mlps[i - 1][-1]).astype(np.float32)
        sample = None
        kw = dict(npoint=cfg.sa_npoints[i], radius=cfg.sa_radii[i], nsample=cfg.sa_nsamples[i], mlp=cfg.sa_mlps[i])
    jm = JaxSA(**kw)
    v = randomize_bn(jm.init(jax.random.PRNGKey(7), xyz, feats, False, sample_xyz=sample))
    with jax_samlp_on():
        jx, jf, jidx = jm.apply(v, xyz, feats, False, sample_xyz=sample)
    assert len(jax_calls) == 1

    pm = PointNetSAModule(kw["npoint"], kw["radius"], kw["nsample"], feats.shape[-1], kw["mlp"],
                          torch.Generator().manual_seed(0), mlp2=kw.get("mlp2"), samlp=True)
    convert_flax_variables(v, pm)
    with torch.no_grad():
        px, pf, pidx = pm(t(xyz), t(feats), sample_xyz=None if sample is None else t(sample))
    assert port_calls == [(2, xyz.shape[1], kw["mlp"][0])]
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    close(pf, jf)


def test_single_layer_mlp_keeps_the_unfused_path(cfg):
    """The fused chain starts at a second layer: a one-layer MLP runs the
    plain eval path whatever ``samlp`` says, as in the JAX package."""
    pm = PointNetSAModule(16, 0.4, 8, 3, (16,), torch.Generator().manual_seed(0), samlp=True)
    assert not pm.samlp
    assert PointNetSAModule(16, 0.4, 8, 3, (16, 16), torch.Generator().manual_seed(0), samlp=True).samlp


@pytest.fixture(scope="module")
def tiny_models(cfg, points):
    """JAX VoteNet with samlp on (interpreted) and the port with samlp on and
    off, from the same randomized variables."""
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet

    jm = JaxVoteNet(cfg)
    v = randomize_bn(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(points))))
    with jax_samlp_on():
        je = jax.tree_util.tree_map(np.asarray, jm.apply(v, points, train=False))
    on, off = VoteNet(cfg.replace(samlp="on")), VoteNet(cfg)
    convert_flax_variables(v, on)
    convert_flax_variables(v, off)
    return je, on, off


def test_votenet_samlp_matches_jax_samlp(tiny_models, points, port_calls):
    je, on, _ = tiny_models
    with torch.no_grad():
        pe = on(t(points))
    assert len(port_calls) == 5  # sa1-sa4 and the proposal layer, once each
    assert sorted(pe) == sorted(je)
    np.testing.assert_array_equal(pe["seeds_xyz"].numpy(), je["seeds_xyz"])
    for k in je:
        close(pe[k], je[k])


def test_votenet_samlp_on_matches_off(tiny_models, points, port_calls):
    _, on, off = tiny_models
    with torch.no_grad():
        a, b = on(t(points)), off(t(points))
    assert len(port_calls) == 5
    np.testing.assert_array_equal(a["seeds_xyz"].numpy(), b["seeds_xyz"].numpy())
    for k in a:
        close(a[k], b[k].numpy())


def test_training_ignores_samlp(cfg, points, port_calls):
    """A train-mode forward takes the gather-first path whatever ``samlp``
    says: bit-equal outputs and running statistics, no fused call."""
    on = VoteNet(cfg.replace(samlp="on"), torch.Generator().manual_seed(5)).train()
    off = VoteNet(cfg, torch.Generator().manual_seed(5)).train()
    with torch.no_grad():
        a, b = on(t(points)), off(t(points))
    assert port_calls == []
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = on.state_dict(), off.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
