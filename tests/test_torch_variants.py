"""The three kernel variants of the port against their JAX references, on the
CPU: samlp's bf16 operands (``precision="bf16"``), the ball query that also
emits the grouped coordinates, and the noscalar FPS.

References. samlp: the JAX package's Pallas kernel in interpret mode, and
its eval forward under ``dispatch.set_samlp_precision("bf16")`` +
``samlp_interpreted()`` (restored afterwards). The other two are the
prototypes ``benchmarks/bq_emit_xyz_proto.py`` and
``benchmarks/fps_noscalar_proto.py``, loaded from their files with importlib
and run in interpret mode (the emit prototype reads its module's
``INTERPRET`` when it is first traced, so the test sets it before the first
call; the FPS prototype takes ``interpret=True``). The port runs each
variant's plain version, as every CPU tensor does.

Tolerances. Indices, counts and grouped coordinates must be equal. The
ball-query clouds are band-free (no point within 1e-6 of r^2 of a query):
the port squares the radius in f32 (``radius_sq``, the XLA twin's rule)
where the prototype squares it in double (``float(radius) ** 2``), and the
two differ by an ulp at some radii. bf16 samlp: ``BF16_TOL`` = 1.5e-3 of
the output's scale. The products of bf16 operands are exact, but the two
frameworks sum them in other orders, and an activation one f32 ulp apart
can round to the neighbouring bf16 value before the next layer (2^-8 of that
activation): measured up to 6.2e-4 of scale at these shapes. The bf16 result
lies 3.3e-3 to 3.8e-3 of scale from the f32 one at the same shapes, and each
test checks that f32 lands outside ``BF16_TOL``, so the test can tell the
modes apart. The modules and the tiny VoteNet: 2e-5 of scale, as the f32
tests of ``tests/test_torch_samlp.py`` (no activation of these inputs lands
on another bf16 value), with the f32 run checked to lie outside it.
"""

import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import proto_cloud
from tests.test_torch_cuda import chain_inputs
from tests.test_torch_model import close, randomize_bn, t
from tests.test_torch_ops import band_free
from tests.test_torch_samlp import SHAPES, jax_samlp_on, torch_args
from votenet_tpu_torch import ops
from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.synthetic import synthetic_scenes
from votenet_tpu_torch.models import VoteNet, convert_flax_variables
from votenet_tpu_torch.models.pointnet2 import PointNetSAModule
from votenet_tpu_torch.ops import dispatch as port_dispatch
from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
from votenet_tpu_torch.ops.cuda import fps as fps_mod
from votenet_tpu_torch.ops.cuda import samlp as samlp_mod

BENCHMARKS = Path(__file__).resolve().parents[1] / "benchmarks"
BF16_TOL = 1.5e-3  # of the output's scale; see the module docstring


def load_prototype(name):
    spec = importlib.util.spec_from_file_location(f"_proto_{name}", BENCHMARKS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def emit_proto():
    module = load_prototype("bq_emit_xyz_proto")
    module.INTERPRET = True  # read when the jitted wrapper is first traced
    return module


@pytest.fixture(scope="module")
def fps_proto():
    return load_prototype("fps_noscalar_proto")


# ------------------------------------------------------------ emit-xyz


def emit_case(name):
    """(xyz (B, N, 3), queries (B, M, 3), radius, S). The prototype's two
    shapes (its queries are the first M points, all in the uniform half),
    then S in {8, 16, 64} with queries in the cluster (full balls), in the
    uniform half (balls of fewer than S hits) and one far away (empty)."""
    rng = np.random.RandomState(0)
    if name in ("proto-2x512", "proto-1x384"):
        B, N, M, r, S = (2, 512, 128, 0.2, 8) if name == "proto-2x512" else (1, 384, 64, 0.8, 16)
        if name == "proto-1x384":
            proto_cloud(rng, 2, 512)  # the prototype draws its second cloud after its first
        xyz = proto_cloud(rng, B, N)
        return xyz, xyz[:, :M].copy(), r, S
    S, N, r = {"S8": (8, 300, 0.3), "S16": (16, 600, 0.25), "S64": (64, 1000, 0.4)}[name]
    xyz = proto_cloud(np.random.RandomState(S), 2, N)
    q = np.concatenate([xyz[:, N - 20:], xyz[:, :20]], axis=1).copy()  # cluster, then uniform
    q[1, -1] = 100.0
    return xyz, q, r, S


EMIT_CASES = ["proto-2x512", "proto-1x384", "S8", "S16", "S64"]


@pytest.mark.parametrize("name", EMIT_CASES)
def test_emit_plain_matches_prototype(emit_proto, name):
    xyz, q, r, S = emit_case(name)
    assert band_free(xyz, q, r)
    want = [np.asarray(a) for a in emit_proto.query_ball_point_emit_xyz(r, S, jnp.asarray(xyz), jnp.asarray(q))]
    got = ops.query_ball_point_emit_xyz(r, S, t(xyz), t(q))
    assert [tuple(g.shape) for g in got] == [q.shape[:2] + (S,), q.shape[:2], q.shape[:2] + (S, 3)]
    assert got[0].dtype == got[1].dtype == torch.int32 and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    cnt = want[1]
    if not name.startswith("proto"):  # the cases the prototype's own shapes miss
        assert (cnt == 0).any() and ((cnt > 0) & (cnt < S)).any() and (cnt == S).any()


def test_emit_plain_is_query_then_gather():
    """idx and cnt are query_ball_point's; gxyz is group_point(xyz, idx):
    an empty ball repeats point 0, a partial one its first hit."""
    xyz, q, r, S = emit_case("S16")
    idx, cnt, gxyz = ops.query_ball_point_emit_xyz(r, S, t(xyz), t(q))
    want_idx, want_cnt = ops.query_ball_point(r, S, t(xyz), t(q))
    assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)
    assert torch.equal(gxyz, ops.group_point(t(xyz), idx))
    assert torch.equal(gxyz[1, -1], t(xyz)[1, 0].expand(S, 3))


# ------------------------------------------------------------ noscalar FPS


def fps_case(name):
    rng = np.random.RandomState(0)
    if name == "proto-1x512":
        return rng.uniform(-4, 4, (1, 512, 3)).astype(np.float32), 64
    if name == "proto-2x384":
        rng.uniform(-4, 4, (1, 512, 3))  # the prototype's first cloud
        return rng.uniform(-4, 4, (2, 384, 3)).astype(np.float32), 32
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij"), -1).reshape(-1, 3)
    return np.stack([g[rng.permutation(len(g))] for _ in range(3)]).astype(np.float32), 100  # ties, B=3


@pytest.mark.parametrize("name", ["proto-1x512", "proto-2x384", "ties-grid-B3"])
def test_fps_noscalar_matches_prototype(fps_proto, name):
    xyz, npoint = fps_case(name)
    want = np.asarray(fps_proto.fps_rowwise_noscalar(npoint, jnp.asarray(xyz), True))
    got = ops.fps_rowwise_noscalar(npoint, t(xyz))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, ops.farthest_point_sample(npoint, t(xyz)))


# ------------------------------------------------------------ samlp bf16


def test_samlp_precision_default_and_errors():
    from votenet_tpu.ops import dispatch as jax_dispatch

    assert port_dispatch.samlp_precision() == jax_dispatch.samlp_precision() == "f32"
    for bad in ("fp16", "BF16", None):
        with pytest.raises(ValueError) as port_err:
            port_dispatch.set_samlp_precision(bad)
        with pytest.raises(ValueError) as jax_err:
            jax_dispatch.set_samlp_precision(bad)
        assert str(port_err.value) == str(jax_err.value)
    assert port_dispatch.samlp_precision() == "f32"
    with pytest.raises(ValueError, match="precision"):
        samlp_mod.fused_sa_mlp_pool_plain(*torch_args(*chain_inputs(0, 1, 20, 3, 4, [8, 8, 8])), precision="tf32")


@contextlib.contextmanager
def samlp_precision(mode):
    """Both packages' samlp operand precision set to ``mode``, restored."""
    from votenet_tpu.ops import dispatch as jax_dispatch

    try:
        port_dispatch.set_samlp_precision(mode)
        jax_dispatch.set_samlp_precision(mode)
        yield
    finally:
        port_dispatch.set_samlp_precision("f32")
        jax_dispatch.set_samlp_precision("f32")


def scale_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("B,M,S,widths", SHAPES, ids=["sa1-widths", "sa2-widths", "tiny-widths", "proposal-widths"])
def test_bf16_plain_matches_the_jax_kernel(B, M, S, widths):
    from votenet_tpu.ops.pallas.samlp import fused_sa_mlp_pool

    N = 3 * M
    h_all, idx, sh0, s0, layers = chain_inputs(B + M + S, B, N, M, S, widths)
    h0 = h_all[np.arange(B)[:, None, None], idx]
    jax_args = (jnp.asarray(h0), jnp.asarray(sh0), jnp.asarray(s0), [tuple(jnp.asarray(a) for a in lay) for lay in layers])
    want = np.asarray(fused_sa_mlp_pool(*jax_args, precision="bf16", interpret=True))
    f32 = np.asarray(fused_sa_mlp_pool(*jax_args, precision="f32", interpret=True))
    args = torch_args(h_all, idx, sh0, s0, layers)
    got = samlp_mod.fused_sa_mlp_pool_plain(*args, precision="bf16")
    assert tuple(got.shape) == (B, M, widths[-1]) and got.dtype == torch.float32
    assert scale_gap(got.numpy(), want) <= BF16_TOL
    assert scale_gap(f32, want) > BF16_TOL  # the modes differ by more than the tolerance
    assert scale_gap(samlp_mod.fused_sa_mlp_pool_plain(*args).numpy(), want) > BF16_TOL


@pytest.mark.parametrize("B,M,S,widths", SHAPES, ids=["sa1-widths", "sa2-widths", "tiny-widths", "proposal-widths"])
def test_chain_bf16_matches_plain(B, M, S, widths):
    """The kernel's arithmetic emulated (exact products, f64 sums) against
    the plain bf16 chain (f32 sums): within BF16_TOL, and the plain f32
    chain outside it."""
    args = torch_args(*chain_inputs(B * M + S, B, 3 * M, M, S, widths))
    plain = samlp_mod.fused_sa_mlp_pool_plain(*args, precision="bf16")
    emulated = samlp_mod.chain_bf16(*args)
    assert scale_gap(emulated.numpy(), plain.numpy()) <= BF16_TOL
    assert scale_gap(samlp_mod.fused_sa_mlp_pool_plain(*args).numpy(), plain.numpy()) > BF16_TOL


def test_bf16_plain_rounds_operands_not_products():
    """Operands rounded to bf16 and multiplied in f32: 1 + 2^-7 (a bf16
    value) times itself keeps its 2^-14 term, which a bf16 product drops."""
    x = 1.0 + 2.0 ** -7
    h_all = torch.full((1, 1, 1), x)
    layers = [(torch.full((1, 1), x), torch.ones(1), torch.zeros(1))]
    got = samlp_mod.fused_sa_mlp_pool_plain(h_all, torch.zeros((1, 1, 1), dtype=torch.int32),
                                             torch.zeros((1, 1, 1)), torch.ones(1), layers, precision="bf16")
    assert float(got) == x * x and float(got) != float(torch.tensor(x * x).to(torch.bfloat16))


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def points(cfg):
    return np.stack([s["points"] for s in synthetic_scenes(0, cfg, 2)])


@pytest.mark.parametrize("layer", ["sa1", "sa2", "proposal"])
def test_sa_module_bf16_samlp_matches_jax(cfg, points, layer):
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    rng = np.random.RandomState(51)
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
    v = randomize_bn(jm.init(jax.random.PRNGKey(8), xyz, feats, False, sample_xyz=sample))
    pm = PointNetSAModule(kw["npoint"], kw["radius"], kw["nsample"], feats.shape[-1], kw["mlp"],
                          torch.Generator().manual_seed(0), mlp2=kw.get("mlp2"), samlp=True)
    convert_flax_variables(v, pm)
    out = {}
    for mode in ("f32", "bf16"):
        with samlp_precision(mode), jax_samlp_on():
            jx, jf, jidx = jm.apply(v, xyz, feats, False, sample_xyz=sample)
            with torch.no_grad():
                px, pf, pidx = pm(t(xyz), t(feats), sample_xyz=None if sample is None else t(sample))
        out[mode] = (np.asarray(jf), pf)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    jf, pf = out["bf16"]
    close(pf, jf)
    assert scale_gap(out["f32"][1].numpy(), jf) > 2e-5  # the bf16 run is not the f32 one


def test_votenet_bf16_samlp_matches_jax(cfg, points, monkeypatch):
    """The tiny VoteNet's eval forward with samlp on in bf16 against JAX's:
    5 fused calls, each in bf16; integer end points equal, floats within
    2e-5 of scale; the f32 forward outside that."""
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet

    jm = JaxVoteNet(cfg)
    v = randomize_bn(jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(points))))
    model = VoteNet(cfg.replace(samlp="on"))
    convert_flax_variables(v, model)
    calls = []
    orig = ops.fused_sa_mlp_pool

    def counting(*a):
        calls.append(a[5])
        return orig(*a)

    monkeypatch.setattr(ops, "fused_sa_mlp_pool", counting)
    with samlp_precision("bf16"):
        with jax_samlp_on():
            je = jax.tree_util.tree_map(np.asarray, jm.apply(v, points, train=False))
        with torch.no_grad():
            pe = model(t(points))
    assert calls == ["bf16"] * 5 and port_dispatch.samlp_precision() == "f32"
    with torch.no_grad():
        f32 = model(t(points))
    assert calls[5:] == ["f32"] * 5
    np.testing.assert_array_equal(pe["seeds_xyz"].numpy(), je["seeds_xyz"])
    for k in je:
        close(pe[k], je[k])
    assert scale_gap(f32["proposals_output"].numpy(), je["proposals_output"]) > 2e-5


# ------------------------------------------------------------ dispatch


def test_cpu_dispatch_takes_the_plain_versions(monkeypatch):
    """On CPU tensors the three variants run their plain versions: no
    counter moves and the library is never built; a tensor on another
    device raises."""

    def no_build():
        raise AssertionError("a CPU call tried to build or load the kernels")

    for mod in (fps_mod, bq_mod, samlp_mod):
        monkeypatch.setattr(mod, "library", no_build)
    counters = (fps_mod.fps_rowwise_noscalar_cuda, bq_mod.query_ball_point_emit_xyz_cuda,
                samlp_mod.fused_sa_mlp_pool_cuda.bf16, samlp_mod.fused_sa_mlp_pool_cuda)
    before = [c.launches for c in counters]
    xyz = t(np.random.RandomState(3).randn(2, 64, 3).astype(np.float32))
    assert torch.equal(ops.fps_rowwise_noscalar(8, xyz), fps_mod.farthest_point_sample_plain(8, xyz))
    got = ops.query_ball_point_emit_xyz(0.5, 4, xyz, xyz[:, :8].contiguous())
    want = bq_mod.query_ball_point_emit_xyz_plain(0.5, 4, xyz, xyz[:, :8])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args = torch_args(*chain_inputs(1, 2, 50, 7, 5, [6, 9, 13]))
    assert torch.equal(ops.fused_sa_mlp_pool(*args, "bf16"), samlp_mod.fused_sa_mlp_pool_plain(*args, precision="bf16"))
    assert [c.launches for c in counters] == before == [0, 0, 0, 0]

    meta = torch.empty((1, 16, 3), device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        ops.fps_rowwise_noscalar(4, meta)
    with pytest.raises(NotImplementedError, match="meta"):
        ops.query_ball_point_emit_xyz(0.2, 4, meta, meta)
    with pytest.raises(NotImplementedError, match="meta"):
        ops.fused_sa_mlp_pool(torch.empty((1, 16, 6), device="meta"), *args[1:], "bf16")


@pytest.mark.parametrize("kernel", ["fps_noscalar", "ballquery_emit", "samlp_bf16"])
def test_variant_wrapper_raises_without_a_card(monkeypatch, kernel):
    """Given a CPU tensor, a variant's wrapper raises: it neither computes
    the plain version nor builds the library."""

    def no_build():
        raise AssertionError("the wrapper tried to build or load the kernels")

    for mod in (fps_mod, bq_mod, samlp_mod):
        monkeypatch.setattr(mod, "library", no_build)
    xyz = torch.zeros(1, 16, 3)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        if kernel == "fps_noscalar":
            fps_mod.fps_rowwise_noscalar_cuda(4, xyz)
        elif kernel == "ballquery_emit":
            bq_mod.query_ball_point_emit_xyz_cuda(0.2, 4, xyz, xyz)
        else:
            layer = (torch.zeros(3, 5), torch.ones(5), torch.zeros(5))
            samlp_mod.fused_sa_mlp_pool_cuda(xyz, torch.zeros(1, 4, 8, dtype=torch.int32), torch.zeros(1, 4, 3),
                                             torch.ones(3), [layer], precision="bf16")
    assert fps_mod.fps_rowwise_noscalar_cuda.launches == bq_mod.query_ball_point_emit_xyz_cuda.launches == 0
    assert samlp_mod.fused_sa_mlp_pool_cuda.bf16.launches == 0
