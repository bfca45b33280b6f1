"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test skips where ``torch.cuda.is_available()`` is
false (decided inside the ``cuda`` fixture, never at import). Run on a
machine with an NVIDIA Hopper GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.synthetic import synthetic_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cloud(seed, B, N, kind):
    rng = np.random.RandomState(seed)
    if kind == "scene":
        cfg = tiny_config(point_num=N)
        return np.stack([synthetic_scene(rng, cfg)["points"] for _ in range(B)])
    if kind == "grid":  # exact integer distances: ties everywhere
        g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"), -1).reshape(-1, 3)
        return np.stack([g[rng.permutation(len(g))][:N] for _ in range(B)]).astype(np.float32)
    return rng.randn(B, N, 3).astype(np.float32)


@pytest.mark.parametrize(
    "B,N,npoint,kind",
    [(1, 20480, 2048, "scene"), (8, 20480, 2048, "scene"), (8, 2048, 1024, "scene"), (3, 1111, 97, "normal"),
     (2, 2048, 300, "grid"), (1, 64, 1, "normal"), (2, 70000, 128, "normal"), (1, 140000, 64, "normal"),
     (2, 20000, 200, "normal"), (1, 100, 100, "normal"), (2, 300, 300, "grid")],
)
def test_fps_kernel_matches_plain(cuda, B, N, npoint, kind):
    """The cluster-size rule's route at each shape: N=70000 in registers at 16
    CTAs a row, N=140000 the staged route at 16, N=20000 not a multiple of a
    cluster's threads, N=100 below one CTA, npoint 1 and N."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    xyz = torch.from_numpy(cloud(B + N, B, N, kind)).to(cuda)
    got = farthest_point_sample_cuda(npoint, xyz)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(npoint, xyz))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N,kind", [(20480, "scene"), (5000, "normal"), (2048, "grid")])
def test_fps_kernel_every_cluster_size(cuda, cluster, N, kind):
    """Every cluster size, forced, at shapes the rule gives another (20480
    points at 1 CTA is the global-scratch variant)."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    xyz = torch.from_numpy(cloud(cluster + N, 2, N, kind)).to(cuda)
    got = farthest_point_sample_cuda(256, xyz, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(256, xyz))


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_fps_kernel_ties_across_cta_boundaries(cuda, cluster):
    """Equal running minima in different CTAs' slices go to the lower global
    index: every point of a small cloud is repeated once in each slice, so
    every step ties across all of the cluster's CTAs."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    base = np.random.RandomState(cluster).randn(37, 3).astype(np.float32)
    N = 4096
    xyz = np.zeros((1, N, 3), np.float32)
    S = -(-N // cluster)
    for r in range(cluster):  # slice r: the same 37 points at shuffled places
        pos = r * S + np.random.RandomState(r).permutation(S)[:37]
        xyz[0, pos] = base
        xyz[0, r * S:(r + 1) * S][np.all(xyz[0, r * S:(r + 1) * S] == 0, axis=-1)] = base[0]
    xyz = torch.from_numpy(xyz).to(cuda)
    got = farthest_point_sample_cuda(64, xyz, cluster=cluster)
    torch.cuda.synchronize()
    want = farthest_point_sample_plain(64, xyz)
    assert torch.equal(got, want)
    assert (want[0, 1:38] < S).all()  # the first copies win: all in slice 0


def fps_launch_counted(npoint, xyz, **forced):
    """farthest_point_sample_cuda's output and the route its launch was
    counted under; one launch, counted once."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda

    launches, routes = farthest_point_sample_cuda.launches, dict(farthest_point_sample_cuda.routes)
    got = farthest_point_sample_cuda(npoint, xyz, **forced)
    torch.cuda.synchronize()
    moved = {k: v - routes[k] for k, v in farthest_point_sample_cuda.routes.items() if v != routes[k]}
    assert farthest_point_sample_cuda.launches == launches + 1 and len(moved) == 1 and sum(moved.values()) == 1
    return got, next(iter(moved))


@pytest.mark.parametrize(
    "B,N,npoint,kind,cs",
    [(64, 20480, 2048, "scene", 2), (65, 20480, 512, "scene", 2), (128, 20480, 256, "normal", 2),
     (64, 20000, 300, "normal", 2), (64, 20481, 300, "normal", 4), (1, 140000, 64, "normal", 16)],
)
def test_fps_staged_route_matches_plain(cuda, B, N, npoint, kind, cs):
    """The staged route where the rule sends it: eval's sa1 (B=64, 20480
    points, 2048 centres) in one wave, B=65 still in one, B=128 in two,
    ragged rows (the last CTA's slice short; 20481 points at 4 CTAs), one
    row at 16 CTAs. Bit-equal to the plain version, counted once."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain, fps_route

    xyz = torch.from_numpy(cloud(B + N + 2, B, N, kind)).to(cuda)
    assert fps_route(xyz) == (cs, 40, "staged")
    got, route = fps_launch_counted(npoint, xyz)
    assert route == "staged"
    assert torch.equal(got, farthest_point_sample_plain(npoint, xyz))


def test_fps_staged_route_holds_eval_batch_in_one_wave(cuda):
    """The card holds eval's 64 rows of 20480 points on the staged route at
    once: 64 clusters of 2 CTAs, one CTA an SM."""
    from votenet_tpu_torch.ops.cuda import library

    assert library().votenet_fps_staged_max_clusters(2) >= 64


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_fps_staged_route_ties_across_cta_boundaries(cuda, cluster):
    """As test_fps_kernel_ties_across_cta_boundaries, on the staged route
    forced: the lowest index wins every tie across the cluster's CTAs, the
    winner's coordinates read from its CTA's staged slice."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain

    base = np.random.RandomState(cluster + 200).randn(37, 3).astype(np.float32)
    N = 4096
    xyz = np.zeros((2, N, 3), np.float32)
    S = -(-N // cluster)
    for r in range(cluster):
        pos = r * S + np.random.RandomState(r + 7).permutation(S)[:37]
        xyz[:, pos] = base
        xyz[:, r * S:(r + 1) * S][np.all(xyz[:, r * S:(r + 1) * S] == 0, axis=-1)] = base[0]
    xyz = torch.from_numpy(xyz).to(cuda)
    got, route = fps_launch_counted(64, xyz, cluster=cluster, route="staged")
    assert route == "staged"
    want = farthest_point_sample_plain(64, xyz)
    assert torch.equal(got, want)
    assert (want[:, 1:38] < S).all()


def test_fps_staged_route_duplicate_points(cuda):
    """Eval's shape on a cloud of 40 distinct points, each repeated ~512
    times at shuffled places across both CTAs of every row: every step ties
    across warps, CTAs and the cluster, and once all 40 are picked every
    minimum is 0."""
    rng = np.random.RandomState(11)
    base = rng.randn(40, 3).astype(np.float32)
    xyz = np.stack([base[rng.randint(0, 40, 20480)] for _ in range(64)])
    xyz = torch.from_numpy(xyz).to(cuda)
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain

    got, route = fps_launch_counted(256, xyz)
    assert route == "staged"
    assert torch.equal(got, farthest_point_sample_plain(256, xyz))


@pytest.mark.parametrize("route", ["registers", "staged", "scratch"])
@pytest.mark.parametrize("B,N", [(8, 20480), (64, 20480), (3, 2048)])
def test_fps_every_route_forced(cuda, route, B, N):
    """Each route forced at the rule's cluster size gives the plain
    version's indices and is counted under its name; the register route
    cannot take eval's sa1 (B=64) at the size the rule picks."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain, fps_route

    xyz = torch.from_numpy(cloud(N + B, B, N, "scene")).to(cuda)
    if (B, route) == (64, "registers"):
        with pytest.raises(ValueError, match="register"):
            fps_route(xyz, route=route)
        return
    got, counted = fps_launch_counted(300, xyz, route=route)
    assert counted == route
    assert torch.equal(got, farthest_point_sample_plain(300, xyz))


@pytest.mark.parametrize(
    "B,N,M,radius,S,kind",
    [(1, 20480, 2048, 0.2, 64, "scene"), (8, 2048, 1024, 0.4, 64, "scene"), (2, 1024, 256, 0.3, 64, "normal"),
     (2, 300, 50, 1.5, 16, "grid"), (1, 100, 7, 0.01, 8, "normal")],
)
def test_ball_query_kernel_matches_plain(cuda, B, N, M, radius, S, kind):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    xyz = torch.from_numpy(cloud(B * N, B, N, kind)).to(cuda)
    q = xyz[:, :M].clone()
    q[0, -1] = 1000.0  # empty ball
    got = query_ball_point_cuda(radius, S, xyz, q)
    torch.cuda.synchronize()
    want = query_ball_point_plain(radius, S, xyz, q)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1][0, -1]) == 0


@pytest.mark.parametrize("segments", [None, 1, 2])
def test_ball_query_kernel_r2_boundary(cuda, segments):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda

    p = torch.tensor([[[0.19999999, 5e-05, 0.0], [1.0, 1.0, 1.0]]], device=cuda)
    idx, cnt = query_ball_point_cuda(0.2, 4, p, torch.zeros((1, 1, 3), device=cuda), segments=segments)
    assert int(cnt[0, 0]) == 1 and idx[0, 0].tolist() == [0, 0, 0, 0]


def crafted_balls(N, hits):
    """Points far from the origin except at the indices of ``hits``, which
    lie inside a ball of radius 0.5 around it: the query at the origin hits
    exactly those, in index order."""
    rng = np.random.RandomState(N)
    xyz = rng.uniform(2.0, 3.0, (1, N, 3)).astype(np.float32)
    xyz[0, hits] = rng.uniform(-0.25, 0.25, (len(hits), 3)).astype(np.float32)
    return xyz


# (N, hit indices, nsample, segments): the first nsample hits end where a
# tile (512 points) or a segment (1024 points when forced to 2 segments of
# 2048 points) ends, or are spread across segments; N off the tile; nsample
# above N; an empty ball
BALL_EDGES = {
    "fills-at-tile-end": (2000, list(range(448, 512)) + list(range(600, 700)), 64, None),
    "fills-at-segment-end": (2048, list(range(960, 1024)) + list(range(1024, 1100)), 64, 2),
    "spread-over-segments": (4096, [5, 1023, 1024, 2047, 2048, 3000, 4095], 64, 4),
    "segment-fills-early": (4096, list(range(0, 4096, 7)), 16, 4),
    "ragged-N": (1111, [0, 511, 512, 1023, 1024, 1110], 8, None),
    "nsample-above-N": (50, list(range(0, 50, 3)), 64, None),
    "empty": (3000, [], 32, 3),
}


@pytest.mark.parametrize("case", list(BALL_EDGES))
def test_ball_query_kernel_edges(cuda, case):
    """Bit-equal to the plain version, each crafted case at the default route
    and forced through both routes (1 segment, and split)."""
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    N, hits, S, segments = BALL_EDGES[case]
    xyz = torch.from_numpy(crafted_balls(N, hits)).to(cuda)
    q = torch.zeros((1, 3, 3), device=cuda)
    q[0, 1] = 2.5  # a second query among the far points
    q[0, 2] = 100.0  # an empty ball
    want = query_ball_point_plain(0.5, S, xyz, q)
    assert int(want[1][0, 0]) == min(S, len(hits))
    for seg in {segments, 1, 3}:
        got = query_ball_point_cuda(0.5, S, xyz, q, segments=seg)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), seg


@pytest.mark.parametrize("B,N,M", [(1, 20480, 2048), (2, 2048, 1024), (3, 1500, 77)])
def test_ball_query_kernel_both_routes_agree(cuda, B, N, M):
    """The same shape through one segment and through 2, 5 and the default
    number of segments; M not a multiple of the block's 128 queries."""
    from votenet_tpu_torch.ops.cuda.ballquery import (
        ballquery_route, query_ball_point_cuda, query_ball_point_plain)

    xyz = torch.from_numpy(cloud(N + M, B, N, "scene")).to(cuda)
    q = xyz[:, :M].clone()
    want = query_ball_point_plain(0.3, 64, xyz, q)
    sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    routes = {ballquery_route(B, N, M, sm, s)[0] for s in (1, 2, 5, None)}
    assert 1 in routes and len(routes) >= 2
    for s in (1, 2, 5, None):
        got = query_ball_point_cuda(0.3, 64, xyz, q, segments=s)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), s


def test_predictor_on_the_card_matches_cpu(cuda):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.predictor import VoteNetPredictor

    cfg = tiny_config()
    points = np.stack([synthetic_scene(np.random.RandomState(i), cfg)["points"] for i in range(2)])
    gpu = VoteNetPredictor(cfg, device=cuda, batch_size=2)
    cpu = VoteNetPredictor(cfg, {k: v.cpu() for k, v in gpu.model.state_dict().items()}, device="cpu")
    before = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches)
    g = gpu(points)
    after = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (5, 5)
    c = cpu(points)
    torch.testing.assert_close(g["bboxes"].cpu(), c["bboxes"], rtol=0, atol=1e-4)
    assert torch.equal(g["keep"].cpu(), c["keep"])


# live shapes of the full-width training step's scatters: (K = M*S, N, C)
SCATTER_SHAPES = {
    "sa2": (1024 * 64, 2048, 128),
    "sa3": (512 * 64, 1024, 256),
    "sa4": (256 * 64, 512, 256),
    "proposal": (256 * 64, 1024, 259),
}


def scatter_inputs(seed, B, K, N, C, device):
    rng = np.random.RandomState(seed)
    g = rng.randn(B, K, C).astype(np.float32)
    idx = rng.randint(0, N, size=(B, K)).astype(np.int32)
    return torch.from_numpy(g).to(device), torch.from_numpy(idx).to(device)


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("layer", list(SCATTER_SHAPES))
def test_scatter_kernel_matches_plain(cuda, layer, B):
    """Bit-equal to the plain version run on the CPU (index_add_ adds in
    index order there); within 1e-5 of scale of the plain version on the
    card, whose atomics add in another order."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

    K, N, C = SCATTER_SHAPES[layer]
    g, idx = scatter_inputs(B + C, B, K, N, C, cuda)
    got = scatter_add_cuda(g, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), scatter_add_plain(g.cpu(), idx.cpu(), N))
    torch.testing.assert_close(got, scatter_add_plain(g, idx, N), rtol=0, atol=1e-5 * float(got.abs().max()))


@pytest.mark.parametrize("C", [1, 3, 131, 259, 600])
@pytest.mark.parametrize("B", [1, 2, 8])
def test_scatter_kernel_edge_cases(cuda, B, C):
    """Bit-equal to a sequential np.add.at: one destination takes most of
    the indices (a segment of thousands, as the ball query's repeats make),
    empty rows, indices out of range (negative and >= N) dropped, odd and
    wide C, K not a multiple of the sort's chunk."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    K, N = 5000, 300
    rng = np.random.RandomState(B * 1000 + C)
    idx = rng.randint(0, N // 2, (B, K)).astype(np.int32)  # rows >= N/2 stay empty
    idx[:, : K // 2] = 7
    idx[:, 3::97] = -1
    idx[:, 5::89] = N + 4
    g = rng.randn(B, K, C).astype(np.float32)
    got = scatter_add_cuda(torch.from_numpy(g).to(cuda), torch.from_numpy(idx).to(cuda), N)
    torch.cuda.synchronize()
    want = np.zeros((B, N, C), np.float32)
    for b in range(B):
        ok = (idx[b] >= 0) & (idx[b] < N)
        np.add.at(want[b], idx[b][ok], g[b][ok])
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert not got[:, N // 2:].any()


@pytest.mark.parametrize("B", [1, 2, 8])
def test_scatter_kernel_all_to_one_and_tiny(cuda, B):
    """Every index on one destination; and K=5."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    for K, N, C, dest in [(3000, 50, 131, 49), (5, 9, 3, None)]:
        rng = np.random.RandomState(K + B)
        idx = np.full((B, K), dest, np.int32) if dest is not None else rng.randint(0, N, (B, K)).astype(np.int32)
        g = rng.randn(B, K, C).astype(np.float32)
        got = scatter_add_cuda(torch.from_numpy(g).to(cuda), torch.from_numpy(idx).to(cuda), N)
        torch.cuda.synchronize()
        want = np.zeros((B, N, C), np.float32)
        for b in range(B):
            np.add.at(want[b], idx[b], g[b])
        np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_scatter_kernel_is_deterministic(cuda):
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    K, N, C = SCATTER_SHAPES["sa2"]
    g, idx = scatter_inputs(0, 8, K, N, C, cuda)
    a = scatter_add_cuda(g, idx, N)
    b = scatter_add_cuda(g, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize(
    "B,K,N,C,skip",
    [(1, 256 * 64, 512, 259, 3), (2, 777, 100, 131, 3), (3, 5, 70, 1, 0), (1, 1000, 65536 * 2, 16, 0),
     (1, 3000, 40, 1100, 0), (1, 2048 * 2048 + 5, 2048, 4, 0)],
    ids=["sa4-B1", "ragged", "tiny", "dest-tiles", "wide-columns", "doubled-chunk"],
)
def test_scatter_kernel_equals_add_at(cuda, B, K, N, C, skip):
    """Bit-equal to a sequential np.add.at, through ops.scatter_add as the
    group_point backward calls it (the live columns after ``skip``): K not a
    multiple of 32, N over several destination tiles of the sort, C over
    several warps a row, a K whose counts scratch doubles the chunk."""
    from votenet_tpu_torch.ops import scatter_add

    g, idx = scatter_inputs(K + N, B, K, N, C, cuda)
    got = scatter_add(g[..., skip:], idx, N)
    torch.cuda.synchronize()
    gn, inp = g[..., skip:].cpu().numpy(), idx.cpu().numpy()
    want = np.zeros((B, N, C - skip), np.float32)
    for b in range(B):
        np.add.at(want[b], inp[b], gn[b])
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def bf16_add_at(g, idx, N):
    """Sequential np.add.at of the updates rounded to bf16 (round to nearest
    even, as ``astype(bfloat16)``), dropping indices outside [0, N)."""
    rounded = torch.from_numpy(g).to(torch.bfloat16).float().numpy()
    out = np.zeros((g.shape[0], N, g.shape[2]), np.float32)
    for b in range(g.shape[0]):
        ok = (idx[b] >= 0) & (idx[b] < N)
        np.add.at(out[b], idx[b][ok], rounded[b][ok])
    return out


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("layer", list(SCATTER_SHAPES))
def test_scatter_fast_bf16_kernel_matches_plain(cuda, layer, B):
    """The fast_bf16 variant at the training step's shapes: bit-equal to its
    plain version run on the CPU and to np.add.at of the rounded updates;
    it counts its launches apart from the exact variant's."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

    K, N, C = SCATTER_SHAPES[layer]
    g, idx = scatter_inputs(B + C + 1, B, K, N, C, cuda)
    exact, fast = scatter_add_cuda.launches, scatter_add_cuda.fast_bf16.launches
    got = scatter_add_cuda(g, idx, N, "fast_bf16")
    torch.cuda.synchronize()
    assert (scatter_add_cuda.launches - exact, scatter_add_cuda.fast_bf16.launches - fast) == (0, 1)
    assert torch.equal(got.cpu(), scatter_add_plain(g.cpu(), idx.cpu(), N, "fast_bf16"))
    if B == 2:
        np.testing.assert_array_equal(got.cpu().numpy(), bf16_add_at(g.cpu().numpy(), idx.cpu().numpy(), N))
    assert not torch.equal(got, scatter_add_cuda(g, idx, N))  # the rounding is live


@pytest.mark.parametrize("B", [1, 8])
def test_scatter_fast_bf16_kernel_edges(cuda, B):
    """Rounding ties (f32 values halfway between two bf16 values round to
    the even one), a segment of thousands on one row, empty rows, indices
    out of range dropped, odd C."""
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    K, N, C = 5000, 300, 131
    rng = np.random.RandomState(B)
    idx = rng.randint(0, N // 2, (B, K)).astype(np.int32)
    idx[:, : K // 2] = 7
    idx[:, 3::97] = -1
    idx[:, 5::89] = N + 4
    g = rng.randn(B, K, C).astype(np.float32)
    bits = g.view(np.uint32)
    bits[:, ::3] = (bits[:, ::3] & 0xFFFF0000) | 0x8000  # exact ties
    got = scatter_add_cuda(torch.from_numpy(g).to(cuda), torch.from_numpy(idx).to(cuda), N, "fast_bf16")
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), bf16_add_at(g, idx, N))
    assert not got[:, N // 2:].any()


def test_scatter_add_modes_on_the_card(cuda):
    """ops.scatter_add routes by mode: an f32 cotangent in fast_bf16 mode
    launches the fast variant; a bf16 cotangent takes the exact one in
    either mode, and its result is exact."""
    from votenet_tpu_torch.ops import scatter_add
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    g, idx = scatter_inputs(3, 2, 777, 100, 131, cuda)
    counts = lambda: (scatter_add_cuda.launches, scatter_add_cuda.fast_bf16.launches)  # noqa: E731
    c0 = counts()
    scatter_add(g, idx, 100, "fast_bf16")
    c1 = counts()
    hb = g.to(torch.bfloat16)
    fast = scatter_add(hb, idx, 100, "fast_bf16")
    exact = scatter_add(hb, idx, 100, "exact")
    c2 = counts()
    torch.cuda.synchronize()
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (0, 1)
    assert (c2[0] - c1[0], c2[1] - c1[1]) == (2, 0)
    assert torch.equal(fast, exact)
    np.testing.assert_array_equal(exact.cpu().numpy(), bf16_add_at(hb.float().cpu().numpy(), idx.cpu().numpy(), 100))


@pytest.mark.parametrize("mode", [dict(compute_dtype="bfloat16"), dict(mixed_precision=True),
                                  dict(scatter_precision="fast_bf16")], ids=["bf16", "mixed", "fast_scatter"])
def test_precision_modes_train_step_on_the_card(cuda, mode):
    """One tiny training step per precision mode on the card and on the
    CPU: the scatters launched per mode (bf16 and fast_bf16: 4 fast ones;
    mixed: the bf16 feature gathers of sa2-sa4 exact, the f32 proposal
    layer's in the Config's mode); losses finite, and within 1e-4 of the
    CPU's where the forward is f32 (a bf16 forward's votes can move a point
    across a ball's boundary between the two devices)."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config(**{"scatter_precision": "fast_bf16", **mode})
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    gpu = create_train_state(cfg, 10, device=cuda)
    cpu = create_train_state(cfg, 10, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    step = make_train_step(cfg)
    before = (scatter_add_cuda.launches, scatter_add_cuda.fast_bf16.launches)
    mg = step(gpu, batch)
    got = (scatter_add_cuda.launches - before[0], scatter_add_cuda.fast_bf16.launches - before[1])
    assert got == ((3, 1) if "mixed_precision" in mode else (0, 4))
    mc = step(cpu, batch)
    for k in mg:
        assert np.isfinite(float(mg[k])), k
        if mode == dict(scatter_precision="fast_bf16"):
            assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(1.0, abs(float(mc[k]))), k
    assert all(p.dtype == torch.float32 for p in gpu.model.parameters())


def test_train_step_on_the_card_matches_cpu(cuda):
    """One tiny training step on the card and on the CPU from the same
    weights: each layer's scatter launched once (sa2-sa4 and the proposal
    layer), losses and updated weights close."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config()
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    gpu = create_train_state(cfg, 10, device=cuda)
    cpu = create_train_state(cfg, 10, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    step = make_train_step(cfg)
    before = scatter_add_cuda.launches
    mg = step(gpu, batch)
    assert scatter_add_cuda.launches - before == 4
    mc = step(cpu, batch)
    for k in mg:
        assert abs(float(mg[k]) - float(mc[k])) <= 1e-4 * max(1.0, abs(float(mc[k]))), k
    for (name, a), b in zip(gpu.model.state_dict().items(), cpu.model.state_dict().values()):
        assert float((a.cpu() - b).abs().max()) <= 2 * cfg.base_lr + 1e-4, name
    assert gpu.step == cpu.step == 1


def chain_inputs(seed, B, N, M, S, widths):
    """Seeded arguments of the fused function (the scales of test_pallas.py)."""
    rng = np.random.RandomState(seed)
    h_all = rng.randn(B, N, widths[0]).astype(np.float32)
    idx = rng.randint(0, N, size=(B, M, S)).astype(np.int32)
    sh0 = rng.randn(B, M, widths[0]).astype(np.float32)
    s0 = (rng.rand(widths[0]) + 0.5).astype(np.float32)
    layers = [
        (
            (rng.randn(widths[i], widths[i + 1]) * 0.1).astype(np.float32),
            (rng.rand(widths[i + 1]) + 0.5).astype(np.float32),
            (rng.randn(widths[i + 1]) * 0.1).astype(np.float32),
        )
        for i in range(len(widths) - 1)
    ]
    return h_all, idx, sh0, s0, layers


# live shapes of the five fused calls of a full-width eval forward: (N, M, S, widths)
SAMLP_SHAPES = {
    "sa1": (20480, 2048, 64, [64, 64, 128]),
    "sa2": (2048, 1024, 64, [128, 128, 256]),
    "sa3": (1024, 512, 64, [128, 128, 256]),
    "sa4": (512, 256, 64, [128, 128, 256]),
    "proposal": (1024, 256, 64, [128, 128, 128]),
    "tiny-widths": (256, 64, 8, [16, 16, 32]),
    "ragged-M": (300, 77, 16, [32, 32, 64]),
    "odd-widths-S8": (100, 33, 8, [5, 7, 13, 3]),
    "S-past-a-chunk": (500, 9, 100, [20, 40, 24]),
    "S16-odd-widths": (200, 70, 16, [13, 21, 37]),
    "S24": (300, 50, 24, [32, 32, 64]),
    "S24-odd-widths": (300, 29, 24, [11, 30, 19]),
    "S5": (90, 41, 5, [8, 24, 16]),
    "wide-K-S100": (400, 6, 100, [128, 256, 64]),
}


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("case", list(SAMLP_SHAPES))
def test_samlp_kernel_matches_plain(cuda, case, B):
    """Within 1e-5 of the output's scale of the plain version on the card and
    on the CPU (3xTF32 matmuls, summed in another order): the five live
    shapes, the tiny config's widths, M not a multiple of the centres a tile
    takes, widths not a multiple of 8 with S in {5, 8, 16, 24}, S above the
    64 rows of a tile, and K slices of 16 channels (a 256-wide hidden layer
    with S=100)."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    N, M, S, widths = SAMLP_SHAPES[case]
    args = chain_inputs(B * M + S, B, N, M, S, widths)
    cpu = [torch.from_numpy(a) for a in args[:4]] + [[tuple(torch.from_numpy(x) for x in lay) for lay in args[4]]]
    card = [a.to(cuda) for a in cpu[:4]] + [[tuple(x.to(cuda) for x in lay) for lay in cpu[4]]]
    before = fused_sa_mlp_pool_cuda.launches
    got = fused_sa_mlp_pool_cuda(*card)
    torch.cuda.synchronize()
    assert fused_sa_mlp_pool_cuda.launches == before + 1
    for want in (fused_sa_mlp_pool_plain(*card).cpu(), fused_sa_mlp_pool_plain(*cpu)):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_samlp_kernel_gathers_out_of_range_indices_as_zero_rows(cuda):
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    h_all, idx, sh0, s0, layers = chain_inputs(3, 1, 40, 6, 8, [8, 8, 16])
    bad = idx.copy()
    bad[0, 2, 3] = 40
    bad[0, 4, 0] = -1
    zero_row = np.concatenate([h_all, np.zeros((1, 1, 8), np.float32)], axis=1)
    ref = idx.copy()
    ref[0, 2, 3] = ref[0, 4, 0] = 40  # the appended row of zeros
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    lay = [tuple(dev(x) for x in lay) for lay in layers]
    got = fused_sa_mlp_pool_cuda(dev(h_all), dev(bad), dev(sh0), dev(s0), lay)
    want = fused_sa_mlp_pool_plain(dev(zero_row), dev(ref), dev(sh0), dev(s0), lay)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_eval_on_the_card_launches_samlp_and_matches_cpu(cuda):
    """A tiny packed-predictor evaluation with samlp on: each forward
    launches each kernel 5 times; the detections equal the CPU path's."""
    from votenet_tpu_torch.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu_torch.eval import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    cfg = tiny_config(samlp="on")
    scenes = synthetic_scenes(0, cfg, 3)
    pairs = [(int(s["data_idx"]), s["points"]) for s in scenes]
    cpu = VoteNet(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.proposal.mlp2.dense2.bias[1] += 3.0  # candidates for NMS
    gpu = VoteNet(cfg)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(cuda)
    ev = Evaluator(cfg, synthetic_gt_all(scenes), batch_size=2)
    before = fused_sa_mlp_pool_cuda.launches
    pg = ev.predictions_for_scenes(make_packed_predict_fn(gpu, cfg), DeviceSceneCache(pairs, 2, cuda))
    assert fused_sa_mlp_pool_cuda.launches - before == 10  # 2 batches
    pc = ev.predictions_for_scenes(make_packed_predict_fn(cpu, cfg), pairs)
    assert sum(len(v) for v in pc.values()) > 0
    for img_id in pc:
        assert [d[0] for d in pg[img_id]] == [d[0] for d in pc[img_id]]
        for (_, a, sa), (_, b, sb) in zip(pg[img_id], pc[img_id]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * max(1.0, float(np.abs(b).max())))
            assert sa == pytest.approx(sb, rel=1e-4, abs=1e-4)


def test_samlp_kernel_is_3xtf32(cuda):
    """Inputs with full 24-bit mantissas at magnitudes where one TF32 product
    per f32 product (1xTF32) lands outside 1e-5 of scale: the kernel stays
    inside, so it sums all three terms."""
    from votenet_tpu_torch.ops.cuda.samlp import chain_3xtf32, fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    h_all, idx, sh0, s0, layers = chain_inputs(11, 2, 600, 64, 64, [128, 128, 256])
    rng = np.random.RandomState(12)
    h_all = (h_all * 37.0 + rng.uniform(-1, 1, h_all.shape) * 3.3).astype(np.float32)
    layers = [((w * 3.0 + 1e-3 * rng.randn(*w.shape)).astype(np.float32), s, t) for w, s, t in layers]
    cpu = [torch.from_numpy(a) for a in (h_all, idx, sh0, s0)] + [[tuple(torch.from_numpy(x) for x in lay) for lay in layers]]
    card = [a.to(cuda) for a in cpu[:4]] + [[tuple(x.to(cuda) for x in lay) for lay in cpu[4]]]
    want = fused_sa_mlp_pool_plain(*cpu)
    tol = 1e-5 * float(want.abs().max())
    one = chain_3xtf32(*cpu, terms=1)
    assert float((one - want).abs().max()) > tol  # 1xTF32 would fail
    got = fused_sa_mlp_pool_cuda(*card)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol)


def test_samlp_kernel_takes_transposed_linear_weights(cuda):
    """W as the model passes it, a transposed view of nn.Linear's (w_out,
    w_in) weight: the same result as a contiguous copy."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    h_all, idx, sh0, s0, layers = chain_inputs(4, 1, 200, 33, 64, [64, 64, 128])
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    contiguous = [(dev(w), dev(s), dev(t)) for w, s, t in layers]
    viewed = [(dev(np.ascontiguousarray(w.T)).t(), dev(s), dev(t)) for w, s, t in layers]
    assert not viewed[0][0].is_contiguous()
    a = fused_sa_mlp_pool_cuda(dev(h_all), dev(idx), dev(sh0), dev(s0), contiguous)
    b = fused_sa_mlp_pool_cuda(dev(h_all), dev(idx), dev(sh0), dev(s0), viewed)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_checkpoint_roundtrip_on_the_card(cuda, tmp_path):
    """A full-width TrainState on the card after one B=2 step, saved and
    restored into a state of another seed: parameters, batch-norm
    statistics, Adam's moments (on the card) and steps, and state.step
    bit-equal."""
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import create_train_state, make_train_step
    from votenet_tpu_torch.utils import checkpoint as ckpt

    cfg = default_config()
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(0), device=cuda)
    make_train_step(cfg)(state, next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes)))
    ckpt.save_checkpoint(str(tmp_path), state, 1)
    other = create_train_state(cfg, 512, torch.Generator().manual_seed(1), device=cuda)
    assert ckpt.restore_checkpoint(str(tmp_path), other)[1] == 1 and other.step == state.step == 1
    want, got = state.model.state_dict(), other.model.state_dict()
    assert list(want) == list(got)
    assert all(got[k].is_cuda and torch.equal(got[k], want[k]) for k in want)
    for pa, pb in zip(state.model.parameters(), other.model.parameters()):
        sa, sb = state.optimizer.state[pa], other.optimizer.state[pb]
        assert sb["exp_avg"].is_cuda and sb["exp_avg_sq"].is_cuda
        assert all(torch.equal(sa[k].cpu(), sb[k].cpu()) for k in ("exp_avg", "exp_avg_sq", "step"))


def test_device_timeit_agrees_with_chip_smoke(cuda):
    """utils.profiling.device_timeit against chip_smoke.py's cuda_ms on FPS
    at sa1's B=8 shape, timed in turns: within 10% of the two cuda_ms
    readings' range."""
    import chip_smoke
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.utils.profiling import device_timeit

    xyz = torch.from_numpy(cloud(0, 8, 20480, "scene")).to(cuda)

    def fn():
        return farthest_point_sample_cuda(2048, xyz)

    a = chip_smoke.cuda_ms(fn, 10)
    ms = device_timeit(fn, iters=10) * 1e3
    b = chip_smoke.cuda_ms(fn, 10)
    assert 0.9 * min(a, b) <= ms <= 1.1 * max(a, b), (a, ms, b)


# ---------------------------------------------------------------- variants

# the bf16 samlp variant against its plain version, of the output's scale:
# tests/test_torch_variants.py's tolerance, for the same reason (an
# activation one f32 ulp apart rounds to the neighbouring bf16 value)
BF16_TOL = 1.5e-3


def card_chain(args, cuda):
    """chain_inputs' arrays as (CPU tensors, the same on the card)."""
    cpu = [torch.from_numpy(a) for a in args[:4]] + [[tuple(torch.from_numpy(x) for x in lay) for lay in args[4]]]
    return cpu, [a.to(cuda) for a in cpu[:4]] + [[tuple(x.to(cuda) for x in lay) for lay in cpu[4]]]


@pytest.mark.parametrize("route", ["resident", "ring"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("case", list(SAMLP_SHAPES))
def test_samlp_bf16_kernel_matches_plain(cuda, case, B, route):
    """The bf16-operand kernel within BF16_TOL of its plain version on the
    card and on the CPU, on both routes, at the f32 kernel's shapes (ks 64
    and 32 slices, S in {5, 8, 16, 24, 64, 100}, odd widths); its launches
    count apart."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    N, M, S, widths = SAMLP_SHAPES[case]
    cpu, card = card_chain(chain_inputs(B * M + S, B, N, M, S, widths), cuda)
    before = (fused_sa_mlp_pool_cuda.launches, fused_sa_mlp_pool_cuda.bf16.launches)
    got = fused_sa_mlp_pool_cuda(*card, precision="bf16", route=route)
    torch.cuda.synchronize()
    assert (fused_sa_mlp_pool_cuda.launches, fused_sa_mlp_pool_cuda.bf16.launches) == (before[0], before[1] + 1)
    for want in (fused_sa_mlp_pool_plain(*card, precision="bf16").cpu(), fused_sa_mlp_pool_plain(*cpu, precision="bf16")):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=BF16_TOL * float(want.abs().max()))


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("case", list(SAMLP_SHAPES))
def test_samlp_bf16_routes_are_bit_equal(cuda, case, B):
    """The resident chain and the ring run the same k16 products in the same
    order: the same bits, and reruns give them again."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    N, M, S, widths = SAMLP_SHAPES[case]
    _, card = card_chain(chain_inputs(B * M + S + 2, B, N, M, S, widths), cuda)
    resident = fused_sa_mlp_pool_cuda(*card, precision="bf16", route="resident")
    ring = fused_sa_mlp_pool_cuda(*card, precision="bf16", route="ring")
    again = fused_sa_mlp_pool_cuda(*card, precision="bf16")
    torch.cuda.synchronize()
    assert torch.equal(resident, ring) and torch.equal(resident, again)


def test_samlp_bf16_counts_its_own_launches(cuda):
    """Through the op: a bf16 call adds one to the bf16 kernel's counter and
    none to the 3xTF32 kernel's, an f32 call the reverse."""
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    _, card = card_chain(chain_inputs(5, 2, 300, 40, 64, [64, 64, 128]), cuda)
    counts = lambda: (fused_sa_mlp_pool_cuda.launches, fused_sa_mlp_pool_cuda.bf16.launches)  # noqa: E731
    before = counts()
    ops.fused_sa_mlp_pool(*card, "bf16")
    assert counts() == (before[0], before[1] + 1)
    ops.fused_sa_mlp_pool(*card, "f32")
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("route", ["resident", "ring"])
@pytest.mark.parametrize("case", ["sa1", "sa2", "proposal"])
def test_samlp_bf16_kernel_is_not_3xtf32(cuda, case, route):
    """At live widths the bf16 kernel lies within BF16_TOL of the bf16 plain
    version and the 3xTF32 kernel outside it; the bf16 kernel lies outside
    the f32 kernel's 1e-5 of the f32 plain version."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    N, M, S, widths = SAMLP_SHAPES[case]
    _, card = card_chain(chain_inputs(M + S + 1, 2, N, M, S, widths), cuda)
    bf16 = fused_sa_mlp_pool_cuda(*card, precision="bf16", route=route)
    tf32 = fused_sa_mlp_pool_cuda(*card)
    want, want_f32 = fused_sa_mlp_pool_plain(*card, precision="bf16"), fused_sa_mlp_pool_plain(*card)
    torch.cuda.synchronize()
    tol = BF16_TOL * float(want.abs().max())
    assert float((bf16 - want).abs().max()) <= tol < float((tf32 - want).abs().max())
    assert float((bf16 - want_f32).abs().max()) > 1e-5 * float(want_f32.abs().max())


def test_samlp_bf16_kernel_gathers_out_of_range_indices_as_zero_rows(cuda):
    """An index outside [0, N) stages a row of zeros on both routes, by bulk
    copies (h_all 16-byte aligned) and by 8-byte cp.async (h_all at an
    address 8 bytes past a 16-byte boundary)."""
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain, stage_chunk

    h_all, idx, sh0, s0, layers = chain_inputs(3, 1, 40, 6, 8, [8, 8, 16])
    bad = idx.copy()
    bad[0, 2, 3] = 40
    bad[0, 4, 0] = -1
    zero_row = np.concatenate([h_all, np.zeros((1, 1, 8), np.float32)], axis=1)
    ref = idx.copy()
    ref[0, 2, 3] = ref[0, 4, 0] = 40  # the appended row of zeros
    dev = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    lay = [tuple(dev(x) for x in lay) for lay in layers]
    shifted = torch.zeros(h_all.size + 2, dtype=torch.float32, device=cuda)[2:].view(h_all.shape)
    shifted.copy_(dev(h_all))
    assert stage_chunk(8, dev(h_all)) == 0 and stage_chunk(8, shifted) == 8
    want = fused_sa_mlp_pool_plain(dev(zero_row), dev(ref), dev(sh0), dev(s0), lay, precision="bf16")
    for h in (dev(h_all), shifted):
        for route in ("resident", "ring"):
            got = fused_sa_mlp_pool_cuda(h, dev(bad), dev(sh0), dev(s0), lay, precision="bf16", route=route)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=BF16_TOL * float(want.abs().max()))


def emit_reference(xyz, q, radius, S):
    """(idx, cnt, gxyz) of the CPU plain version, on the card."""
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_emit_xyz_plain

    return [a.to(xyz.device) for a in query_ball_point_emit_xyz_plain(radius, S, xyz.cpu(), q.cpu())]


@pytest.mark.parametrize(
    "B,N,M,radius,S,kind",
    [(1, 20480, 2048, 0.2, 64, "scene"), (8, 2048, 1024, 0.4, 64, "scene"), (2, 1024, 256, 0.3, 64, "normal"),
     (2, 300, 50, 1.5, 16, "grid"), (1, 100, 7, 0.01, 8, "normal")],
)
@pytest.mark.parametrize("segments", [None, 1, 3])
def test_ball_query_emit_kernel_matches_query_and_gather(cuda, B, N, M, radius, S, kind, segments):
    """idx, cnt and gxyz bit-equal to the production kernel + group_point on
    the card and to the CPU plain version, on both routes (the rule's, one
    segment, three); an empty ball gets point 0's coordinates."""
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_emit_xyz_cuda

    xyz = torch.from_numpy(cloud(B * N + 1, B, N, kind)).to(cuda)
    q = xyz[:, :M].clone()
    q[0, -1] = 1000.0  # empty ball
    before = (query_ball_point_cuda.launches, query_ball_point_emit_xyz_cuda.launches)
    idx, cnt, gxyz = query_ball_point_emit_xyz_cuda(radius, S, xyz, q, segments=segments)
    torch.cuda.synchronize()
    assert (query_ball_point_cuda.launches, query_ball_point_emit_xyz_cuda.launches) == (before[0], before[1] + 1)
    want_idx, want_cnt = query_ball_point_cuda(radius, S, xyz, q, segments=segments)
    assert torch.equal(idx, want_idx) and torch.equal(cnt, want_cnt)
    assert torch.equal(gxyz, ops.group_point(xyz, want_idx))
    assert all(torch.equal(a, b) for a, b in zip((idx, cnt, gxyz), emit_reference(xyz, q, radius, S)))
    assert int(cnt[0, -1]) == 0 and torch.equal(gxyz[0, -1], xyz[0, 0].expand(S, 3))


@pytest.mark.parametrize("case", list(BALL_EDGES))
def test_ball_query_emit_kernel_edges(cuda, case):
    """The crafted balls of test_ball_query_kernel_edges (hits ending at a
    tile's or a segment's end, spread over segments, N off the tile, nsample
    above N, empty), each through both routes: bit-equal to the CPU plain
    version."""
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_emit_xyz_cuda

    N, hits, S, segments = BALL_EDGES[case]
    xyz = torch.from_numpy(crafted_balls(N, hits)).to(cuda)
    q = torch.zeros((1, 3, 3), device=cuda)
    q[0, 1] = 2.5
    q[0, 2] = 100.0
    want = emit_reference(xyz, q, 0.5, S)
    for seg in {segments, 1, 3}:
        got = query_ball_point_emit_xyz_cuda(0.5, S, xyz, q, segments=seg)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), seg


def test_ball_query_emit_kernel_keeps_the_bits(cuda):
    """Copies, not arithmetic: -0.0, subnormal and large coordinates come back
    bit for bit (compared as int32), on both routes."""
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_emit_xyz_cuda

    xyz = torch.from_numpy(crafted_balls(600, [0, 3, 300, 599])).to(cuda)
    xyz[0, 3] = torch.tensor([-0.0, 1e-40, -0.0])
    xyz[0, 300] = torch.tensor([0.1, -0.0, 3e-39])
    xyz[0, 550] = torch.tensor([3e38, 3e38, 3e38])
    q = torch.zeros((1, 2, 3), device=cuda)
    q[0, 1] = 50.0
    want = emit_reference(xyz, q, 0.5, 8)
    for seg in (1, 2):
        got = query_ball_point_emit_xyz_cuda(0.5, 8, xyz, q, segments=seg)
        torch.cuda.synchronize()
        assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32)), seg


@pytest.mark.parametrize(
    "B,N,npoint,kind",
    [(1, 20480, 2048, "scene"), (2, 20480, 2048, "scene"), (8, 20480, 2048, "scene"), (8, 2048, 1024, "scene"),
     (3, 1111, 97, "normal"), (2, 2048, 300, "grid"), (1, 64, 1, "normal"), (2, 70000, 128, "normal"),
     (2, 20000, 200, "normal"), (1, 100, 100, "normal"), (2, 300, 300, "grid"), (16, 512, 256, "normal")],
)
def test_fps_noscalar_kernel_matches_production(cuda, B, N, npoint, kind):
    """The noscalar variant's indices equal the production kernel's and the
    plain version's at the production rule's route: the prototype's shapes
    (1, 2 and 8 x 20480 -> 2048), 16 CTAs a row at 70000 points, ragged N,
    one CTA, npoint 1 and N, ties, any B; its launches count apart."""
    from votenet_tpu_torch.ops.cuda.fps import (
        farthest_point_sample_cuda, farthest_point_sample_plain, fps_rowwise_noscalar_cuda)

    xyz = torch.from_numpy(cloud(B + N + 1, B, N, kind)).to(cuda)
    before = (farthest_point_sample_cuda.launches, fps_rowwise_noscalar_cuda.launches)
    got = fps_rowwise_noscalar_cuda(npoint, xyz)
    torch.cuda.synchronize()
    assert (farthest_point_sample_cuda.launches, fps_rowwise_noscalar_cuda.launches) == (before[0], before[1] + 1)
    assert torch.equal(got, farthest_point_sample_cuda(npoint, xyz))
    assert torch.equal(got, farthest_point_sample_plain(npoint, xyz))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("N,kind", [(20480, "scene"), (5000, "normal"), (2048, "grid")])
def test_fps_noscalar_kernel_every_cluster_size(cuda, cluster, N, kind):
    """Every cluster size, forced; 20480 points at one CTA would need the
    global-scratch route, which the variant refuses."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain, fps_rowwise_noscalar_cuda

    xyz = torch.from_numpy(cloud(cluster + N, 2, N, kind)).to(cuda)
    if cluster * 32 * 256 < N:
        with pytest.raises(ValueError, match="registers"):
            fps_rowwise_noscalar_cuda(256, xyz, cluster=cluster)
        return
    got = fps_rowwise_noscalar_cuda(256, xyz, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(256, xyz))


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_fps_noscalar_kernel_ties_across_cta_boundaries(cuda, cluster):
    """As test_fps_kernel_ties_across_cta_boundaries: every step ties across
    the cluster's CTAs and the lowest index wins; the pick's coordinates
    then come from the CTA that owns it."""
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_plain, fps_rowwise_noscalar_cuda

    base = np.random.RandomState(cluster + 100).randn(37, 3).astype(np.float32)
    N = 4096
    xyz = np.zeros((1, N, 3), np.float32)
    S = -(-N // cluster)
    for r in range(cluster):
        pos = r * S + np.random.RandomState(r).permutation(S)[:37]
        xyz[0, pos] = base
        xyz[0, r * S:(r + 1) * S][np.all(xyz[0, r * S:(r + 1) * S] == 0, axis=-1)] = base[0]
    xyz = torch.from_numpy(xyz).to(cuda)
    got = fps_rowwise_noscalar_cuda(64, xyz, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(got, farthest_point_sample_plain(64, xyz))


def test_fps_noscalar_refuses_the_scratch_route(cuda):
    from votenet_tpu_torch.ops.cuda.fps import fps_rowwise_noscalar_cuda

    with pytest.raises(ValueError, match="registers"):
        fps_rowwise_noscalar_cuda(8, torch.zeros((1, 140000, 3), device=cuda))


# ------------------------------------------------------ multi-device on one card

def test_distributed_step_at_world_size_1_is_the_plain_step(cuda):
    """chip_smoke.py's phase 19 at tiny widths: a one-rank NCCL group; the
    distributed path's losses, gradients and statistics bit-equal to the
    plain path's, and its step's launches."""
    import chip_smoke
    from votenet_tpu_torch.data.synthetic import synthetic_scenes

    cfg = tiny_config()
    assert chip_smoke.phase_dp_world1(cfg, synthetic_scenes(0, cfg, 8)) == chip_smoke.step_launches(cfg, group=True)


def test_two_ranks_share_the_card(cuda):
    """chip_smoke.py's phases 20-21 at tiny widths: dp=2 and sp=2 over gloo,
    two spawned ranks on the one card, against the single-device step, ops
    and forward."""
    import chip_smoke
    from votenet_tpu_torch.data.synthetic import synthetic_scenes

    cfg = tiny_config()
    paths = chip_smoke.phase_two_ranks(cfg, synthetic_scenes(0, cfg, 8), preset="tiny")
    assert paths["dp2_gloo_step"] == chip_smoke.step_launches(cfg, group=True)
    assert paths["sp2_forward"]["fps"] == 4 and paths["sp2_ops"]["scatter"] == 1


# ------------------------------------- NMS, the fast_bf16 ball query, remat, the dead paths

def objectness_for(cand, rng):
    """(B, N, 2) logits whose second exceeds the first exactly where ``cand``."""
    base = rng.randn(*cand.shape).astype(np.float32)
    gap = rng.uniform(1e-3, 1.0, cand.shape).astype(np.float32)
    return torch.from_numpy(np.stack([base, np.where(cand, base + gap, base - gap)], -1).astype(np.float32))


@pytest.mark.parametrize("B,N,p_cand,levels", [(1, 256, 0.3, 3), (8, 256, 0.6, 7), (3, 1000, 0.2, 2),
                                               (2, 33, 0.9, 1), (4, 1024, 0.5, 50)])
def test_nms_kernel_matches_both_plain_versions(cuda, B, N, p_cand, levels):
    """Random IoU relations (any pattern, scores tied in ``levels`` values,
    N off a multiple of 32 and at the 1024 limit): the kernel's keep mask,
    from its own order and candidates, equals its walk's twin and the Jacobi
    loop's over torch.argsort's order, on the card."""
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda, nms3d_greedy_plain
    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

    rng = np.random.RandomState(B * N)
    iou = torch.from_numpy(rng.rand(B, N, N).astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.randint(0, levels, (B, N)).astype(np.float32)).to(cuda)
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    cand_np = rng.rand(B, N) < p_cand
    cand = torch.from_numpy(cand_np).to(cuda)
    got = nms3d_greedy_cuda(iou, scores, objectness_for(cand_np, rng).to(cuda), 0.7)
    torch.cuda.synchronize()
    assert torch.equal(got, nms3d_greedy_plain(iou, order, cand, 0.7))
    assert torch.equal(got, nms3d_jacobi_plain(iou, order, cand, 0.7))


def random_box_batch(seed, B, N):
    """(corners, scores, objectness) of B x N random boxes in a 4 m room."""
    from votenet_tpu_torch.models.decode import get_3d_bbox

    rng = np.random.RandomState(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    corners = get_3d_bbox(f(rng.uniform(0.3, 2.0, (B, N, 3))), f(rng.uniform(0, 2 * np.pi, (B, N))),
                          f(rng.uniform(-2, 2, (B, N, 3))))
    return corners, f(rng.randint(0, 20, (B, N))), f(rng.randn(B, N, 2))


@pytest.mark.parametrize("B", [1, 8])
def test_nms_on_the_card_syncs_nowhere_and_matches_cpu(cuda, B):
    """``ops.nms3d`` on CUDA tensors runs under the sync debug mode "error"
    (any host sync raises) and launches the IoU and greedy kernels once
    each; its keep mask is the CPU's ``ops.nms3d``'s, bit for bit (the IoU
    kernel computes the CPU's floats), and on the CPU's IoU floats the
    greedy kernel gives it too."""
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda

    corners, scores, obj = random_box_batch(B, B, 256)
    g = [x.to(cuda) for x in (corners, scores, obj)]
    before = nms3d_greedy_cuda.launches, box3d_iou_matrix_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        keep = ops.nms3d(*g, 0.25)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (nms3d_greedy_cuda.launches, box3d_iou_matrix_cuda.launches) == (before[0] + 1, before[1] + 1)
    cpu = ops.nms3d(corners, scores, obj, 0.25)
    assert torch.equal(keep.cpu(), cpu)
    iou_cpu = ops.box3d_iou_matrix(corners, corners).to(cuda)
    assert torch.equal(nms3d_greedy_cuda(iou_cpu, g[1], g[2], 0.25).cpu(), cpu)
    assert 0 < int(keep.sum()) < int((obj[..., 1] > obj[..., 0]).sum())


@pytest.mark.parametrize("config,B,P", [("default", 1, 256), ("default", 8, 256), ("tiny", 2, 16), ("default", 3, 37),
                                        ("default", 1, 1), ("default", 2, 1025), ("default", 2, 1056),
                                        ("default", 2, 2048), ("default", 1, 4096)])
def test_decode_iou_kernel_equals_plain_on_the_card_and_the_cpu(cuda, config, B, P):
    """The head's fused kernel (the decode inside the IoU self-matrix's
    tiles, ``decode_with_iou``): its seven decoded outputs equal, bit for
    bit, ``decode_proposals_plain``'s on the card and on the CPU, and its
    IoU matrix the IoU kernel's on the decode kernel's corners (the two
    launches it replaces) and the plain version's on the card bit for bit,
    and the CPU's float for float (==: the CPU's max keeps a -0 where the
    card's gives +0, as for the IoU kernel since it was written), at B = 1
    and 8, proposal counts off the tile (37, 1025, 1056) and the greedy's
    global-workspace lengths (1025-4096); one launch and no other."""
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.models.decode import class_mean_size, decode_proposals_plain, decode_with_iou
    from votenet_tpu_torch.ops.cuda.decode import decode_iou_cuda, decode_proposals_cuda
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

    cfg = tiny_config() if config == "tiny" else default_config()
    out, xyz = decode_end_points(cfg, B, P, B + P)
    xyz *= float(np.sqrt(max(P, 256) / 256) * 0.6)  # a room grown with P: overlaps at every length
    ep = {"proposals_output": out.to(cuda), "proposals_xyz": xyz.to(cuda)}
    counters = (decode_iou_cuda, decode_proposals_cuda, box3d_iou_matrix_cuda)
    before = [c.launches for c in counters]
    got, iou = decode_with_iou(ep, cfg)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 0]
    bits = lambda t: t.cpu().contiguous().view(torch.int32)  # noqa: E731
    for where, e in (("card", ep), ("cpu", {"proposals_output": out, "proposals_xyz": xyz})):
        want = decode_proposals_plain(e, cfg)
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert torch.equal(bits(got[k]), bits(want[k])), (where, k)
    corners = decode_proposals_cuda(ep["proposals_output"], ep["proposals_xyz"], class_mean_size(cuda),
                                    cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class)["bboxes"]
    assert torch.equal(bits(iou), bits(box3d_iou_matrix_cuda(corners, corners)))
    assert torch.equal(bits(iou), bits(box3d_iou_matrix_plain(got["bboxes"], got["bboxes"])))
    cpu = box3d_iou_matrix_plain(got["bboxes"].cpu(), got["bboxes"].cpu())
    assert torch.equal(iou.cpu(), cpu)
    assert int((iou > 0).sum()) > B * P or P == 1


def test_decode_and_nms_on_the_card_sync_nowhere(cuda):
    """``predict_boxes`` (decode, the IoU, NMS, the detection cap) on a tiny
    VoteNet's end points under the sync debug mode "error": the host never
    waits for the card, so it enqueues them while the forward runs."""
    from votenet_tpu_torch.models import VoteNet, predict_boxes

    cfg = tiny_config()
    model = VoteNet(cfg).to(cuda)
    pts = torch.from_numpy(cloud(1, 2, cfg.point_num, "scene")).to(cuda)
    with torch.inference_mode():
        ep = model(pts)
        predict_boxes(ep, cfg)  # first use: the class mean sizes copied to the card once
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = predict_boxes(ep, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out["keep"].shape == (2, cfg.proposal_num)


def test_nms_kernel_takes_long_rows(cuda):
    """A row past the shared-memory route (``NMS_SMEM_BOXES``) takes the
    workspace route, and on an all-zero IoU every candidate is kept."""
    from votenet_tpu_torch.ops.cuda.nms3d import NMS_SMEM_BOXES, nms3d_greedy_cuda

    n = NMS_SMEM_BOXES + 1
    obj = torch.tensor([0.0, 1.0], device=cuda).expand(1, n, 2)  # every box a candidate; a stride-0 view
    keep = nms3d_greedy_cuda(torch.zeros((1, n, n), device=cuda), torch.zeros((1, n), device=cuda), obj, 0.25)
    assert bool(keep.all())


@pytest.mark.parametrize("B,N,p_cand,levels", [(2, 1025, 0.5, 7), (2, 1056, 0.9, 3), (2, 2048, 0.5, 30),
                                               (2, 4096, 0.3, 100), (1, 1500, 1.0, 1), (3, 1100, 0.0, 2)])
def test_nms_kernel_long_rows_match_both_plain_versions(cuda, B, N, p_cand, levels):
    """Past 1024 boxes a row (33 words a row at 1025-1056, 64 at 2048, 128
    at 4096): the workspace route's keep mask equals the walk's twin and the
    Jacobi loop's, on random relations; no candidate at all keeps none."""
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda, nms3d_greedy_plain
    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

    rng = np.random.RandomState(N + B)
    iou = torch.from_numpy(rng.rand(B, N, N).astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.randint(0, levels, (B, N)).astype(np.float32)).to(cuda)
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    cand_np = rng.rand(B, N) < p_cand
    cand = torch.from_numpy(cand_np).to(cuda)
    thr = 1.0 - 2.0 / N  # a few suppressions a box, long chains
    got = nms3d_greedy_cuda(iou, scores, objectness_for(cand_np, rng).to(cuda), thr)
    torch.cuda.synchronize()
    assert torch.equal(got, nms3d_greedy_plain(iou, order, cand, thr))
    assert torch.equal(got, nms3d_jacobi_plain(iou, order, cand, thr))
    assert int(got.sum()) < int(cand.sum()) or int(cand.sum()) == 0


@pytest.mark.parametrize("B,N,M,kind", [(1, 256, 256, "rotated"), (8, 256, 256, "rotated"), (2, 33, 129, "rotated"),
                                        (3, 1, 1, "rotated"), (2, 40, 40, "identical"), (2, 60, 50, "degenerate"),
                                        (2, 64, 64, "axis"), (1, 1056, 1056, "rotated")])
def test_iou_kernel_equals_plain_on_the_card_and_the_cpu(cuda, B, N, M, kind):
    """The IoU kernel's floats equal its plain version's on the card and on
    the CPU (==, element by element), and the plain version's eager ops on
    the card equal the CPU's: the premise of the device-independent keep
    mask."""
    from tests.test_torch_iou import boxes
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

    rng = np.random.RandomState(B * N + M)
    c1 = torch.from_numpy(np.ascontiguousarray(boxes(kind, rng, (B, N))))
    c2 = torch.from_numpy(np.ascontiguousarray(boxes(kind, rng, (B, M)))) if kind != "identical" else c1.clone()
    got = box3d_iou_matrix_cuda(c1.to(cuda), c2.to(cuda))
    torch.cuda.synchronize()
    cpu = box3d_iou_matrix_plain(c1, c2)
    assert torch.equal(got.cpu(), cpu)
    assert torch.equal(box3d_iou_matrix_plain(c1.to(cuda), c2.to(cuda)).cpu(), cpu)


def test_iou_matrix_routes_to_the_kernel(cuda):
    """``ops.box3d_iou_matrix`` on CUDA tensors launches the kernel once,
    leading dimensions broadcast and flattened as the plain version does."""
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda

    corners = random_box_batch(5, 6, 40)[0].reshape(2, 3, 40, 8, 3)
    before = box3d_iou_matrix_cuda.launches
    got = ops.box3d_iou_matrix(corners.to(cuda), corners[:, :, :17].to(cuda))
    assert box3d_iou_matrix_cuda.launches == before + 1 and got.shape == (2, 3, 40, 17)
    assert torch.equal(got.cpu(), ops.box3d_iou_matrix(corners, corners[:, :, :17]))


@pytest.mark.parametrize("N", [1, 17, 256, 300, 1056])
def test_iou_self_matrix_triangle_equals_the_full_route(cuda, N):
    """The same memory twice takes the self-matrix's triangle (tiles on and
    above the diagonal, each float written to both halves); a copy of it
    takes the full route: the two matrices are equal bit for bit, and equal
    to the plain version on the CPU."""
    from tests.test_torch_iou import boxes
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

    c = torch.from_numpy(np.ascontiguousarray(boxes("rotated", np.random.RandomState(N), (2, N))))
    g = c.to(cuda)
    tri = box3d_iou_matrix_cuda(g, g)
    full = box3d_iou_matrix_cuda(g, g.clone())
    torch.cuda.synchronize()
    assert torch.equal(tri.view(torch.int32), full.view(torch.int32))
    assert torch.equal(tri.cpu(), box3d_iou_matrix_plain(c, c))


@pytest.mark.parametrize("B,N", [(1, 256), (8, 256), (2, 33), (3, 1000), (2, 1025), (1, 2048)])
def test_nms_kernel_order_with_nan_inf_and_signed_zeros(cuda, B, N):
    """The kernel's own order (scores tied, NaN of either sign, +-inf, -0
    and +0) gives the fixpoint's mask over torch.argsort's order on the CPU,
    on both routes; objectness a strided view of a head's output."""
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda
    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

    rng = np.random.RandomState(B + N)
    iou = rng.rand(B, N, N).astype(np.float32)
    s = rng.randint(-2, 3, (B, N)).astype(np.float32)
    s[:, ::7], s[:, 3::11], s[:, 1::13], s[:, 2::5] = np.nan, -np.nan, np.inf, -np.inf
    s[:, 4::6] = -0.0
    head = rng.randn(B, N, 9).astype(np.float32)
    obj = torch.from_numpy(head)[..., 3:5]
    thr = 1.0 - 3.0 / N if N > 8 else 0.5
    order = torch.argsort(torch.from_numpy(s), dim=1, descending=True, stable=True)
    want = nms3d_jacobi_plain(torch.from_numpy(iou), order, obj[..., 1] > obj[..., 0], thr)
    got = nms3d_greedy_cuda(torch.from_numpy(iou).to(cuda), torch.from_numpy(s).to(cuda),
                            torch.from_numpy(head).to(cuda)[..., 3:5], thr)
    assert torch.equal(got.cpu(), want)


def decode_end_points(cfg, B, P, seed):
    from tests.test_torch_decode import end_points, heading_cases

    out, xyz = end_points(cfg, B, P, seed, headings=heading_cases(cfg.num_heading_bin)[:B * P])
    return torch.from_numpy(out), torch.from_numpy(xyz)


@pytest.mark.parametrize("config,B,P", [("tiny", 2, 16), ("default", 1, 256), ("default", 8, 256),
                                        ("default", 3, 200)])
def test_decode_kernel_equals_plain_on_the_card_and_the_cpu(cuda, config, B, P):
    """The decode kernel's every output equals the plain version's on the
    card and on the CPU, bit for bit (int32 views of the floats): the stated
    sin and cos, the heading's fmod, the corners' order; a proposal count
    off the block size; the heading cases of tests/test_torch_decode.py."""
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.models.decode import decode_proposals, decode_proposals_plain
    from votenet_tpu_torch.ops.cuda.decode import decode_proposals_cuda

    cfg = tiny_config() if config == "tiny" else default_config()
    out, xyz = decode_end_points(cfg, B, P, B * P)
    out[0, -1, -cfg.num_class:] = float("nan")  # a NaN logit: the maximum, its bits as they came
    ep = {"proposals_output": out.to(cuda), "proposals_xyz": xyz.to(cuda)}
    before = decode_proposals_cuda.launches
    got = decode_proposals(ep, cfg)
    torch.cuda.synchronize()
    assert decode_proposals_cuda.launches == before + 1
    card = decode_proposals_plain(ep, cfg)
    cpu = decode_proposals_plain({"proposals_output": out, "proposals_xyz": xyz}, cfg)
    assert sorted(got) == sorted(cpu)
    for k in got:
        g, c = got[k].cpu(), cpu[k]
        assert g.dtype == c.dtype and g.shape == c.shape, k
        view = (lambda x: x.view(torch.int32)) if g.dtype == torch.float32 else (lambda x: x)
        assert torch.equal(view(g.contiguous()), view(c.contiguous())), k
        assert torch.equal(view(g.contiguous()), view(card[k].cpu().contiguous())), k


def test_predict_boxes_is_three_launches_with_no_sort_and_no_sync(cuda, monkeypatch):
    """``predict_boxes`` at the default ``max_detections`` (the proposal
    count) on CUDA end points: one launch each of the fused decode + IoU
    kernel and the greedy (the decode and IoU kernels alone, which it
    replaces, none), no ``torch.argsort`` call, no host sync; its outputs
    equal the CPU's from the same end points (floats and keep mask)."""
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.models.decode import predict_boxes
    from votenet_tpu_torch.ops.cuda.decode import decode_iou_cuda, decode_proposals_cuda
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda

    cfg = default_config()
    out, xyz = decode_end_points(cfg, 8, 256, 5)
    out[..., 1] += 0.3
    xyz *= 0.6
    ep = {"proposals_output": out.to(cuda), "proposals_xyz": xyz.to(cuda)}
    predict_boxes(ep, cfg)  # first use: the class mean sizes copied to the card once
    sorts = []
    argsort = torch.argsort
    monkeypatch.setattr(torch, "argsort", lambda *a, **k: sorts.append(1) or argsort(*a, **k))
    counters = (decode_iou_cuda, nms3d_greedy_cuda, decode_proposals_cuda, box3d_iou_matrix_cuda)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = predict_boxes(ep, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0, 0] and not sorts
    monkeypatch.undo()
    cpu = predict_boxes({"proposals_output": out, "proposals_xyz": xyz}, cfg)
    for k in ("bboxes", "nms_scores", "heading_pred", "size_pred", "center_pred", "size_cls", "heading_cls", "keep"):
        assert torch.equal(got[k].cpu(), cpu[k]), k
    assert 0 < int(cpu["keep"].sum()) < int((out[..., 1] > out[..., 0]).sum())


def test_streaming_forms_on_the_card(cuda):
    """three_nn_streaming and query_ball_point_streaming on CUDA tensors
    equal the dense forms and the ball-query kernel, blocks not dividing N."""
    from votenet_tpu_torch import ops

    xyz = torch.from_numpy(cloud(3, 2, 5000, "scene")).to(cuda)
    q = xyz[:, :700].contiguous()
    dense = ops.three_nn_dense(q, xyz[:, ::7].contiguous())
    stream = ops.three_nn_streaming(q, xyz[:, ::7].contiguous(), block=300)
    assert all(torch.equal(a, b) for a, b in zip(dense, stream))
    kernel = ops.query_ball_point(0.3, 32, xyz, q)
    for got in (ops.query_ball_point_dense(0.3, 32, xyz, q), ops.query_ball_point_streaming(0.3, 32, xyz, q, 1234)):
        assert all(torch.equal(a, b) for a, b in zip(got, kernel))


def test_gather_packing_step_on_the_card_matches_cpu(cuda):
    """A tiny bf16_hilo training forward and backward on the card against
    the CPU from the same weights: losses within 1e-4 of scale, gradients
    finite (the packed scatter's bf16 cotangent through the scatter kernel)."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda
    from votenet_tpu_torch.train import create_train_state, forward_backward

    cfg = tiny_config(gather_packing="bf16_hilo")
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    states = [create_train_state(cfg, 10, device=d) for d in ("cpu", cuda)]
    before = scatter_add_cuda.launches
    losses = [forward_backward(s.model, batch, cfg) for s in states]
    assert scatter_add_cuda.launches == before + 4
    a, b = float(losses[0].total), float(losses[1].total)
    assert abs(a - b) <= 1e-4 * max(1.0, abs(a))
    assert all(torch.isfinite(p.grad).all() for p in states[1].model.parameters())


def test_steps_per_dispatch_on_the_card_is_bit_equal(cuda):
    """Two tiny epochs at K = 3 (8 steps: two chunks and a tail) against K =
    1 on the card, deterministic algorithms on: the same state."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import Trainer, create_train_state

    cfg = tiny_config(batch_size=2)
    batches = list(batch_scenes(iter(synthetic_scenes(0, cfg, 16)), 2, cfg.max_gt_boxes))
    out = []
    torch.use_deterministic_algorithms(True, warn_only=True)  # cuBLAS warns; its f32 GEMMs repeat on one card
    try:
        for k in (1, 3):
            trainer = Trainer(cfg, create_train_state(cfg, 8, device=cuda), steps_per_dispatch=k)
            for _ in range(2):
                trainer.train_epoch(batches)
            out.append(trainer.state.model.state_dict())
    finally:
        torch.use_deterministic_algorithms(False)
    assert all(torch.equal(out[0][k], out[1][k]) for k in out[0])


@pytest.mark.parametrize("segments", [None, 1, 3])
@pytest.mark.parametrize(
    "B,N,M,radius,S,kind",
    [(1, 20480, 2048, 0.2, 64, "scene"), (8, 2048, 1024, 0.4, 64, "scene"), (2, 1024, 256, 0.3, 64, "normal"),
     (2, 300, 50, 1.5, 16, "grid"), (1, 100, 7, 0.01, 8, "normal")],
)
def test_ball_query_fast_bf16_kernel_matches_plain(cuda, B, N, M, radius, S, kind, segments):
    """The fast_bf16 variant bit-equal to its plain version on the card and
    on the CPU, through both routes; its own counter counts it."""
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    xyz = torch.from_numpy(cloud(B * N + 1, B, N, kind)).to(cuda)
    q = xyz[:, :M].clone()
    q[0, -1] = 1000.0  # empty ball
    before = (query_ball_point_cuda.launches, query_ball_point_cuda.fast_bf16.launches)
    got = query_ball_point_cuda(radius, S, xyz, q, segments=segments, mode="fast_bf16")
    torch.cuda.synchronize()
    assert (query_ball_point_cuda.launches, query_ball_point_cuda.fast_bf16.launches) == (before[0], before[1] + 1)
    want = query_ball_point_plain(radius, S, xyz, q, "fast_bf16")
    cpu = query_ball_point_plain(radius, S, xyz.cpu(), q.cpu(), "fast_bf16")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(), cpu[1])
    assert int(got[1][0, -1]) == 0


@pytest.mark.parametrize("case", list(BALL_EDGES))
def test_ball_query_fast_bf16_kernel_edges(cuda, case):
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    N, hits, S, segments = BALL_EDGES[case]
    xyz = torch.from_numpy(crafted_balls(N, hits)).to(cuda)
    q = torch.zeros((1, 3, 3), device=cuda)
    q[0, 1] = 2.5
    q[0, 2] = 100.0
    want = query_ball_point_plain(0.5, S, xyz, q, "fast_bf16")
    for seg in {segments, 1, 3}:
        got = query_ball_point_cuda(0.5, S, xyz, q, segments=seg, mode="fast_bf16")
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), seg


def test_remat_step_on_the_card_is_the_plain_step(cuda):
    """The tiny VoteNet's step with and without remat under deterministic
    algorithms: losses, gradients and running statistics bit-equal; the
    remat step runs FPS and the ball query 9 times (sa1-sa4 again)."""
    import chip_smoke
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import create_train_state, forward_backward

    cfg = tiny_config()
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 4)), 4, cfg.max_gt_boxes))
    out = {}
    counters = chip_smoke.train_counters()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            c = cfg.replace(remat=remat)
            state = create_train_state(c, 8, torch.Generator().manual_seed(0), device="cuda")
            for k in counters.values():
                k.launches = 0
            losses = forward_backward(state.model, batch, c)
            out[remat] = (losses, {n: p.grad for n, p in state.model.named_parameters()},
                          dict(state.model.named_buffers()), {n: k.launches for n, k in counters.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    (lp, gp, sp, _), (lr, gr, sr, launches) = out[False], out[True]
    assert all(torch.equal(a, b) for a, b in zip(lp, lr))
    assert all(torch.equal(gp[n], gr[n]) for n in gp) and all(torch.equal(sp[n], sr[n]) for n in sp)
    assert launches == chip_smoke.step_launches(cfg.replace(remat=True))


def test_dead_paths_on_the_card_match_cpu(cuda):
    """chip_smoke.py's phase 25: every SA option and the MSG module in eval
    and train mode, and the reference's other ops, the card against the
    CPU."""
    import chip_smoke
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.synthetic import synthetic_scenes

    chip_smoke.phase_dead_paths(synthetic_scenes(0, default_config(), 2))


# ------------------------------------------------------ batch norm + ReLU

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C", [(1, 16), (7, 13), (2048, 128), (4096, 259), (131072, 64), (262144, 256),
                                 (100003, 36), (33, 1024)])
def test_bn_kernels_match_plain(cuda, dtype, R, C):
    """chip_smoke.py's phase-32 gates at other shapes: K2 bit-equal to its
    plain version on the card, K1 and K3 within BN_SUM_TOL of each
    channel's sum of |terms|, K4 bit-equal to its plain version, each kernel's
    two runs bit-identical; odd C takes the scalar lanes, C = 1024 four
    channel tiles."""
    import chip_smoke

    _, bad, _ = chip_smoke.bn_check(R, C, dtype, seed=R + C, times=False)
    assert bad == []


def test_bn_kernels_unaligned_rows_take_the_scalar_lanes(cuda):
    """A contiguous view that starts one element into its storage: the
    wrappers give the kernels V = 1 and the results are the plain stages'."""
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    g = torch.Generator(device="cuda").manual_seed(3)
    x = (torch.randn(64 * 32 + 1, generator=g, device="cuda") * 2 + 1)[1:].view(64, 32)
    dy = torch.randn(64 * 32 + 1, generator=g, device="cuda")[1:].view(64, 32)
    assert x.is_contiguous() and not bnc._vec(32, x)
    mean, mul, bias = x.mean(0), torch.rand(32, device="cuda") + 0.5, torch.randn(32, device="cuda")
    assert torch.equal(bnc.bn_apply_cuda(x, mean, mul, bias, torch.float32, True),
                       bn.bn_apply_plain(x, mean, mul, bias, torch.float32, True))
    a, b = torch.randn(32, device="cuda"), torch.randn(32, device="cuda")
    got = bnc.bn_bwd_apply_cuda(x, dy, mean, mul, bias, a, b, True)
    want = bn.bn_bwd_apply_plain(x, dy, mean, mul, bias, a, b, True)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    s, sq = bnc.bn_stats_cuda(x)  # f64 sums, which the op rounds to f32
    ps, psq = bn.bn_stats_plain(x)
    assert s.dtype == torch.float64
    assert torch.allclose(s.float(), ps, rtol=0, atol=1e-5 * float(x.abs().sum(0).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_edge_cases_match_plain_on_the_card(cuda, dtype):
    """NaN inputs and outputs of exactly +0 and -0 (x at the mean, a
    negative scale, a -0 bias): K2 equal to the plain stage on the card bit
    for bit (NaNs where it has them, zeros with torch.relu's signs on the
    card), K3's sums and K4's cotangent with the same NaNs, equal
    elsewhere (K4) or within BN_SUM_TOL (K3)."""
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    R, C = 256, 8
    rng = np.random.RandomState(9)
    mean = torch.from_numpy(rng.randn(C).astype(np.float32)).to(dtype).float().cuda()
    x = torch.from_numpy((rng.randn(R, C) * 3).astype(np.float32)).cuda()
    x[:40, 2], x[:40, 3] = mean[2], mean[3]
    x[17, 5] = float("nan")
    x = x.to(dtype)
    dy = torch.from_numpy(rng.randn(R, C).astype(np.float32)).to(dtype).cuda()
    mul = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda()
    mul[2], bias[2], bias[3] = -1.0, -0.0, 0.0
    y = bnc.bn_apply_cuda(x, mean, mul, bias, dtype, True)
    py = bn.bn_apply_plain(x, mean, mul, bias, dtype, True)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(py)
    assert torch.equal(torch.isnan(y), nan) and int(nan.sum()) == 1
    assert torch.equal(y[~nan].view(bits), py[~nan].view(bits))
    sg, sgx = bnc.bn_bwd_reduce_cuda(x, dy, mean, mul, bias, True)
    psg, psgx = bn.bn_bwd_reduce_plain(x, dy, mean, mul, bias, True)
    # each channel's sum of |terms| is at most R * max|dy| * (1 + max|x - mean|)
    bound = R * float(dy.float().abs().max()) * (1 + float((x.float() - mean).abs().nan_to_num().max()))
    for got, want in ((sg, psg), (sgx, psgx)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert float((got[ok] - want[ok]).abs().max()) <= chip_smoke.BN_SUM_TOL * bound
    a, b = torch.randn(C, device="cuda"), torch.randn(C, device="cuda")
    dx = bnc.bn_bwd_apply_cuda(x, dy, mean, mul, bias, a, b, True)
    pdx = bn.bn_bwd_apply_plain(x, dy, mean, mul, bias, a, b, True)
    nan = torch.isnan(pdx)
    assert torch.equal(torch.isnan(dx), nan) and torch.equal(dx[~nan], pdx[~nan])


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 64, 16, 24), (8, 1024, 64, 64), (2, 333, 7)], ids=["sa-like", "sa2-B8", "odd"])
def test_bn_op_on_the_card_against_f64(cuda, training, shape):
    """``ops.batch_norm_relu`` on the card (K1-K4) against the same formula
    in f64 on the CPU: tests/test_torch_batchnorm.py's F64_TOL (forward and
    running statistics 1e-6 of scale, gradients 1e-5 norm-wise); each stage
    launched once."""
    from tests.test_torch_batchnorm import F64_TOL, case, close, f64_reference, norm_gap
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    x, w, params, stats = case(sum(shape), shape)
    weight = torch.from_numpy(params["scale"]).cuda().requires_grad_(True)
    bias = torch.from_numpy(params["bias"]).cuda().requires_grad_(True)
    rm, rv = torch.from_numpy(stats["mean"]).cuda(), torch.from_numpy(stats["var"]).cuda()
    xt = torch.from_numpy(x).cuda().requires_grad_(True)
    counters = (bnc.bn_stats_cuda, bnc.bn_apply_cuda, bnc.bn_bwd_reduce_cuda, bnc.bn_bwd_apply_cuda)
    before = [c.launches for c in counters]
    y = ops.batch_norm_relu(xt, weight, bias, rm, rv, training=training)
    (y * torch.from_numpy(w).cuda()).sum().backward()
    assert [c.launches - n for c, n in zip(counters, before)] == [int(training), 1, 1, 1]
    ry, rgx, rgs, rgb, rrm, rrv = f64_reference(x, w, params, stats, training)
    close(y.cpu(), ry.detach().numpy(), F64_TOL["forward"])
    close(rm.cpu(), rrm.numpy(), F64_TOL["forward"])
    close(rv.cpu(), rrv.numpy(), F64_TOL["forward"])
    for got, want in ((xt.grad, rgx), (weight.grad, rgs), (bias.grad, rgb)):
        assert norm_gap(got.cpu(), want) <= F64_TOL["grad"]


@pytest.mark.parametrize("C", [301, 1028], ids=["scalar-2-tiles", "vec-2-tiles"])
def test_bn_reductions_reuse_their_tickets(cuda, C):
    """K1 and K3 over two channel tiles, three times in the current stream
    and once in a side stream: the kernels set the cached tickets back to 0,
    so every run gives the same bits (within BN_SUM_TOL of the plain
    stages) and every ticket reads 0 afterwards."""
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    R = 4096
    g = torch.Generator(device="cuda").manual_seed(C)
    x = torch.randn((R, C), generator=g, device="cuda") * 2 + 1
    dy = torch.randn((R, C), generator=g, device="cuda")
    mean, mul, bias = x.mean(0), torch.rand(C, device="cuda") + 0.5, torch.randn(C, device="cuda")
    assert bnc.bn_plan(R, C, bnc._vec(C, x), bnc.sm_count(0), "reduce")[2] == 2

    def both():
        return (*bnc.bn_stats_cuda(x), *bnc.bn_bwd_reduce_cuda(x, dy, mean, mul, bias, True))

    first = both()
    for got in (both(), both()):
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = both()
    torch.cuda.current_stream().wait_stream(side)
    assert all(torch.equal(a, b) for a, b in zip(got, first))
    plain = (*bn.bn_stats_plain(x), *bn.bn_bwd_reduce_plain(x, dy, mean, mul, bias, True))
    gm = torch.where(bn.bn_apply_plain(x, mean, mul, bias, torch.float32, False) <= 0, 0, dy)
    terms = (x.abs().sum(0), (x * x).sum(0), gm.abs().sum(0), (gm * (x - mean)).abs().sum(0))
    for a, b, t in zip(first, plain, terms):
        assert bool(((a - b).abs() <= chip_smoke.BN_SUM_TOL * t).all())
    torch.cuda.synchronize()
    assert all(int(t.abs().sum()) == 0 for t in bnc._tickets.values())


def test_bn_op_refuses_a_strided_card_tensor(cuda):
    """A non-contiguous CUDA input raises; it is not copied."""
    from votenet_tpu_torch import ops

    x = torch.randn(16, 8, 12, device="cuda").transpose(0, 1)
    v = torch.ones(12, device="cuda")
    with pytest.raises((RuntimeError, ValueError)):
        ops.batch_norm_relu(x, v, v, v.clone(), v.clone(), training=True)


def test_bn_kernels_without_rows_count_nothing(cuda):
    """No rows: K1 and K3 return zero sums, K2 and K4 empty tensors, and no
    stage adds to its count or to the prologue's: nothing was launched."""
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    C = 64
    x, dy = torch.empty((0, C), device="cuda"), torch.empty((0, C), device="cuda")
    v, db = torch.ones(C, device="cuda"), torch.zeros(C, device="cuda")
    counters = (bnc.bn_stats_cuda, bnc.bn_apply_cuda, bnc.bn_bwd_reduce_cuda, bnc.bn_bwd_apply_cuda,
                *bnc.PROLOGUE_LAUNCHES.values())
    before = [c.launches for c in counters]
    s, sq = bnc.bn_stats_cuda(x, dense_bias=db)
    sg, sgx = bnc.bn_bwd_reduce_cuda(x, dy, v, v, v, True, dense_bias=db)
    y = bnc.bn_apply_cuda(x, v, v, v, torch.float32, True, dense_bias=db)
    dx = bnc.bn_bwd_apply_cuda(x, dy, v, v, v, v, v, True, dense_bias=db)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    assert all(int(t.count_nonzero()) == 0 and t.shape == (C,) for t in (s, sq, sg, sgx))
    assert y.shape == dx.shape == (0, C)


# ------------------------------------- batch norm with the layer around it

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,S,prologue,pooled", [
    (8 * 2048 * 64, 64, 64, "centre", False), (8 * 2048 * 64, 128, 64, "bias", True),
    (8 * 256 * 64, 128, 64, "centre", True), (2048, 128, 1, "bias", False), (37 * 16, 13, 16, "centre", True),
    (5 * 3, 36, 3, "bias", True), (4096, 259, 1, "bias", False), (64 * 7, 1024, 7, "centre", False)])
def test_bn_layer_variants_match_plain(cuda, dtype, R, C, S, prologue, pooled):
    """chip_smoke.py's phase-32 gates for the prologue and the pool: K2
    (the pool's maxima and counts too) and K4 bit-equal to their plain
    versions on the card, K1 and K3 within BN_SUM_TOL, every rerun
    bit-identical; odd C the scalar lanes, C = 1024 four channel tiles."""
    import chip_smoke

    _, bad, _ = chip_smoke.bn_check(R, C, dtype, seed=R + C, times=False, prologue=prologue, S=S, pooled=pooled)
    assert bad == []


@pytest.mark.parametrize("R,C,S,prologue", [(7, 13, 1, None), (2048, 128, 1, "bias"), (8192, 256, 1, "bias"),
                                            (32768, 64, 64, "centre"), (16384, 128, 64, "centre"),
                                            (100003, 36, 1, None), (4096, 259, 1, "bias"),
                                            (65536, 32, 16, "centre")])
def test_bn_sums_follow_the_stated_order(cuda, R, C, S, prologue):
    """K1's and K3's sums equal, bit for bit, the numpy transcription of
    their order from the launch plan (tests/test_torch_bn_layer.py
    ``kernel_sums``: f64, rounded once to f32) on this card's SM count, over
    the terms as the kernels form them (x through the prologue and x * x;
    the masked cotangent and its product with f32(x - mean)), at one CTA,
    one block and two levels."""
    from tests.test_torch_bn_layer import k1_terms, k3_terms, kernel_sums
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, corr, db, weight, bias, dy = chip_smoke.bn_site_inputs(R, C, torch.float32, R + C, prologue, S)
    pro = dict(corr=corr, dense_bias=db)
    x = bn.layer_rows_plain(h, corr, db)
    vec = bnc._vec(C, h, corr, db, dy)
    plan = bnc.bn_plan(R, C, vec, bnc.sm_count(0), "reduce", S)
    plan_dy = bnc.bn_plan(R, C, vec, bnc.sm_count(0), "reduce_dy", S)  # K3's, over a full dy
    s, sq = (v.float() for v in bnc.bn_stats_cuda(h, **pro))  # K1's f64 sums, rounded as the op rounds them
    for got, terms in zip((s, sq), k1_terms(x.cpu().numpy())):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), kernel_sums(terms, plan, S).view(np.uint32))
    mean, mul = s / R, torch.rand(C, device="cuda") + 0.5
    sg, sgx = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **pro)
    g = bn._masked(x, dy, mean, mul, bias, True)
    for got, terms in zip((sg, sgx), k3_terms(g.cpu().numpy(), x.cpu().numpy(), mean.cpu().numpy())):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), kernel_sums(terms, plan_dy, S).view(np.uint32))
    assert R < 50000 or bnc.bn_reduce_levels(plan[1], plan[4]) > 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bn_layer_op_on_the_card_matches_the_cpu(cuda, dtype, training):
    """The fused site (centred prologue, BN, ReLU, max over 16 padded slots)
    on the card against the same op on the CPU: the pooled output and the
    cotangents of h, corr, the dense bias, the scale and the BN bias within
    tests/test_torch_bn_layer.py's tolerances against flax (f32 2e-6 of
    scale; bf16 2^-8 of scale, 2^-6 of each cotangent's norm; the dense
    bias's in training, whose terms cancel, within 2e-6 (f32) or 2^-6
    (bf16) of its terms' sum of |dh|, channel by channel); K1 (in
    training), K2's pool variant and the pooled K3 and K4 each launched
    once, every launch with the centred prologue."""
    from tests.test_torch_bn_layer import close, norm_close, site
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, corr, db, gp, params, stats = site(3, shape=(4, 64, 16, 36))
    outs = []
    counters = (bnc.bn_stats_cuda, bnc.bn_apply_cuda.pool, bnc.bn_bwd_reduce_cuda.pooled,
                bnc.bn_bwd_apply_cuda.pooled, bnc.PROLOGUE_LAUNCHES["centre"])
    for dev in ("cuda", "cpu"):
        before = [c.launches for c in counters]
        ts = [torch.from_numpy(a).to(dev) for a in (h, corr, db)]
        hh, cc, dd = (a.to(dtype).requires_grad_(True) for a in ts)
        w = torch.from_numpy(params["scale"]).to(dev).requires_grad_(True)
        b = torch.from_numpy(params["bias"]).to(dev).requires_grad_(True)
        rm, rv = torch.from_numpy(stats["mean"]).to(dev), torch.from_numpy(stats["var"]).to(dev)
        y = ops.batch_norm_relu(hh, w, b, rm, rv, training=training, dense_bias=dd, corr=cc, pool="max")
        y.backward(torch.from_numpy(gp).to(dev).to(dtype))
        outs.append([a.detach().cpu() for a in (y, hh.grad, cc.grad, dd.grad, w.grad, b.grad)])
        if dev == "cuda":
            assert [c.launches - n for c, n in zip(counters, before)] == [int(training), 1, 1, 1, 3 + training]
    f32 = dtype == torch.float32
    for i, (got, want) in enumerate(zip(*outs)):
        if training and i == 3:  # the dense bias's cotangent: a sum whose terms (dh) cancel in training
            terms = outs[1][1].float().abs().reshape(-1, want.shape[-1]).sum(0)
            assert bool(((got.float() - want.float()).abs() <= (2e-6 if f32 else 2 ** -6) * terms).all())
        elif f32:
            close(got, want.numpy(), 2e-6)
        elif i == 0:
            close(got, want.float().numpy(), 2 ** -8)
        else:
            norm_close(got, want.float().numpy(), 2 ** -6)


# ------------------------------- batch norm's per-channel end and epilogue

def random_channel_sums(C, R, seed, device="cuda"):
    """f64 sums (s, sq) of R rows at C channels: ordinary ones, ones whose
    E[x^2] - E[x]^2 rounds below 0 (a constant channel), one NaN, one 0."""
    rng = np.random.RandomState(seed)
    mean = rng.randn(C) * 3
    var = rng.uniform(0.1, 4, C)
    s = mean * R
    sq = (var + mean * mean) * R
    const = rng.rand(C) < 0.25
    sq = np.where(const, (s / R) ** 2 * R * (1 - 1e-9 * rng.rand(C)), sq)
    s[1], sq[2] = np.nan, 0.0
    return torch.tensor(s, device=device), torch.tensor(sq, device=device)


@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("R", [8192, 786432, 8 * 2048 * 64 * 3 + 7])
def test_bn_statistics_end_is_the_torch_ops_on_the_card(cuda, update, R):
    """The statistics' end on the card (K2's, from a data-parallel group's
    f64 sums, in its plain and pool variants, f32 and bf16; and K1's last
    CTA through the op's call) equals, bit for bit, the torch ops it
    replaces run on the card (ops.batchnorm.bn_channel_stats_plain: the
    division by the count, the fast variance and its clamp, rsqrt, the
    running statistics' update): mean, mul, inv, var_raw and the running
    statistics, over sums with var_raw < 0, a NaN and a zero, with and
    without the update; K2's output equal to K2 on the end's mean and
    mul."""
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    C, rows, S = 136, 64 * 16, 16
    sums = torch.stack(random_channel_sums(C, R, R))
    rng = np.random.RandomState(1)
    w = torch.tensor(rng.uniform(0.5, 1.5, C).astype(np.float32), device="cuda")
    b = torch.tensor(rng.randn(C).astype(np.float32), device="cuda")
    rm0 = torch.tensor(rng.randn(C).astype(np.float32), device="cuda")
    rv0 = torch.tensor(rng.uniform(0.5, 2, C).astype(np.float32), device="cuda")

    def same(a, b):
        nan = a.isnan() if a.is_floating_point() else torch.zeros_like(a, dtype=torch.bool)
        ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return torch.equal(nan, b.isnan() if b.is_floating_point() else nan) and torch.equal(
            a[~nan].view(ints), b[~nan].view(ints))

    for dtype in (torch.float32, torch.bfloat16):
        h = (torch.randn((rows, C), device="cuda") * 2 + 1).to(dtype)
        for pool in (0, S):
            chs = [bnc.BnChannels(R, w, 1e-5, 0.9, rm0.clone(), rv0.clone(), update) for _ in range(2)]
            y, st = bnc.bn_apply_cuda(h, None, None, b, dtype, True, pool=pool, group_sums=sums, channels=chs[0])
            pst = bn.bn_channel_stats_plain(sums, chs[1])
            py = bnc.bn_apply_cuda(h, pst[0], pst[1], b, dtype, True, pool=pool)
            assert bool((st[3] < 0).any()) and bool(torch.isnan(st[0]).any())
            pairs = [(st, pst), (chs[0].running_mean, chs[1].running_mean), (chs[0].running_var, chs[1].running_var)]
            pairs += list(zip(y, py)) if pool else [(y, py)]
            assert all(same(u, v) for u, v in pairs), (dtype, pool)
            assert torch.equal(chs[0].running_mean, rm0) != update
    # K1's last CTA runs the same end on its own sums
    x = torch.randn((4096, C), device="cuda") * 2 + 1
    rm, rv, prm, prv = rm0.clone(), rv0.clone(), rm0.clone(), rv0.clone()
    got = bnc.bn_stats_cuda(x, channels=bnc.BnChannels(4096, w, 1e-5, 0.9, rm, rv, update))
    want = bn.bn_channel_stats_plain(bnc.bn_stats_cuda(x), bnc.BnChannels(4096, w, 1e-5, 0.9, prm, prv, update))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(rm.view(torch.int32), prm.view(torch.int32))
    assert torch.equal(rv.view(torch.int32), prv.view(torch.int32))


def test_bn_statistics_end_without_rows_runs_on_an_empty_plan(cuda):
    """K1 and K2 given no rows but the statistics' end (a rank with no rows):
    one launch each on an empty plan (one CTA a channel tile, no rows),
    whose end equals the torch ops on zero sums bit for bit (NaN: 0 * inf)
    and moves the running statistics alike."""
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    C = 300
    w, b = torch.rand(C, device="cuda") + 0.5, torch.randn(C, device="cuda")
    rm0, rv0 = torch.randn(C, device="cuda"), torch.rand(C, device="cuda") + 0.5
    x = torch.empty((0, C), device="cuda")
    chs = [bnc.BnChannels(0, w, 1e-5, 0.9, rm0.clone(), rv0.clone(), True) for _ in range(3)]
    before = (bnc.bn_stats_cuda.launches, bnc.bn_apply_cuda.launches, bnc.bn_apply_cuda.group.launches)
    st1 = bnc.bn_stats_cuda(x, channels=chs[0])
    y, st2 = bnc.bn_apply_cuda(x, None, None, b, torch.float32, True, group_sums=torch.zeros((2, C), dtype=torch.float64,
                               device="cuda"), channels=chs[1])
    want = bn.bn_channel_stats_plain(torch.zeros((2, C), dtype=torch.float64, device="cuda"), chs[2])
    torch.cuda.synchronize()
    assert (bnc.bn_stats_cuda.launches, bnc.bn_apply_cuda.launches, bnc.bn_apply_cuda.group.launches) == tuple(
        n + 1 for n in before)
    assert y.shape == (0, C)
    for st, ch in ((st1, chs[0]), (st2, chs[1])):
        for a, b_ in ((st, want), (ch.running_mean, chs[2].running_mean), (ch.running_var, chs[2].running_var)):
            assert torch.equal(a.isnan(), b_.isnan()) and torch.equal(a[~a.isnan()], b_[~b_.isnan()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pooled", [False, True])
def test_bn_eval_backward_forms_mul_from_the_running_statistics(cuda, dtype, pooled):
    """An eval backward's K3 and K4 given the running statistics
    (``eval_var``, K3's coefficients without st) equal, bit for bit, the
    composition they replace on the card: the statistics' end from the
    running statistics (its torch ops), then K3 and K4 on its mean and mul:
    the BN weight's and bias's cotangents, dx and the prologue's
    cotangents."""
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    R, C, S = 64 * 32, 136, 32
    h, corr, db, weight, bias, dy = chip_smoke.bn_site_inputs(R, C, dtype, 9, "centre", S, pooled)
    rm, rv = torch.randn(C, device="cuda"), torch.rand(C, device="cuda") + 0.5
    pro = dict(corr=corr, dense_bias=db)
    if pooled:
        pro["pooled"] = bnc.bn_apply_cuda(h, rm, weight, bias, dtype, True, corr=corr, dense_bias=db, pool=S,
                                          eval_var=rv)
    st = bn.bn_channel_stats_plain(None, bnc.BnChannels(R, weight, 1e-5, 0.9, rm, rv, False))
    want_co = bnc.bn_bwd_reduce_cuda(h, dy, st[0], st[1], bias, True, **pro,
                                     coefficients=bnc.BnCoefficients(st, weight, R, False))
    want_dx = bnc.bn_bwd_apply_cuda(h, dy, st[0], st[1], bias, None, None, True, **pro, sums=True)
    got_co = bnc.bn_bwd_reduce_cuda(h, dy, rm, weight, bias, True, **pro, eval_var=rv,
                                    coefficients=bnc.BnCoefficients(None, weight, R, False))
    got_dx = bnc.bn_bwd_apply_cuda(h, dy, rm, weight, bias, None, None, True, **pro, sums=True, eval_var=rv)
    assert torch.equal(got_co[2:].view(torch.int32), want_co[2:].view(torch.int32))
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for g, w in zip(got_dx, want_dx):
        assert torch.equal(g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32),
                           w.view(torch.int16 if w.dtype == torch.bfloat16 else torch.int32))
    assert got_dx[0].dtype == dtype and bool((got_dx[0].view(ints) != 0).any())


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pooled", [False, True])
def test_bn_coefficients_end_is_the_torch_ops_on_the_card(cuda, training, dtype, pooled):
    """K3's last CTA's coefficients (a, b, the weight's and the bias's
    cotangents) equal, bit for bit, the torch ops they replace
    (ops.batchnorm.bn_channel_coefficients_plain) run on the card on K3's
    own sums (a second launch without the end: the same order, the same
    bits), with statistics whose var_raw is below 0 in some channels (no
    gradient through the clamp) and NaN in one."""
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    R, C, S = 64 * 32, 136, 32
    h, _, db, weight, bias, dy = chip_smoke.bn_site_inputs(R, C, dtype, 5, "bias", S, pooled)
    s, sq = bnc.bn_stats_cuda(h, dense_bias=db)
    st = bn.bn_channel_stats_plain((s, sq), bnc.BnChannels(R, weight, 1e-5, 0.9, None, None, False))
    st[3, :C // 4] = -st[3, :C // 4].abs() - 1e-7  # var_raw < 0: no gradient through the clamp
    st[3, 5] = float("nan")
    mean, mul = st[0], st[1]
    pro = dict(dense_bias=db)
    if pooled:
        pro["pooled"] = bnc.bn_apply_cuda(h, mean, mul, bias, dtype, True, dense_bias=db, pool=S)
    co = bnc.BnCoefficients(st, weight, R * 3, training)
    got = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **pro, coefficients=co)
    sums = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **pro)
    want = bn.bn_channel_coefficients_plain(sums, co)
    rows = slice(0, 4) if training else slice(2, 4)
    assert torch.equal(got[rows].view(torch.int32), want[rows].view(torch.int32))


def epilogue_reference(dx, S, centre):
    """The f64 sums the epilogue rounds: corr's -sum(dx) a unit, the dense
    bias's sum(dx), and each one's sum of |terms|."""
    d = dx.double()
    unit = (-d).view(-1, S, d.shape[-1])
    return (unit.sum(1) if centre else None, unit.abs().sum(1) if centre else None, d.sum(0), d.abs().sum(0))


def within_f64_gate(got, want, terms, dtype):
    """|got - f64 sum| within one ulp of the dtype of |sum| plus 2^-40 of the
    sum of |terms| (chip_smoke.py's BN_F64_ULPS / BN_F64_FLOOR form)."""
    import chip_smoke

    ulps = chip_smoke.BN_F64_ULPS if dtype == torch.float32 else chip_smoke.BN_F64_ULPS_BF16
    allow = ulps * want.abs() + chip_smoke.BN_F64_FLOOR * terms
    return bool(((got.double() - want).abs() <= allow).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,C,S,prologue,pooled,training", [
    (8 * 2048 * 64, 64, 64, "centre", False, True), (8 * 2048 * 64, 128, 64, "bias", True, True),
    (8 * 1024, 256, 1, "bias", False, True), (37 * 16, 13, 16, "centre", True, False),
    (4096, 259, 1, "bias", False, False), (64 * 7, 1024, 7, "centre", False, True)])
def test_bn_epilogue_within_the_f64_gate(cuda, dtype, R, C, S, prologue, pooled, training):
    """K4's epilogue: dx bit-equal to K4 without it, corr's cotangent (each
    unit's -sum(dx)) and the dense bias's (sum(dx), in training a sum of
    terms that cancel) within the f64 gate of torch's f64 sums of the same
    rounded dx, every rerun bit-identical; in f32 both equal the numpy
    transcription of the kernel's order (tests/test_torch_bn_layer.py
    ``epilogue_sums``) bit for bit."""
    import chip_smoke
    from tests.test_torch_bn_layer import epilogue_sums
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, corr, db, weight, bias, dy = chip_smoke.bn_site_inputs(R, C, dtype, R + C, prologue, S, pooled)
    pro = dict(corr=corr, dense_bias=db)
    x = bn.layer_rows_plain(h, corr, db)
    mean, mul = x.float().mean(0), torch.rand(C, device="cuda") + 0.5
    a = b = None
    if training:
        a, b = torch.randn(C, device="cuda") * 1e-3, torch.randn(C, device="cuda") * 1e-3
    if pooled:
        pro["pooled"] = bnc.bn_apply_cuda(h, mean, mul, bias, dtype, True, **pro, pool=S)
    dx0 = bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **pro)
    before = bnc.bn_bwd_apply_cuda.sums.launches
    dx, dc, dd = bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **pro, sums=True)
    assert bnc.bn_bwd_apply_cuda.sums.launches == before + 1
    again = bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **pro, sums=True)
    assert torch.equal(dx, dx0) and all(torch.equal(u, v) for u, v in zip((dx, dc, dd), again) if u is not None)
    assert dd.dtype == torch.float32 and torch.equal(dd.to(dtype).float(), dd)
    wc, tc, wd, td = epilogue_reference(dx, S, prologue == "centre")
    assert within_f64_gate(dd, wd, td, dtype)
    if prologue == "centre":
        assert dc.dtype == dtype and dc.shape == corr.shape and within_f64_gate(dc, wc, tc, dtype)
    else:
        assert dc is None
    if dtype == torch.float32:
        plan = bnc.bn_plan(R, C, bnc._vec(C, h, dy, dx, corr), bnc.sm_count(0), "reduce_dx", S)
        wc32, wd32 = epilogue_sums(dx.cpu().numpy(), plan, S, prologue == "centre")
        assert np.array_equal(dd.cpu().numpy().view(np.uint32), wd32.view(np.uint32))
        if prologue == "centre":
            assert np.array_equal(dc.cpu().numpy().view(np.uint32), wc32.view(np.uint32))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("prologue", ["centre", "bias", None])
def test_bn_wide_pool_kernels_equal_their_plain_stages(cuda, relu, prologue):
    """bf16's pool variant of K2 and pooled K3 (8 channels a lane, bf16x2
    pairs): K2's maxima and counts bit-equal to the plain stage on the card
    with NaN inputs, -0 and +0 outputs and many ties (a NaN max has count
    0), and K3's sums within BN_SUM_TOL of the plain stage's and its
    coefficients bit-equal to the torch ops on its own sums; the wide plan
    taken (C % 8 == 0), the scalar one where C % 8 != 0 gives the same."""
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    for R, C, S in ((512 * 16, 64, 16), (40 * 64, 136, 64), (33 * 8, 12, 8)):
        h, corr, db, weight, bias, dy = chip_smoke.bn_site_inputs(R, C, torch.bfloat16, C, prologue, S, True)
        h = h.clone()
        h[5, :3] = float("nan")
        pro = dict(corr=corr, dense_bias=db)
        x = bn.layer_rows_plain(h, corr, db).float()
        mean = x.nan_to_num().mean(0)
        mul = torch.rand(C, device="cuda") + 0.5
        mul[1] = -1.0
        bias = bias.clone()
        bias[1] = -0.0
        assert bnc._wide(h, h, corr) == (C % 8 == 0)
        y = bnc.bn_apply_cuda(h, mean, mul, bias, torch.bfloat16, relu, **pro, pool=S)
        py = bn.bn_apply_plain(h, mean, mul, bias, torch.bfloat16, relu, **pro, pool=S)
        nan = torch.isnan(py[0])
        assert bool(nan.any()) and torch.equal(torch.isnan(y[0]), nan)
        assert torch.equal(y[0][~nan].view(torch.int16), py[0][~nan].view(torch.int16))
        assert torch.equal(y[1], py[1]) and int(y[1][nan].abs().sum()) == 0
        h[5, :3] = 0.0
        y = bnc.bn_apply_cuda(h, mean, mul, bias, torch.bfloat16, relu, **pro, pool=S)
        sg, sgx = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, relu, **pro, pooled=y)
        psg, psgx = bn.bn_bwd_reduce_plain(h, dy, mean, mul, bias, relu, **pro, pooled=y)
        g = bn._masked(bn.layer_rows_plain(h, corr, db), dy, mean, mul, bias, relu, y)
        xf = bn.layer_rows_plain(h, corr, db).float()
        for got, want, terms in ((sg, psg, g.abs().sum(0)), (sgx, psgx, (g * (xf - mean)).abs().sum(0))):
            assert bool(((got - want).abs() <= chip_smoke.BN_SUM_TOL * terms + 1e-30).all())


def bn_kernels_of(fn):
    """The short names of the CUDA kernels ``fn`` launches, in order
    (chip_smoke.device_kernel_names: torch.profiler)."""
    import re

    import chip_smoke

    return [(re.search(r"(\w+_kernel)\b", n) or re.search(r"(\S+)", n)).group(1)
            for n in chip_smoke.device_kernel_names(fn)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue,pool", [("centre", False), ("bias", True), ("bias", False)])
@pytest.mark.parametrize("group", [False, True], ids=["one-process", "group"])
def test_bn_site_launches_its_kernels_and_nothing_else(cuda, dtype, prologue, pool, group):
    """One site's training forward launches K1 + K2 and its backward K3 + K4
    and no other kernel (the per-channel arithmetic, the prologue's
    cotangent sums and the bias's casts are inside them), under a
    data-parallel group (a one-rank NCCL group) too, whose collectives (the
    sums' and the coefficients' all-reduces, in place) are all it adds; an
    eval forward under inference_mode launches K2 alone, and an eval
    backward K3 + K4."""
    import torch.distributed as dist

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.parallel.launch import free_port, init_process_group

    B, M, S, C = 4, 64, 16, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    h = (torch.randn((B, M, S, C), generator=g, device="cuda") * 2).to(dtype).requires_grad_(True)
    corr = (torch.randn((B, M, C), generator=g, device="cuda")).to(dtype).requires_grad_(True) \
        if prologue == "centre" else None
    db = torch.randn(C, generator=g, device="cuda").requires_grad_(True)
    w = torch.ones(C, device="cuda", requires_grad=True)
    b = torch.zeros(C, device="cuda", requires_grad=True)
    rm, rv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
    gp = torch.randn((B, M, C) if pool else (B, M, S, C), generator=g, device="cuda").to(dtype)
    kw = dict(dense_bias=db, corr=corr, pool="max" if pool else None)
    apply = "bn_apply_pool_kernel" if pool else "bn_apply_kernel"

    def kernels(fn):  # the collectives aside
        return [n for n in bn_kernels_of(fn) if "nccl" not in n.lower()]

    if group:
        init_process_group("nccl", 1, 0, free_port(), 120)
    try:
        kw["group"] = dist.group.WORLD if group else None
        for _ in range(2):  # the first round allocates the stream's tickets
            for t in (h, corr, db, w, b):
                if t is not None:
                    t.grad = None
            out = {}
            fwd = kernels(lambda: out.setdefault("y", ops.batch_norm_relu(h, w, b, rm, rv, training=True, **kw)))
            bwd = kernels(lambda: out["y"].backward(gp))
    finally:
        if group:
            dist.destroy_process_group()
    assert fwd == ["bn_stats_kernel", apply], fwd
    assert bwd == ["bn_bwd_reduce_kernel", "bn_bwd_apply_kernel"], bwd
    assert db.grad.dtype == torch.float32 and (corr is None or corr.grad.dtype == dtype)
    kw["group"] = None
    with torch.inference_mode():
        ev = kernels(lambda: ops.batch_norm_relu(h.detach(), w, b, rm, rv, training=False, **kw))
    assert ev == [apply], ev
    for t in (h, corr, db, w, b):  # no gradient to accumulate into
        if t is not None:
            t.grad = None
    y = ops.batch_norm_relu(h, w, b, rm, rv, training=False, **kw)
    ev_bwd = kernels(lambda: y.backward(gp))
    assert ev_bwd == ["bn_bwd_reduce_kernel", "bn_bwd_apply_kernel"], ev_bwd


# ------------------------------------- the split prologue and the weight casts

def test_cast_bf16_multi_matches_torch_cast_on_the_card(cuda):
    """chip_smoke.py's phase-33 cast gates: a full-width bf16 VoteNet's weight
    views and the special values (ties, subnormals, +-inf, NaNs with
    payloads) cast in one launch bit-equal to the card's
    ``.to(torch.bfloat16)``, NaN bits included; the reverse into transposed
    f32 destinations and zero fills bit-equal to ``.float()`` and zeros."""
    import chip_smoke

    checks, _, _, _ = chip_smoke.cast_check()
    assert all(checks.values()), checks


def test_cast_bf16_multi_splits_a_long_table(cuda):
    """More than CAST_MAX_ENTRIES pairs take a launch per CAST_MAX_ENTRIES,
    each pair cast as torch casts it."""
    from votenet_tpu_torch.ops.cuda.cast import CAST_MAX_ENTRIES, cast_bf16_multi_cuda

    g = torch.Generator(device="cuda").manual_seed(3)
    srcs = [torch.randn((i % 7 + 1, i % 5 + 2), generator=g, device="cuda") * 1e3 for i in range(CAST_MAX_ENTRIES + 5)]
    dsts = [torch.empty(s.shape, dtype=torch.bfloat16, device="cuda") for s in srcs]
    before = cast_bf16_multi_cuda.launches
    cast_bf16_multi_cuda(list(zip(srcs, dsts)))
    assert cast_bf16_multi_cuda.launches - before == 2
    assert all(torch.equal(d.view(torch.int16), s.to(torch.bfloat16).view(torch.int16)) for s, d in zip(srcs, dsts))


SPLIT_CASES = [(8 * 1024 * 64, 64, 128, 131, "sa2 B=8"), (1024 * 64, 64, 128, 131, "sa2 B=1"),
               (8 * 512 * 32, 32, 128, 259, "sa3 B=8"), (256 * 32, 32, 128, 259, "sa4 B=1"),
               (40 * 16, 16, 13, 20, "unaligned"), (3 * 5, 5, 36, 9, "small"),
               (8 * 2048 * 64, 64, 64, 6, "sa1 B=8"), (9000 * 30, 30, 128, 131, "S=30, 3 chunks a CTA"),
               (400 * 150, 150, 128, 131, "S=150, windows"), (500 * 64, 64, 36, 131, "C=36, 4 a lane"),
               (3000 * 16, 16, 13, 20, "C=13, 1 a lane"), (37 * 7, 7, 128, 9, "S=7, 37 units"),
               (700 * 16, 16, 72, 20, "C=72, 28 row groups"), (64 * 8, 8, 2056, 9, "C=2056, 2 tiles"),
               (8 * 256 * 32, 32, 128, 259, "sa4 B=8")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("R,S,C,cin,what", SPLIT_CASES, ids=[c[-1] for c in SPLIT_CASES])
def test_split_prologue_kernels_match_plain(cuda, dtype, R, S, C, cin, what):
    """chip_smoke.py's phase-33 gates: K2 (training, eval, a group's end, NaN
    inputs) and K4 with the split prologue bit-equal to their plain
    versions, K1's and K3's sums within the f64 gate and their ends bit for
    bit (K1's sums NaN where the plain sums are), K4's bias and W3
    cotangents within the f64 gate; at the sites' shapes (bf16_hilo's sa1
    too) and at the split kernels' edges (chip_smoke.SPLIT_EDGES: S not a
    multiple of the rows in flight, several chunks of units a CTA, units
    longer than a staging window, 4 channels a lane and one, row groups
    that leave threads idle, two tiles of channels)."""
    import chip_smoke

    _, bad, summary, _ = chip_smoke.split_check(R, S, C, cin, dtype, seed=R + C, times=False)
    assert not bad, summary


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("R,S,C", [(8 * 1024 * 64, 64, 128), (8 * 2048 * 64, 64, 64), (9000 * 30, 30, 128),
                                   (400 * 150, 150, 128), (500 * 64, 64, 36), (3000 * 16, 16, 13),
                                   (700 * 16, 16, 72), (64 * 8, 8, 2056)])
def test_split_sums_follow_the_stated_order(cuda, dtype, R, S, C):
    """The split K1's and K3's sums, and the split K4's dense-bias and W3
    sums, equal bit for bit the numpy transcriptions of their orders
    (tests/test_torch_bn_layer.py ``kernel_sums``, ``split_k4_sums``) from
    their launch plans on this card's SM count (the split K1 at 8 channels
    a lane in bf16 with C % 8 == 0, ``"reduce_split_wide"``, else
    ``"reduce_split"``; the split K3 and K4 at 4 channels a lane or 1,
    ``"reduce_dy_split"`` and ``"reduce_dx_split"``), over x as the plain
    split prologue forms it, g as the plain stage masks dy, and the
    kernel's dx."""
    from tests.test_torch_bn_layer import k1_terms, k3_terms, kernel_sums, split_k4_sums
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, coords, db, _, bias, dy = chip_smoke.split_site_inputs(R, S, C, 9, dtype, R + C)
    x = bn.layer_rows_plain(h, None, db, coords)
    sms = bnc.sm_count(0)
    wide = bnc._wide(h, h)
    kind = "reduce_split_wide" if wide else "reduce_split"
    plan = bnc.bn_plan(R, C, wide or bnc._vec(C, h), sms, kind, S, 8 if wide else 4)
    s, sq = (v.float() for v in bnc.bn_stats_cuda(h, dense_bias=db, coords=coords))
    for got, terms in zip((s, sq), k1_terms(x.float().cpu().numpy())):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), kernel_sums(terms, plan, S).view(np.uint32))
    # K3s: g and g * f32(x - mean)
    gen = torch.Generator(device="cuda").manual_seed(R + C)
    mean = (s / R).float()
    mul = torch.rand(C, generator=gen, device="cuda") + 0.5
    pro = dict(dense_bias=db, coords=coords)
    plan3 = bnc.bn_plan(R, C, bnc._vec(C, h, dy), sms, "reduce_dy_split", S)
    sg, sgx = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **pro)
    g = bn._masked(x, dy, mean, mul, bias, True)
    for got, terms in zip((sg, sgx), k3_terms(g.cpu().numpy(), x.float().cpu().numpy(), mean.cpu().numpy())):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), kernel_sums(terms, plan3, S).view(np.uint32))
    # K4s: the dense bias's and W3's sums of its dx
    a, b = (torch.randn(C, generator=gen, device="cuda") * 1e-3 for _ in range(2))
    dx, _, d_bias, d_w3 = bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **pro)
    plan4 = bnc.bn_plan(R, C, bnc._vec(C, h, dy, dx), sms, "reduce_dx_split", S)
    want_b, want_w3 = split_k4_sums(dx.float().cpu().numpy(), coords.xyz.cpu().numpy(), coords.centre.cpu().numpy(),
                                    plan4, S, str(dtype)[6:])
    for got, want in ((d_bias, want_b), (d_w3, want_w3)):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("relu,with_bias", [(False, True), (True, False), (False, False)],
                         ids=["no-relu", "no-bias", "neither"])
@pytest.mark.parametrize("R,S,C", [(512 * 64, 64, 128), (300 * 16, 16, 36)])
def test_split_backward_without_the_relu_or_the_bias(cuda, dtype, relu, with_bias, R, S, C):
    """The split K3 and K4 where the ReLU or the dense bias is absent (the
    kernels' run-time-flag instances; the model's split layers take the
    instance with both): K4's dx (training and eval) bit-equal to its plain
    version, K3's sums and K4's dense-bias and W3 sums bit-equal to the
    numpy transcriptions of their orders (tests/test_torch_bn_layer.py)."""
    from tests.test_torch_bn_layer import k3_terms, kernel_sums, split_k4_sums
    import chip_smoke
    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, coords, db, _, bias, dy = chip_smoke.split_site_inputs(R, S, C, 9, dtype, R + C)
    pro = dict(dense_bias=db if with_bias else None, coords=coords)
    x = bn.layer_rows_plain(h, None, pro["dense_bias"], coords)
    gen = torch.Generator(device="cuda").manual_seed(R)
    mean = x.float().mean(0)
    mul = torch.rand(C, generator=gen, device="cuda") + 0.5
    a, b = (torch.randn(C, generator=gen, device="cuda") * 1e-3 for _ in range(2))
    sms = bnc.sm_count(0)
    plan3 = bnc.bn_plan(R, C, bnc._vec(C, h, dy), sms, "reduce_dy_split", S)
    sg, sgx = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, relu, **pro)
    g = bn._masked(x, dy, mean, mul, bias, relu)
    for got, terms in zip((sg, sgx), k3_terms(g.cpu().numpy(), x.float().cpu().numpy(), mean.cpu().numpy())):
        assert np.array_equal(got.cpu().numpy().view(np.uint32), kernel_sums(terms, plan3, S).view(np.uint32))
    for ab in ((a, b), (None, None)):
        dx, _, d_bias, d_w3 = bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, *ab, relu, **pro)
        want = bn.bn_bwd_apply_plain(h, dy, mean, mul, bias, *ab, relu, **pro, sums=True)[0]
        assert torch.equal(dx.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
        plan4 = bnc.bn_plan(R, C, bnc._vec(C, h, dy, dx), sms, "reduce_dx_split", S)
        want_b, want_w3 = split_k4_sums(dx.float().cpu().numpy(), coords.xyz.cpu().numpy(),
                                        coords.centre.cpu().numpy(), plan4, S, str(dtype)[6:])
        assert (d_bias is None) != with_bias
        assert np.array_equal(d_w3.cpu().numpy().view(np.uint32), want_w3.view(np.uint32))
        if with_bias:
            assert np.array_equal(d_bias.cpu().numpy().view(np.uint32), want_b.view(np.uint32))


@pytest.mark.parametrize("mode", ["bf16", "bf16-remat", "mixed"])
def test_training_step_launches_and_bits_with_the_copies(cuda, mode):
    """A tiny training step on the card in bf16 (and under remat) and in
    mixed precision: the copies' two casts a step (the refresh after the
    optimizer's step, the gradients' return), the split kernels at mixed
    precision's split first layers, every launch as chip_smoke.py's
    step_launches counts it; in bf16 the losses, gradients and running
    statistics bit-equal to the same step without the copies (casts at every
    call), under deterministic algorithms."""
    import chip_smoke

    from tests.test_torch_weight_cast import without_copies
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step

    overrides = {"bf16": dict(compute_dtype="bfloat16"), "bf16-remat": dict(compute_dtype="bfloat16", remat=True),
                 "mixed": dict(mixed_precision=True)}[mode]
    cfg = tiny_config(**overrides)
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    state = create_train_state(cfg, 10, torch.Generator().manual_seed(2), device="cuda")
    step = make_train_step(cfg)
    step(state, batch)  # the first step makes the copies
    counters = chip_smoke.train_counters()
    chip_smoke.zero_counts(counters)
    step(state, batch)
    torch.cuda.synchronize()
    assert chip_smoke.launch_counts(counters) == chip_smoke.step_launches(cfg)
    if mode == "mixed":
        return
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for copies in (True, False):
            st = create_train_state(cfg, 10, torch.Generator().manual_seed(2), device="cuda")
            if not copies:
                without_copies(st.model)
            losses = forward_backward(st.model, batch, cfg)
            runs.append([*losses] + [p.grad for p in st.model.parameters()] + list(st.model.buffers()))
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_copies_follow_the_optimizer_on_the_card(cuda):
    """Adam's step on the card (its multi-tensor form) moves the parameters'
    versions: the next forward's copies are the new parameters' casts, made
    in one launch; a serving forward after it launches none."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.ops.cuda.cast import cast_bf16_multi_cuda
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config(compute_dtype="bfloat16")
    batch = next(batch_scenes(iter(synthetic_scenes(1, cfg, 2)), 2, cfg.max_gt_boxes))
    state = create_train_state(cfg, 10, device="cuda")
    make_train_step(cfg)(state, batch)
    model = state.model.eval()
    pts = torch.as_tensor(batch["points"]).cuda()
    before = cast_bf16_multi_cuda.launches
    with torch.inference_mode():
        model(pts)
        once = cast_bf16_multi_cuda.launches - before
        model(pts)
    torch.cuda.synchronize()
    assert once == 1 and cast_bf16_multi_cuda.launches - before == 1
    for e in model.bf16_copies.entries.values():
        from votenet_tpu_torch.models.bf16_copies import source_view

        want = source_view(e.layer, e.kind).detach().to(torch.bfloat16)
        assert torch.equal(e.copy.view(torch.int16), want.contiguous().view(torch.int16))


def test_copies_follow_the_model_to_the_card(cuda):
    """A bf16 model whose copies were made on the CPU, moved to the card
    (``.cuda()`` swaps every parameter's storage): its next forward makes
    the copies anew on the card in one launch, each the card's cast of its
    parameter, and the output equals a model built on the card's."""
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.models.bf16_copies import source_view
    from votenet_tpu_torch.ops.cuda.cast import cast_bf16_multi_cuda

    cfg = tiny_config(compute_dtype="bfloat16")
    pts = torch.from_numpy(cloud(4, 2, 1024, "scene"))
    model = VoteNet(cfg, torch.Generator().manual_seed(3)).eval()
    with torch.no_grad():
        model(pts)  # the copies on the CPU
        model.cuda()
        before = cast_bf16_multi_cuda.launches
        got = model(pts.cuda())
        torch.cuda.synchronize()
        assert cast_bf16_multi_cuda.launches - before == 1
        for e in model.bf16_copies.entries.values():
            want = source_view(e.layer, e.kind).detach().to(torch.bfloat16).contiguous()
            assert e.copy.is_cuda and torch.equal(e.copy.view(torch.int16), want.view(torch.int16))
        fresh = VoteNet(cfg, torch.Generator().manual_seed(3)).cuda().eval()
        want = fresh(pts.cuda())
    assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------- attention (csrc/attention.cu)

ATTENTION_CASES = [(64, 256, 256), (64, 256, 1024), (3, 100, 77), (2, 300, 1000), (1, 1, 1), (2, 257, 65),
                   (1, 513, 17)]


def attention_inputs(B, Lq, Lk, seed, scale=1.0, E=288):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, Lq, E, generator=g, device="cuda") * scale
    k, v = (torch.randn(B, Lk, 2 * E, generator=g, device="cuda") * scale).split(E, dim=-1)
    return q, k, v


@pytest.mark.parametrize("B,Lq,Lk", ATTENTION_CASES)
def test_attention_kernel_matches_plain(cuda, B, Lq, Lk):
    """The kernel at the cell's shapes (B=64: self 256 x 256, cross 256 x
    1024) and at ragged ones (Lq past a block's 256 queries, Lk past a
    64-key tile and a 16-key chunk), k and v views of one wider tensor:
    against an f64 run, within four times the plain f32 chain's own gap
    (and 1e-6 of the output's scale): both round the scores, whose size
    (here up to ~20) the exponential carries into the weights, and both
    sum 36 products and up to 1024 terms in f32, in other orders."""
    from votenet_tpu_torch.ops.cuda.attention import multi_head_attention_cuda, multi_head_attention_plain

    q, k, v = attention_inputs(B, Lq, Lk, B * Lq + Lk, scale=2.0)
    got = multi_head_attention_cuda(q, k, v, 8)
    torch.cuda.synchronize()
    want = multi_head_attention_plain(q.double(), k.double(), v.double(), 8)
    plain = multi_head_attention_plain(q, k, v, 8)
    scale = float(want.abs().max())
    plain_gap = float((plain.double() - want).abs().max())
    assert float((got.double() - want).abs().max()) <= 4 * max(plain_gap, 1e-6 * scale)


def test_attention_kernel_takes_the_in_projections_views(cuda):
    """q, k and v as the self-attention hands them: three views of one (B, L,
    3E) product, rows 3E apart."""
    from votenet_tpu_torch.ops.cuda.attention import multi_head_attention_cuda, multi_head_attention_plain

    qkv = torch.randn(4, 256, 864, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    q, k, v = qkv.split(288, dim=-1)
    got = multi_head_attention_cuda(q, k, v, 8)
    want = multi_head_attention_plain(q.double(), k.double(), v.double(), 8)
    assert float((got.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())


def test_attention_kernel_counts_one_launch_a_call_and_refuses_other_shapes(cuda):
    from votenet_tpu_torch.ops import multi_head_attention
    from votenet_tpu_torch.ops.cuda.attention import multi_head_attention_cuda

    q, k, v = attention_inputs(2, 16, 40, 3)
    before = multi_head_attention_cuda.launches
    multi_head_attention(q, k, v, 8)
    multi_head_attention(q, k, v, 8)
    assert multi_head_attention_cuda.launches - before == 2
    with pytest.raises(ValueError, match="36 channels"):
        multi_head_attention_cuda(q, k, v, 4)  # heads of 72
    with pytest.raises(ValueError, match="strides"):
        multi_head_attention_cuda(torch.zeros(2, 16, 289, device=cuda)[:, :, 1:], k, v, 8)  # rows 289 apart
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        multi_head_attention_cuda(q.cpu(), k, v, 8)


def test_groupfree_on_the_card_within_the_cells_limits(cuda):
    """Group-Free 3D at its published widths, B=4 scenes and weights as the
    benchmark makes them (the cell eval_gf3d_l6o256_b64), through
    ``make_packed_predict_fn``: the detections against the plain
    reference's within the cell's limits; 12 attention launches a
    forward."""
    from portbench import harness
    from portbench.drivers.eval_groupfree import comparison, program_config, reference_detections, scenes, weights
    from portbench.yardstick.compare import judge
    from votenet_tpu_torch.eval.evaluator import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models.groupfree import GroupFree3D
    from votenet_tpu_torch.ops.cuda.attention import multi_head_attention_cuda

    cell = harness.load_cell("eval_gf3d_l6o256_b64")
    cfg, limits = cell.model, cell.limits
    gcfg = program_config(cell)
    sd = weights(cell, 2 ** 31 + 11, cuda)
    model = GroupFree3D(gcfg).to(cuda)
    model.load_state_dict(sd)
    points = scenes(2 ** 31 + 12, 4, cfg, cuda)
    host = points.cpu().numpy()
    before = multi_head_attention_cuda.launches
    dets = Evaluator(gcfg.base, {}, batch_size=4).predictions_for_scenes(
        make_packed_predict_fn(model, gcfg.base), DeviceSceneCache(((i, host[i]) for i in range(4)), 4, device=cuda))
    assert multi_head_attention_cuda.launches - before == 2 * gcfg.num_layers
    ref = reference_detections(sd, points, cell, block=4)
    numbers = comparison([dets[i] for i in range(4)], ref, limits["tau"])
    assert numbers["ref_kept"] > 0 and judge(numbers, limits)[0], numbers
