"""Parity of the port's ops (votenet_tpu_torch.ops) with the JAX package.

Inputs are numpy arrays from fixed seeds, handed to both. On the CPU the
port runs the plain versions of its kernels; the JAX package runs its XLA
twins and, where it has one, its Pallas kernel in interpret mode. Integer
outputs must be equal; float tolerances are stated where they apply.
"""

import numpy as np
import pytest
import torch

from tests import oracles
from votenet_tpu.config import tiny_config
from votenet_tpu.data.synthetic import synthetic_scene
from votenet_tpu_torch import ops
from votenet_tpu_torch.ops.cuda.ballquery import radius_sq


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def grid_cloud(rng, B, shape=(8, 8, 4)):
    """Integer-grid points, shuffled: every distance is an exact small
    integer, so FPS and three_nn meet many exact ties."""
    g = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1).reshape(-1, 3)
    return np.stack([g[rng.permutation(len(g))] for _ in range(B)]).astype(np.float32)


def scene_cloud(rng, B, n):
    """Clustered SUN RGB-D-like clouds (boxes on a room background)."""
    cfg = tiny_config(point_num=n)
    return np.stack([synthetic_scene(rng, cfg)["points"] for _ in range(B)])


# --------------------------------------------------------------------- FPS

FPS_CASES = {
    "normal-2x128": lambda r: (r.randn(2, 128, 3).astype(np.float32), 32),
    "ragged-3x300": lambda r: (r.randn(3, 300, 3).astype(np.float32), 64),
    "batch-8x512": lambda r: (r.randn(8, 512, 3).astype(np.float32), 128),
    "npoint1": lambda r: (r.randn(1, 64, 3).astype(np.float32), 1),
    "ragged-5x1111": lambda r: (r.randn(5, 1111, 3).astype(np.float32), 97),
    "scene-2x2000": lambda r: (scene_cloud(r, 2, 2000), 300),
    "ties-grid": lambda r: (grid_cloud(r, 2), 100),
    "ties-identical": lambda r: (np.ones((2, 50, 3), np.float32), 7),
}


def fps_run(name):
    xyz, m = FPS_CASES[name](np.random.RandomState(0))
    return xyz, m, ops.farthest_point_sample(m, t(xyz))


@pytest.mark.parametrize("name", sorted(FPS_CASES))
def test_fps_plain_matches_xla_twin(name):
    from votenet_tpu.ops.sampling import farthest_point_sample_xla

    xyz, m, got = fps_run(name)
    assert got.dtype == torch.int32 and tuple(got.shape) == (xyz.shape[0], m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(farthest_point_sample_xla(m, xyz)))


@pytest.mark.parametrize("name", sorted(FPS_CASES))
def test_fps_plain_matches_oracle(name):
    xyz, m, got = fps_run(name)
    np.testing.assert_array_equal(got.numpy(), oracles.fps_oracle(m, xyz))


@pytest.mark.parametrize("kernel", ["batched", "rowwise"])
@pytest.mark.parametrize("name", sorted(FPS_CASES))
def test_fps_plain_matches_pallas_interpret(name, kernel):
    from votenet_tpu.ops.pallas.fps import (
        farthest_point_sample_pallas,
        farthest_point_sample_pallas_rowwise,
    )

    xyz, m, got = fps_run(name)
    fn = farthest_point_sample_pallas if kernel == "batched" else farthest_point_sample_pallas_rowwise
    np.testing.assert_array_equal(got.numpy(), np.asarray(fn(m, xyz, interpret=True)))


def test_fps_slot0_is_index0_and_all_zero_on_identical_points():
    got = ops.farthest_point_sample(5, torch.ones(3, 10, 3))
    assert torch.equal(got, torch.zeros(3, 5, dtype=torch.int32))


# -------------------------------------------------------------- ball query

def band_free(xyz1, xyz2, radius, rel=1e-6):
    """No point-query pair within ``rel`` of r^2 (where roundings differ)."""
    d2 = ((xyz2[:, :, None, :].astype(np.float64) - xyz1[:, None, :, :]) ** 2).sum(-1)
    return np.abs(d2 / np.float64(radius) ** 2 - 1.0).min() > rel


BQ_CASES = {
    "scene-sa1": lambda r: (scene_cloud(r, 2, 512), 128, 0.2, 64),
    "scene-sa2": lambda r: (scene_cloud(r, 2, 512), 96, 0.4, 64),
    "scene-sa3": lambda r: (scene_cloud(r, 2, 256), 64, 0.8, 16),
    "scene-sa4": lambda r: (scene_cloud(r, 2, 256), 32, 1.2, 64),
    "normal-proposal": lambda r: (r.randn(2, 300, 3).astype(np.float32), 50, 0.3, 8),
    "saturated": lambda r: ((r.randn(1, 200, 3) * 0.05).astype(np.float32), 20, 0.4, 16),
}


@pytest.fixture(params=sorted(BQ_CASES))
def bq_case(request):
    xyz1, M, radius, S = BQ_CASES[request.param](np.random.RandomState(1))
    xyz2 = xyz1[:, :M].copy()
    # a query far from every point: empty ball
    xyz2[0, -1] = 100.0
    assert band_free(xyz1, xyz2, radius)
    idx, cnt = ops.query_ball_point(radius, S, t(xyz1), t(xyz2))
    return xyz1, xyz2, radius, S, idx, cnt


def test_ball_query_plain_matches_xla_twin(bq_case):
    from votenet_tpu.ops.grouping import _query_ball_point_dense

    xyz1, xyz2, radius, S, idx, cnt = bq_case
    want_idx, want_cnt = _query_ball_point_dense(radius, S, "exact", xyz1, xyz2)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert cnt[0, -1] == 0 and torch.all(idx[0, -1] == 0)


def test_ball_query_plain_matches_pallas_interpret(bq_case):
    from votenet_tpu.ops.pallas.ballquery import query_ball_point_pallas

    xyz1, xyz2, radius, S, idx, cnt = bq_case
    want_idx, want_cnt = query_ball_point_pallas(radius, S, xyz1, xyz2, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))


def test_ball_query_plain_matches_oracle(bq_case):
    xyz1, xyz2, radius, S, idx, cnt = bq_case
    want_idx, want_cnt = oracles.query_ball_oracle(radius, S, xyz1, xyz2)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)


def test_ball_query_r2_is_squared_in_float32():
    for r in (0.2, 0.4, 0.8, 1.2, 0.3):
        assert radius_sq(r) == float(np.float32(r) * np.float32(r))
    # at 0.2 the f32 square is one ulp above the rounded double square
    assert radius_sq(0.2) == float(np.float32(0.040000003))
    assert float(np.float32(0.2 ** 2)) == float(np.float32(0.04)) < radius_sq(0.2)


def test_ball_query_r2_boundary_follows_xla_twin():
    """d2 of this point is 0.039999996: below float32(0.2)**2 = 0.040000003
    (the twin's rule, and the port's) but not below float32(0.2**2) = 0.04
    (the Pallas kernel's). The port counts it as a hit."""
    from votenet_tpu.ops.grouping import _query_ball_point_dense
    from votenet_tpu.ops.pallas.ballquery import query_ball_point_pallas

    p = np.array([[[0.19999999, 5e-05, 0.0], [1.0, 1.0, 1.0]]], np.float32)
    q = np.zeros((1, 1, 3), np.float32)
    idx, cnt = ops.query_ball_point(0.2, 4, t(p), t(q))
    twin_idx, twin_cnt = _query_ball_point_dense(0.2, 4, "exact", p, q)
    assert int(cnt[0, 0]) == 1 and idx[0, 0].tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(twin_cnt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(twin_idx))
    # the split this rule settles: the Pallas kernel misses the point
    _, pallas_cnt = query_ball_point_pallas(0.2, 4, p, q, interpret=True)
    assert int(np.asarray(pallas_cnt)[0, 0]) == 0


def test_finalize_first_k_matches_jax():
    from votenet_tpu.ops.grouping import finalize_first_k as jax_finalize

    rng = np.random.RandomState(2)
    idx = rng.randint(0, 50, (2, 7, 6)).astype(np.int32)
    cnt = rng.randint(0, 7, (2, 7)).astype(np.int32)
    got_idx, got_cnt = ops.finalize_first_k(t(idx), t(cnt), 6)
    want_idx, want_cnt = jax_finalize(idx, cnt, 6)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))


# ------------------------------------------------------- gathers and 3-NN

def test_gather_point_and_group_point_match_jax():
    from votenet_tpu.ops.grouping import group_point as jax_group
    from votenet_tpu.ops.sampling import gather_point as jax_gather

    rng = np.random.RandomState(3)
    pts = rng.randn(2, 40, 5).astype(np.float32)
    idx2 = rng.randint(0, 40, (2, 11)).astype(np.int32)
    idx3 = rng.randint(0, 40, (2, 11, 4)).astype(np.int32)
    np.testing.assert_array_equal(ops.gather_point(t(pts), t(idx2)).numpy(), np.asarray(jax_gather(pts, idx2)))
    got = ops.group_point(t(pts), t(idx3)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_group(pts, idx3)))
    np.testing.assert_array_equal(got, oracles.group_point_oracle(pts, idx3))


@pytest.mark.parametrize("cloud", ["normal", "scene", "ties-grid"])
def test_three_nn_matches_jax_and_oracle(cloud):
    from votenet_tpu.ops.interpolate import three_nn_dense

    rng = np.random.RandomState(4)
    if cloud == "normal":
        x1, x2 = rng.randn(2, 200, 3).astype(np.float32), rng.randn(2, 50, 3).astype(np.float32)
    elif cloud == "scene":
        x1 = scene_cloud(rng, 2, 256)
        x2 = np.ascontiguousarray(x1[:, ::4])
    else:
        x1 = grid_cloud(rng, 2, (4, 4, 4)) + 0.5
        x2 = grid_cloud(rng, 2, (4, 4, 4))
    dist, idx = ops.three_nn(t(x1), t(x2))
    want_dist, want_idx = three_nn_dense(x1, x2)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # XLA on the CPU fuses d2 into FMAs; the port does not: <= 1e-6 relative
    np.testing.assert_allclose(dist.numpy(), np.asarray(want_dist), rtol=1e-6, atol=1e-6)
    o_dist, o_idx = oracles.three_nn_oracle(x1, x2)
    np.testing.assert_array_equal(idx.numpy(), o_idx)
    np.testing.assert_array_equal(dist.numpy(), o_dist)


def test_three_interpolate_matches_jax_and_oracle():
    from votenet_tpu.ops.interpolate import three_interpolate as jax_interp

    rng = np.random.RandomState(5)
    pts = rng.randn(2, 30, 16).astype(np.float32)
    idx = rng.randint(0, 30, (2, 50, 3)).astype(np.int32)
    w = rng.uniform(0, 1, (2, 50, 3)).astype(np.float32)
    got = ops.three_interpolate(t(pts), t(idx), t(w)).numpy()
    # summation order of three terms may differ: <= 1e-6 relative
    np.testing.assert_allclose(got, np.asarray(jax_interp(pts, idx, w)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, oracles.three_interpolate_oracle(pts, idx, w), rtol=1e-6, atol=1e-6)


def test_pairwise_sqdist_rounding_order():
    """(dx*dx + dy*dy) + dz*dz in f32, unfused: the kernels' order."""
    rng = np.random.RandomState(6)
    a, b = rng.randn(2, 30, 3).astype(np.float32), rng.randn(2, 40, 3).astype(np.float32)
    d = a[:, :, None] - b[:, None]
    want = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    np.testing.assert_array_equal(ops.pairwise_sqdist(t(a), t(b)).numpy(), want)


def test_ops_reject_other_devices():
    x = torch.zeros(1, 8, 3, device="meta")
    with pytest.raises(NotImplementedError):
        ops.farthest_point_sample(2, x)
    with pytest.raises(NotImplementedError):
        ops.query_ball_point(0.2, 4, x, x)


# ----------------------------------------------------------- IoU and NMS

def test_box3d_iou_matrix_matches_jax():
    from votenet_tpu.ops.iou3d import box3d_iou_matrix as jax_iou

    rng = np.random.RandomState(7)
    b1 = oracles.random_boxes(rng, (2, 24))
    b2 = oracles.random_boxes(rng, (2, 17))
    got = ops.box3d_iou_matrix(t(b1), t(b2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_iou(b1, b2)), rtol=0, atol=1e-5)
    for i, j in [(0, 0), (3, 5), (10, 16), (23, 2)]:
        assert got[1, i, j] == pytest.approx(oracles.shapely_iou3d(b1[1, i], b2[1, j]), abs=1e-5)


def test_quad_area_and_containment():
    from votenet_tpu_torch.ops.iou3d import convex_quad_intersection_area_edgeclip, quad_signed_area

    big = torch.tensor([[-2.0, -2], [2, -2], [2, 2], [-2, 2]])
    small = torch.tensor([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    assert float(quad_signed_area(big)) == 16.0
    assert float(quad_signed_area(big.flip(0))) == -16.0
    assert float(convex_quad_intersection_area_edgeclip(small, big)) == pytest.approx(4.0, rel=1e-6)
    assert float(convex_quad_intersection_area_edgeclip(big, small.flip(0))) == pytest.approx(4.0, rel=1e-6)


@pytest.mark.parametrize("n_cand", [40, 150, 230])
def test_nms3d_keep_matches_jax(n_cand):
    """Candidate counts in each of the JAX package's tiers (<=64, <=160,
    dense); the port always runs dense. Keep masks must be equal."""
    from votenet_tpu.ops.nms3d import nms3d as jax_nms

    rng = np.random.RandomState(8 + n_cand)
    B, N = 2, 256
    corners = oracles.random_boxes(rng, (B, N))
    scores = rng.randn(B, N).astype(np.float32)
    scores[:, 10:20] = scores[:, :10]  # equal scores: the lower index wins
    obj = np.zeros((B, N, 2), np.float32)
    for b in range(B):
        obj[b, rng.permutation(N)[:n_cand], 1] = 1.0
    keep = ops.nms3d(t(corners), t(scores), t(obj), 0.25)
    want = np.asarray(jax_nms(corners, scores, obj, 0.25))
    assert keep.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < B * n_cand  # some kept, some suppressed


def test_nms3d_keep_matches_oracle():
    rng = np.random.RandomState(9)
    corners = oracles.random_boxes(rng, (1, 48))
    scores = rng.randn(1, 48).astype(np.float32)
    obj = rng.randn(1, 48, 2).astype(np.float32)
    keep = ops.nms3d(t(corners), t(scores), t(obj), 0.25)
    np.testing.assert_array_equal(keep.numpy(), oracles.nms3d_oracle(corners, scores, obj, 0.25))
