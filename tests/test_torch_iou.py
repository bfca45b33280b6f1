"""The port's oriented-box IoU against the JAX package's, on the CPU.

``ops.box3d_iou_matrix`` runs the kernel of ``csrc/iou3d.cu`` on a CUDA
tensor and its plain version on a CPU tensor; both add in one stated order
so that the card and the CPU compute the same floats (the kernel against
the plain version is in ``tests/test_torch_cuda.py``). Here the plain
version is held within 1e-5 of JAX's (whose ``jnp.sum`` XLA may add in
another order or contract into FMAs) on rotated, degenerate and identical
boxes, float for float to a numpy transcription of the kernel's
arithmetic, and the ported cross-check formulations (rank, Sutherland-
Hodgman, sort) to JAX's and to the shapely oracle.
"""

import numpy as np
import pytest
import torch

from tests import oracles
from votenet_tpu_torch import ops
from votenet_tpu_torch.ops import iou3d

TOL = 1e-5  # tests/test_torch_ops.py::test_box3d_iou_matrix_matches_jax's


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """At most two torch threads, as ``tests/test_torch_checkpoint.py``'s
    fixture (not imported from there: that file imports JAX, and
    ``tests/test_torch_cuda.py`` imports ``boxes`` from this one on the
    card's machine, which has none)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def boxes(kind, rng, shape):
    """Corners (..., 8, 3) of a kind of box set."""
    b = oracles.random_boxes(rng, shape)
    if kind == "identical":  # every box twice: IoU 1 on the diagonal pairs
        n = shape[-1] // 2 * 2
        b[..., 1:n:2, :, :] = b[..., 0:n:2, :, :]
    elif kind == "degenerate":  # zero-area top faces and zero heights among them
        b[..., 0::3, 1, :] = b[..., 0::3, 0, :]
        b[..., 0::3, 2, :] = b[..., 0::3, 3, :]
        b[..., 1::3, 4:, 1] = b[..., 1::3, :4, 1]
    elif kind == "axis":  # unrotated, on a grid: edges that share lines, parallel planes
        c = rng.randint(-2, 3, shape + (3,)).astype(np.float32) * 0.5
        s = rng.randint(1, 4, shape + (3,)).astype(np.float32) * 0.5
        sign = np.array([[1, 1, 1], [-1, 1, 1], [-1, 1, -1], [1, 1, -1],
                         [1, -1, 1], [-1, -1, 1], [-1, -1, -1], [1, -1, -1]], np.float32)
        b = c[..., None, :] + 0.5 * s[..., None, :] * sign
    return b.astype(np.float32)


KINDS = ["rotated", "identical", "degenerate", "axis"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_iou_matrix_matches_jax(kind):
    """Within 1e-5 of JAX's on every pair of distinct solid boxes. A box
    against an identical one (the diagonal of a self-IoU matrix) is exactly
    1 here, the cap min(|area|) holding the doubled collinear boundary; a
    pair with a box of no volume (a top face folded to a segment, or no
    height) is exactly 0. JAX's CPU build is not compared on those pairs:
    XLA contracts the cross products into FMAs, which leave a collinear
    edge's c0 a few ulps below zero (the edge then counts as outside, and an
    identical pair reads anywhere in [0, 1]: 0.0, 0.119, 0.778, ...) and a
    folded quad's shoelace a few ulps from zero (a sign, so a sliver of
    volume: 0.055 and 0.189 between two such boxes)."""
    from votenet_tpu.ops.iou3d import box3d_iou_matrix as jax_iou

    rng = np.random.RandomState(KINDS.index(kind))
    b1, b2 = boxes(kind, rng, (2, 30)), boxes(kind, rng, (2, 19))
    solid1, solid2 = volume(b1) > 1e-6, volume(b2) > 1e-6
    got = ops.box3d_iou_matrix(t(b1), t(b2)).numpy()
    both = solid1[:, :, None] & solid2[:, None, :]
    np.testing.assert_allclose(got[both], np.asarray(jax_iou(b1, b2))[both], rtol=0, atol=TOL)
    assert got.dtype == np.float32 and np.isfinite(got).all() and (got >= 0).all() and (got <= 1 + TOL).all()
    assert (got[~both] == 0.0).all()
    self_iou = ops.box3d_iou_matrix(t(b1), t(b1)).numpy()
    same = (b1[:, :, None] == b1[:, None, :]).all(axis=(-1, -2))
    both = solid1[:, :, None] & solid1[:, None, :]
    np.testing.assert_allclose(self_iou[~same & both], np.asarray(jax_iou(b1, b1))[~same & both], rtol=0, atol=TOL)
    assert (self_iou[same & both] == 1.0).all() and (self_iou[~both] == 0.0).all()
    if kind == "identical":
        assert same.sum() - same.shape[0] * same.shape[1] == 2 * 2 * 15  # the repeated pairs
    if kind == "degenerate":
        assert not solid1[:, 0::3].any() and not solid1[:, 1::3].any() and solid1[:, 2::3].all()


def volume(b):
    """|shoelace area of the top face| x height, in f64."""
    x, z, y = (b[..., :4, 0].astype(np.float64), b[..., :4, 2].astype(np.float64), b[..., :, 1].astype(np.float64))
    return 0.5 * np.abs(np.sum(x * np.roll(z, -1, -1) - np.roll(x, -1, -1) * z, -1)) * (y[..., 0] - y[..., 4])


def test_pairwise_matches_jax_and_shapely():
    from votenet_tpu.ops.iou3d import box3d_iou_pairwise as jax_pairwise

    rng = np.random.RandomState(5)
    b1, b2 = boxes("rotated", rng, (40,)), boxes("rotated", rng, (40,))
    b2[:20] = b1[:20] + rng.uniform(-0.3, 0.3, (20, 1, 3)).astype(np.float32)  # overlapping pairs
    got = ops.box3d_iou_pairwise(t(b1), t(b2)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_pairwise(b1, b2)), rtol=0, atol=TOL)
    want = np.array([oracles.shapely_iou3d(a, b) for a, b in zip(b1, b2)])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[:20] > 0).sum() >= 10


# --- the stated order, transcribed from csrc/iou3d.cu into numpy f32 -----------

def f32(x):
    return np.float32(x)


def kernel_box(c):
    """load_box: the quad, y top and bottom, the signed area and its sign."""
    x, z = c[..., :4, 0], c[..., :4, 2]
    tk = [x[..., k] * z[..., (k + 1) % 4] - x[..., (k + 1) % 4] * z[..., k] for k in range(4)]
    area = f32(0.5) * (((tk[0] + tk[1]) + tk[2]) + tk[3])
    return dict(x=x, z=z, yt=c[..., 0, 1], yb=c[..., 4, 1], area=area, sgn=np.sign(area).astype(np.float32))


def kernel_boundary(A, B, sb):
    eps = f32(1e-12)
    cr = []
    for i in range(4):
        ax, az = A["x"][..., i], A["z"][..., i]
        dx, dz = A["x"][..., (i + 1) % 4] - ax, A["z"][..., (i + 1) % 4] - az
        lo, hi, dead = [], [], np.zeros(ax.shape, bool)
        for j in range(4):
            qx, qz = B["x"][..., j], B["z"][..., j]
            ex, ez = B["x"][..., (j + 1) % 4] - qx, B["z"][..., (j + 1) % 4] - qz
            amx, amz = ax - qx, az - qz
            c0 = sb * (ex * amz - ez * amx)
            c1 = sb * (ex * dz - ez * dx)
            pos, neg = c1 > eps, c1 < -eps
            tt = -c0 / np.where(pos | neg, c1, f32(1))
            lo.append(np.where(pos, tt, f32(0)))
            hi.append(np.where(neg, tt, f32(1)))
            dead |= ~pos & ~neg & (c0 < -eps)
        lo_ = np.clip(np.maximum(np.maximum(np.maximum(lo[0], lo[1]), lo[2]), lo[3]), f32(0), f32(1))
        hi_ = np.clip(np.minimum(np.minimum(np.minimum(hi[0], hi[1]), hi[2]), hi[3]), f32(0), f32(1))
        x0, z0 = ax + lo_ * dx, az + lo_ * dz
        x1, z1 = ax + hi_ * dx, az + hi_ * dz
        cr.append(np.where((hi_ > lo_) & ~dead, x0 * z1 - x1 * z0, f32(0)))
    return ((cr[0] + cr[1]) + cr[2]) + cr[3]


def kernel_iou_matrix(c1, c2):
    """box_iou of every pair, as the kernel computes it."""
    P, Q = kernel_box(c1[:, :, None]), kernel_box(c2[:, None, :])
    P, Q = ({k: np.broadcast_to(v, np.broadcast_shapes(P["yt"].shape, Q["yt"].shape) + v.shape[3:])
             for k, v in box.items()} for box in (P, Q))
    bp, bq = kernel_boundary(P, Q, Q["sgn"]), kernel_boundary(Q, P, P["sgn"])
    area = f32(0.5) * (P["sgn"] * bp + Q["sgn"] * bq)
    inter = np.minimum(np.maximum(area, f32(0)), np.minimum(np.abs(P["area"]), np.abs(Q["area"])))
    y_overlap = np.maximum(np.minimum(P["yt"], Q["yt"]) - np.maximum(P["yb"], Q["yb"]), f32(0))
    inter_vol = inter * y_overlap
    denom = (np.abs(P["area"]) * (P["yt"] - P["yb"]) + np.abs(Q["area"]) * (Q["yt"] - Q["yb"])) - inter_vol
    ok = denom > f32(1e-12)
    return np.where(ok, inter_vol / np.where(ok, denom, f32(1)), f32(0)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_iou_equals_the_kernels_stated_order(kind):
    """The plain version is, float for float, the arithmetic csrc/iou3d.cu
    states (each operation one f32 rounding, the sums in the written order),
    transcribed here into numpy: the CPU's floats are the card's."""
    rng = np.random.RandomState(10 + KINDS.index(kind))
    b1, b2 = boxes(kind, rng, (2, 33)), boxes(kind, rng, (2, 21))
    with np.errstate(invalid="ignore"):
        want = kernel_iou_matrix(b1, b2)
    got = ops.box3d_iou_matrix(t(b1), t(b2)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_self_matrix_is_bit_symmetric(kind):
    """IoU(P, Q) and IoU(Q, P) are the same float, bit for bit: the two
    boundary sums swap places in one commutative addition, and min, max and
    vol1 + vol2 are symmetric. The kernel computes only the upper triangle
    of the self-matrix NMS asks for and writes each float to both halves;
    this is what makes that equal to the plain version's full matrix."""
    rng = np.random.RandomState(20 + KINDS.index(kind))
    b = t(boxes(kind, rng, (2, 256)))
    m = ops.box3d_iou_matrix(b, b)
    bits = m.numpy().view(np.int32)
    np.testing.assert_array_equal(bits, bits.transpose(0, 2, 1))
    assert int((m > 0).sum()) > 2 * 256  # overlapping pairs off the diagonal


def test_plain_matrix_blocks_change_no_float(monkeypatch):
    rng = np.random.RandomState(3)
    b1, b2 = t(boxes("rotated", rng, (3, 50))), t(boxes("rotated", rng, (3, 40)))
    whole = ops.box3d_iou_matrix(b1, b2)
    monkeypatch.setattr(iou3d, "_PLAIN_BLOCK_PAIRS", 7)  # blocks of one row, then of a few
    assert torch.equal(ops.box3d_iou_matrix(b1, b2), whole)
    assert torch.equal(ops.box3d_iou_matrix(b1[0], b2[0]), whole[0])  # no batch dimension
    assert ops.box3d_iou_matrix(b1[:, :0], b2).shape == (3, 0, 40)


def test_order_of_the_sums_is_stated():
    """_sum4 adds left to right: on terms where association matters,
    ((a + b) + c) + d, not a pairwise tree."""
    x = torch.tensor([[1.0, 1e-8, -1.0, 1e-8]])
    assert float(iou3d._sum4(x)) == float(np.float32(np.float32(np.float32(1.0) + np.float32(1e-8)) - 1.0)
                                          + np.float32(1e-8))
    assert float(iou3d._sum4(x)) != float((x[0, 0] + x[0, 2]) + (x[0, 1] + x[0, 3]))


# --- the cross-check formulations ----------------------------------------------

FORMS = ["convex_quad_intersection_area", "convex_quad_intersection_area_sh",
         "convex_quad_intersection_area_sort", "convex_quad_intersection_area_edgeclip"]


def quads(b):
    return np.stack([b[..., :4, 0], b[..., :4, 2]], axis=-1)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("kind", ["rotated", "axis"])
def test_formulation_matches_jax_and_shapely(form, kind):
    """Each formulation against JAX's of the same name within 1e-5 and, pair
    by pair, the shapely oracle's intersection area; rotated boxes also
    against the port's edge-clip form (``tests/test_pallas.py:47-60`` for
    JAX). Axis-aligned boxes on a grid share edge lines: there edge-clip,
    in either package, counts an overlap of two collinear edges twice, once
    from each quad's boundary (0.21875 for 0.125), and is held to JAX's
    edge-clip only; the three others agree with the oracle."""
    import votenet_tpu.ops.iou3d as jax_iou3d

    rng = np.random.RandomState(FORMS.index(form))
    b1, b2 = boxes(kind, rng, (64,)), boxes(kind, rng, (64,))
    b2[:32] = b1[:32] + rng.uniform(-0.4, 0.4, (32, 1, 3)).astype(np.float32)
    q1, q2 = quads(b1), quads(b2)
    got = getattr(iou3d, form)(t(q1), t(q2)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jax_iou3d, form)(q1, q2)), rtol=1e-4, atol=TOL)
    area = np.array([abs(oracles._clip_area(a.astype(np.float64), b.astype(np.float64))) for a, b in zip(q1, q2)])
    if kind == "rotated":
        edge = iou3d.convex_quad_intersection_area_edgeclip(t(q1), t(q2)).numpy()
        np.testing.assert_allclose(got, edge, rtol=1e-4, atol=TOL)
    if kind == "rotated" or form != "convex_quad_intersection_area_edgeclip":
        np.testing.assert_allclose(got, area, rtol=1e-4, atol=TOL)
    else:
        assert (np.abs(got - area) > 1e-3).any()  # the collinear double count, as JAX's
    assert (got > 0).sum() >= 16


@pytest.mark.parametrize("form", FORMS)
def test_formulation_containment_and_disjoint(form):
    fn = getattr(iou3d, form)
    big = torch.tensor([[-2.0, -2], [2, -2], [2, 2], [-2, 2]])
    small = torch.tensor([[-1.0, -1], [1, -1], [1, 1], [-1, 1]])
    far = small + 10.0
    assert float(fn(small, big)) == pytest.approx(4.0, rel=1e-6)
    assert float(fn(big.flip(0), small)) == pytest.approx(4.0, rel=1e-6)  # clockwise
    assert float(fn(small, far)) == 0.0
    assert fn(torch.stack([small, big]), big).shape == (2,)
