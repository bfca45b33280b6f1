"""NMS of the port against the JAX package's ``nms3d``, on the CPU.

The port's NMS runs the greedy kernel of ``csrc/nms3d.cu`` on a CUDA tensor
and the Jacobi fixpoint on a CPU tensor. Here both plain versions, the
fixpoint (``ops.nms3d`` on the CPU) and the kernel's twin
(``nms3d_greedy_plain``, the kernel's walk in PyTorch), are held bit-equal
to JAX's keep mask (``JAX_PLATFORMS=cpu``, its compaction tiers included),
on boxes made with numpy from a seed: long suppression chains, tied scores,
no candidate at all, and candidate counts on both sides of each JAX tier
(64 and 160 of 256, and of 1056: past the kernel's shared-memory route).
The kernel itself against both is in ``tests/test_torch_cuda.py``; here
numpy transcriptions of its design (the rank rule of its order, the walk in
chunks of 32 over the compacted candidates) are held to torch.argsort and
the fixpoint.
"""

import numpy as np
import pytest
import torch

from tests import oracles
from tests.test_torch_checkpoint import few_torch_threads  # noqa: F401  (autouse: several torch files share the cores)
from votenet_tpu_torch import ops
from votenet_tpu_torch.models.decode import get_3d_bbox
from votenet_tpu_torch.ops.cuda.nms3d import NMS_SMEM_BOXES, nms3d_greedy_cuda, nms3d_greedy_plain
from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

THR = 0.25


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def chain_boxes(B, N, rng):
    """Unit cubes along x, 0.5 apart: each overlaps its neighbours at IoU
    1/3 (> THR) and no other box, so a greedy down a descending-score chain
    keeps every other box, and the fixpoint needs N rounds."""
    center = np.zeros((B, N, 3), np.float32)
    center[..., 0] = 0.5 * np.arange(N, dtype=np.float32)
    size = np.ones((B, N, 3), np.float32)
    heading = np.zeros((B, N), np.float32)
    corners = get_3d_bbox(t(size), t(heading), t(center)).numpy()
    scores = np.broadcast_to(-np.arange(N, dtype=np.float32), (B, N)).copy()
    scores[1] = scores[1, ::-1]  # the second row walks the chain from its far end
    return corners, scores


def case(kind, rng, N=256):
    """(corners (B, N, 8, 3), scores (B, N), objectness (B, N, 2))."""
    B = 2
    if kind == "chain":
        corners, scores = chain_boxes(B, N, rng)
        obj = np.stack([np.zeros((B, N)), np.ones((B, N))], -1).astype(np.float32)
        return corners, scores, obj
    corners = oracles.random_boxes(rng, (B, N))
    if kind == "ties":  # four score values over 256 boxes: the lower index wins each tie
        scores = rng.randint(0, 4, (B, N)).astype(np.float32)
    else:
        scores = rng.randn(B, N).astype(np.float32)
    obj = np.zeros((B, N, 2), np.float32)
    n_cand = {"ties": 200, "none": 0}.get(kind, kind)
    for b in range(B):
        obj[b, rng.permutation(N)[: max(n_cand - b, 0)], 1] = 1.0  # the rows' counts differ by one
    if kind != "none":
        obj[0, :, 1] = np.where(obj[0, :, 1] > 0, rng.uniform(1e-3, 1.0, N), -rng.uniform(0, 1.0, N))
    return corners, scores, obj


KINDS = ["chain", "ties", "none", 1, 64, 65, 150, 160, 161, 256]


@pytest.mark.parametrize("kind", KINDS, ids=str)
def test_keep_masks_match_jax(kind):
    """Both plain versions and JAX's nms3d give one keep mask, bit for bit.
    The counts straddle JAX's tiers: at most 64 (the 64 tier), 65-160 (the
    160 tier), above 160 (dense); each row's count is one below the
    previous, so a batch can straddle a tier too."""
    from votenet_tpu.ops.nms3d import nms3d as jax_nms

    rng = np.random.RandomState(11 + KINDS.index(kind))
    corners, scores, obj = case(kind, rng)
    want = np.asarray(jax_nms(corners, scores, obj, THR))

    keep = ops.nms3d(t(corners), t(scores), t(obj), THR)
    assert keep.dtype == torch.bool
    np.testing.assert_array_equal(keep.numpy(), want)

    cand = t(obj[..., 1] > obj[..., 0])
    iou = ops.box3d_iou_matrix(t(corners), t(corners))
    order = torch.argsort(t(scores), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(nms3d_greedy_plain(iou, order, cand, THR).numpy(), want)
    np.testing.assert_array_equal(keep.numpy(), oracles.nms3d_oracle(corners, scores, obj, THR))
    n_cand = int(cand.sum())
    if kind == "none":
        assert n_cand == 0 and not want.any()
    elif kind == "chain":  # every other box down each chain
        assert want[0].tolist() == [i % 2 == 0 for i in range(256)]
        assert want[1].tolist() == [i % 2 == 1 for i in range(256)]
    elif n_cand > 4:
        assert 0 < want.sum() < n_cand  # some kept, some suppressed


@pytest.mark.parametrize("seed", range(6))
def test_kernel_twin_matches_the_fixpoint_on_random_relations(seed):
    """On random IoU matrices (not from boxes: any relation, dense ties in
    score, N not a multiple of 32, thresholds between the IoU values) the
    kernel's walk and the fixpoint agree."""
    rng = np.random.RandomState(seed)
    B, N = 3, [1, 31, 33, 100, 256, 300][seed]
    iou = t(rng.rand(B, N, N).astype(np.float32))
    scores = t(rng.randint(0, 1 + seed, (B, N)).astype(np.float32))
    order = torch.argsort(scores, dim=1, descending=True, stable=True)
    cand = t(rng.rand(B, N) < 0.2 * (seed + 1))
    thr = float(np.float32(rng.uniform(0.5, 0.99)))
    np.testing.assert_array_equal(nms3d_greedy_plain(iou, order, cand, thr).numpy(),
                                  nms3d_jacobi_plain(iou, order, cand, thr).numpy())


def test_greedy_kernel_refuses_cpu_tensors_and_long_rows():
    """No fallback: the kernel's wrapper never computes the plain version.
    A CPU tensor raises RuntimeError, a long row (past NMS_SMEM_BOXES, which
    the kernel takes through its workspace route) as a short one does,
    before anything is built or launched. The CPU route of ops.nms3d
    launches no kernel."""
    iou = torch.zeros((1, 8, 8))
    scores = torch.arange(8.0)[None]
    obj = torch.zeros((1, 8, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        nms3d_greedy_cuda(iou, scores, obj, THR)
    n = NMS_SMEM_BOXES + 1
    with pytest.raises(RuntimeError, match="CUDA"):
        nms3d_greedy_cuda(torch.zeros((1, n, n)), torch.zeros((1, n)), torch.zeros((1, n, 2)), THR)
    before = nms3d_greedy_cuda.launches
    rng = np.random.RandomState(3)
    corners = oracles.random_boxes(rng, (1, 40))
    ops.nms3d(t(corners), t(rng.randn(1, 40).astype(np.float32)), t(rng.randn(1, 40, 2).astype(np.float32)), THR)
    assert nms3d_greedy_cuda.launches == before == 0


def test_threshold_is_compared_in_f32():
    """The kernel receives the threshold rounded to f32, as PyTorch's
    comparison of an f32 tensor with a Python float rounds it: an IoU equal
    to f32(thr) is not above it on either route."""
    thr = 0.1  # not exact in binary
    iou = torch.full((1, 2, 2), float(np.float32(thr)))
    order = torch.arange(2)[None]
    cand = torch.ones((1, 2), dtype=torch.bool)
    assert nms3d_greedy_plain(iou, order, cand, thr).tolist() == [[True, True]]
    assert nms3d_jacobi_plain(iou, order, cand, thr).tolist() == [[True, True]]
    iou = torch.full((1, 2, 2), float(np.nextafter(np.float32(thr), np.float32(1))))  # one f32 ulp above
    assert nms3d_greedy_plain(iou, order, cand, thr).tolist() == [[True, False]]
    assert nms3d_jacobi_plain(iou, order, cand, thr).tolist() == [[True, False]]


LONG_COUNTS = [64, 65, 160, 161, 1056]


@pytest.mark.parametrize("n_cand", LONG_COUNTS)
def test_keep_masks_match_jax_past_the_shared_memory_rows(n_cand):
    """N = 1056 boxes a row (33 bit words, past the kernel's one-launch
    route): the CPU route, the kernel's walk and JAX's nms3d give one keep
    mask, with candidate counts around JAX's compaction tiers (64, 160) and
    every box a candidate (its dense tier)."""
    from votenet_tpu.ops.nms3d import nms3d as jax_nms

    N = 1056
    rng = np.random.RandomState(100 + LONG_COUNTS.index(n_cand))
    corners, scores, obj = case(n_cand, rng, N)
    corners[..., [0, 2]] *= 2.5  # a larger room keeps overlaps as frequent as at 256 boxes
    want = np.asarray(jax_nms(corners, scores, obj, THR))
    keep = ops.nms3d(t(corners), t(scores), t(obj), THR)
    np.testing.assert_array_equal(keep.numpy(), want)
    cand = t(obj[..., 1] > obj[..., 0])
    iou = ops.box3d_iou_matrix(t(corners), t(corners))
    order = torch.argsort(t(scores), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(nms3d_greedy_plain(iou, order, cand, THR).numpy(), want)
    assert 0 < want.sum() < int(cand.sum())


def test_walk_matches_the_fixpoint_at_2048_boxes():
    """The kernel's walk and the fixpoint on a numpy-made IoU relation of
    2048 boxes a row (64 bit words), scores tied in 30 values."""
    rng = np.random.RandomState(2048)
    B, N = 2, 2048
    iou = t(rng.rand(B, N, N).astype(np.float32))
    order = torch.argsort(t(rng.randint(0, 30, (B, N)).astype(np.float32)), dim=1, descending=True, stable=True)
    cand = t(rng.rand(B, N) < 0.5)
    walk = nms3d_greedy_plain(iou, order, cand, 0.995)
    np.testing.assert_array_equal(walk.numpy(), nms3d_jacobi_plain(iou, order, cand, 0.995).numpy())
    assert 0 < int(walk.sum()) < int(cand.sum())


# ----------------------------------------------- the greedy kernel's design
# numpy transcriptions of csrc/nms3d.cu: the rank rule of its order and its
# walk in chunks of 32 positions, held to torch.argsort and the fixpoint

def np_order_keys(scores):
    """The kernel's 64-bit keys, (B, N) f32 -> (B, N) uint64: the score's
    order-preserving bits (every NaN at the top, -0 as +0) above the
    complemented index, so that j comes before i iff key[j] > key[i]."""
    s = np.asarray(scores, np.float32)
    u = np.where(s == 0, np.uint32(0), s.view(np.uint32))
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    u = np.where(np.isnan(s), np.uint32(0xFFFFFFFF), u).astype(np.uint64)
    idx = np.arange(s.shape[-1], dtype=np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)


def np_order(scores):
    """The kernel's order: rank[i] = the keys above key[i]; ord[rank] = i."""
    key = np_order_keys(scores)
    rank = (key[:, None, :] > key[:, :, None]).sum(-1)
    order = np.empty_like(rank)
    np.put_along_axis(order, rank, np.arange(key.shape[-1])[None].repeat(len(key), 0), axis=1)
    return order


def np_chunked_walk(iou, scores, cand, thr):
    """The kernel's greedy: the candidates compacted in box order, their
    order by the rank rule, bit rows by candidate position (row p, bit q
    for q > p), then the walk in chunks of 32 positions: the chunk's
    unblocked positions resolved against its diagonal block one at a time,
    the kept rows ORed into the later words of `blocked`; a box that is no
    candidate is not kept."""
    B, N = cand.shape
    thr = np.float32(thr)
    keep = np.zeros((B, N), bool)
    for b in range(B):
        boxes = np.nonzero(cand[b])[0]  # compaction: the candidates by index
        Nc = len(boxes)
        if Nc == 0:
            continue
        o = boxes[np_order(scores[b:b + 1, boxes])[0]]  # ord[p]: the box at candidate position p
        Wc = -(-Nc // 32)
        q = np.arange(Nc)
        rows = np.zeros((32 * Wc, 32 * Wc), bool)
        rows[:Nc, :Nc] = (iou[b][np.ix_(o, o)] > thr) & (q[None, :] > q[:, None])
        blocked = np.zeros(32 * Wc, bool)
        for c in range(Wc):
            sl = slice(32 * c, 32 * c + 32)
            alive = (np.arange(32 * c, 32 * c + 32) < Nc) & ~blocked[sl]
            diag = rows[sl, sl]
            for k in range(32):
                if alive[k]:
                    alive &= ~diag[k]
            kept_pos = 32 * c + np.nonzero(alive)[0]
            keep[b, o[kept_pos]] = True
            blocked[32 * (c + 1):] |= rows[kept_pos][:, 32 * (c + 1):].any(0)
    return keep


RANK_CASES = ["ties", "nan", "inf", "zeros", "random"]


@pytest.mark.parametrize("kind", RANK_CASES)
def test_kernel_rank_rule_matches_torch_argsort(kind):
    """The in-CTA rank rule gives torch.argsort(descending=True,
    stable=True)'s permutation on the CPU: ties by index, every NaN (either
    sign) first and by index, +-inf, -0 equal to +0."""
    rng = np.random.RandomState(RANK_CASES.index(kind))
    N = 300
    s = rng.randint(-3, 4, (3, N)).astype(np.float32)
    if kind == "nan":
        s[:, ::7] = np.nan
        s[1, ::11] = -np.nan
    elif kind == "inf":
        s[:, ::5] = np.inf
        s[:, 2::5] = -np.inf
        s[2, ::13] = np.nan
    elif kind == "zeros":
        s[:, ::3] = 0.0
        s[:, 1::3] = -0.0
    elif kind == "random":
        s = rng.randn(3, N).astype(np.float32)
    want = torch.argsort(t(s), dim=1, descending=True, stable=True).numpy()
    np.testing.assert_array_equal(np_order(s), want)


WALK_NS = [1, 31, 32, 33, 256, 1024, 1025]


@pytest.mark.parametrize("cands", ["none", "all", "random"])
@pytest.mark.parametrize("N", WALK_NS)
def test_chunked_walk_matches_the_fixpoint(N, cands):
    """The kernel's chunked walk over its candidates in its own order equals
    the Jacobi fixpoint over torch.argsort's order of all boxes: no
    candidates, all candidates and a random half, random suppression
    (scores tied in few values, some NaN)."""
    rng = np.random.RandomState(N + len(cands))
    B = 2
    iou = rng.rand(B, N, N).astype(np.float32)
    scores = rng.randint(0, 5, (B, N)).astype(np.float32)
    scores[:, ::9] = np.nan
    cand = {"none": np.zeros((B, N), bool), "all": np.ones((B, N), bool),
            "random": rng.rand(B, N) < 0.5}[cands]
    thr = float(np.float32(1.0 - 3.0 / max(N, 4)))  # a few suppressions a box
    order = torch.argsort(t(scores), dim=1, descending=True, stable=True)
    want = nms3d_jacobi_plain(t(iou), order, t(cand), thr).numpy()
    np.testing.assert_array_equal(np_chunked_walk(iou, scores, cand, thr), want)
    if cands == "none":
        assert not want.any()
    elif N > 32:
        assert 0 < want.sum() < cand.sum()
