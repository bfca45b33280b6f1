"""NMS of the port against the JAX package's ``nms3d``, on the CPU.

The port's NMS runs the greedy kernel of ``csrc/nms3d.cu`` on a CUDA tensor
and the Jacobi fixpoint on a CPU tensor. Here both plain versions, the
fixpoint (``ops.nms3d`` on the CPU) and the kernel's twin
(``nms3d_greedy_plain``, the kernel's walk in PyTorch), are held bit-equal
to JAX's keep mask (``JAX_PLATFORMS=cpu``, its compaction tiers included),
on boxes made with numpy from a seed: long suppression chains, tied scores,
no candidate at all, and candidate counts on both sides of each JAX tier
(64 and 160 of 256). The kernel itself against both is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tests import oracles
from votenet_tpu_torch import ops
from votenet_tpu_torch.models.decode import get_3d_bbox
from votenet_tpu_torch.ops.cuda.nms3d import NMS_MAX_BOXES, nms3d_greedy_cuda, nms3d_greedy_plain
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


def case(kind, rng):
    """(corners (B, N, 8, 3), scores (B, N), objectness (B, N, 2))."""
    B, N = 2, 256
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
    A row above NMS_MAX_BOXES raises ValueError naming the limit, before
    anything is built or launched; a CPU tensor raises RuntimeError. The CPU
    route of ops.nms3d launches no kernel."""
    iou = torch.zeros((1, 8, 8))
    order = torch.arange(8)[None]
    cand = torch.ones((1, 8), dtype=torch.bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        nms3d_greedy_cuda(iou, order, cand, THR)
    n = NMS_MAX_BOXES + 1
    with pytest.raises(ValueError, match=str(NMS_MAX_BOXES)):
        nms3d_greedy_cuda(torch.zeros((1, n, n)), torch.arange(n)[None], torch.ones((1, n), dtype=torch.bool), THR)
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
