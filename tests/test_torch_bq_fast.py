"""The fast_bf16 ball query of the port (``Config.bq_precision="fast_bf16"``),
on the CPU.

The mode's hit test is the JAX package's matmul expansion
``(a2 + b2) - 2 * ab`` (``votenet_tpu/ops/common.py:60-76``) with the TPU's
semantics, which the port follows: the cross term over coordinates rounded
to bf16, each product exact in f32, the norms in f32 from the unrounded
coordinates, no step fused. JAX's XLA twin on the CPU runs the same
expansion with an f32 cross term instead. So here:

- the port's plain version is bit-equal to a numpy oracle of the TPU
  semantics (:func:`fast_oracle`), at the five main-path radii on clustered
  (synthetic scene) clouds, on a lattice, and on both routes' inputs;
- the same oracle without the rounding is bit-equal to JAX's CPU twin,
  which shows that the rounding is the one difference; the slots and
  counts the rounding flips are printed (``-s``);
- the point-sharded query under the mode equals the single-device query at
  2 ranks, whether the mode is named or read from ``ops.dispatch``.

The kernel against the plain version is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.config import default_config, tiny_config
from votenet_tpu_torch.data.synthetic import synthetic_scene
from votenet_tpu_torch.ops import dispatch
from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain
from votenet_tpu_torch.parallel.launch import run_ranks

F32 = np.float32
CFG = default_config()
# the five (radius, nsample) of a full-width forward: sa1-sa4, proposal
MAIN_PATH = list(zip(CFG.sa_radii, CFG.sa_nsamples)) + [(CFG.proposal_radius, CFG.proposal_nsample)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 -> nearest bf16 (ties to even), as f32; finite inputs."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def sqdist_mm(a: np.ndarray, b: np.ndarray, rounded: bool) -> np.ndarray:
    """(a2 + b2) - 2 * ab in numpy f32, one rounding a step; ``rounded``: the
    cross term over bf16-rounded coordinates (the TPU's), else f32."""
    a, b = a.astype(F32), b.astype(F32)
    a2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]
    b2 = (b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1]) + b[..., 2] * b[..., 2]
    if rounded:
        a, b = round_bf16(a), round_bf16(b)
    ar, br = a[..., :, None, :], b[..., None, :, :]
    ab = (ar[..., 0] * br[..., 0] + ar[..., 1] * br[..., 1]) + ar[..., 2] * br[..., 2]
    return (a2[..., :, None] + b2[..., None, :]) - F32(2) * ab


def first_k(hit: np.ndarray, nsample: int):
    """The reference selection of a hit mask (B, M, N): the first nsample
    hits in index order, padded with the first hit, 0 for an empty ball."""
    B, M, _ = hit.shape
    idx = np.zeros((B, M, nsample), np.int32)
    cnt = np.zeros((B, M), np.int32)
    for b in range(B):
        for m in range(M):
            h = np.nonzero(hit[b, m])[0]
            c = min(len(h), nsample)
            cnt[b, m] = c
            if c:
                idx[b, m, :c] = h[:c]
                idx[b, m, c:] = h[0]
    return idx, cnt


def fast_oracle(radius, nsample, xyz1, xyz2, rounded=True):
    """The fast_bf16 query in numpy: the TPU semantics (``rounded``) or the
    CPU twin's f32 cross term."""
    r2 = F32(radius) * F32(radius)
    return first_k(sqdist_mm(xyz2, xyz1, rounded) < r2, nsample)


def clouds(seed, B=2, N=2048, M=256):
    """Clustered clouds (synthetic scenes at room scale) and M queries from
    each (a stride of its points, as FPS centres are points of the cloud)."""
    rng = np.random.RandomState(seed)
    cfg = tiny_config(point_num=N)
    xyz = np.stack([synthetic_scene(rng, cfg)["points"] for _ in range(B)]).astype(F32)
    return xyz, xyz[:, :: N // M].copy()


@pytest.mark.parametrize("radius,nsample", MAIN_PATH, ids=[f"r{r}" for r, _ in MAIN_PATH])
def test_plain_matches_the_tpu_oracle_and_differs_from_jax_cpu_by_the_rounding(radius, nsample):
    from votenet_tpu.ops.grouping import _query_ball_point_dense

    xyz, q = clouds(int(radius * 10))
    idx, cnt = query_ball_point_plain(radius, nsample, t(xyz), t(q), "fast_bf16")
    want = fast_oracle(radius, nsample, xyz, q)
    np.testing.assert_array_equal(idx.numpy(), want[0])
    np.testing.assert_array_equal(cnt.numpy(), want[1])
    assert ops.query_ball_point(radius, nsample, t(xyz), t(q), "fast_bf16")[0].numpy().tolist() == want[0].tolist()

    jax_idx, jax_cnt = (np.asarray(a) for a in _query_ball_point_dense(radius, nsample, "fast_bf16", xyz, q))
    cpu_twin = fast_oracle(radius, nsample, xyz, q, rounded=False)
    np.testing.assert_array_equal(jax_idx, cpu_twin[0])  # the CPU twin's f32 cross term, bit for bit
    np.testing.assert_array_equal(jax_cnt, cpu_twin[1])
    exact = query_ball_point_plain(radius, nsample, t(xyz), t(q), "exact")
    flips = {
        "vs JAX CPU twin": (int((jax_idx != want[0]).sum()), int((jax_cnt != want[1]).sum())),
        "vs exact": (int((exact[0].numpy() != want[0]).sum()), int((exact[1].numpy() != want[1]).sum())),
    }
    print(f"r={radius} nsample={nsample}: slots / counts that differ from the port's fast_bf16, "
          f"of {want[0].size} / {want[1].size}: {flips}")
    assert flips["vs JAX CPU twin"][0] > 0  # the rounding moves hits at room scale


def test_plain_matches_the_oracle_on_a_lattice_and_at_ties():
    """Integer coordinates (exact in bf16: the rounding changes nothing, so
    the mode's hits are the f32 expansion's) and a radius whose square lies
    on lattice distances."""
    rng = np.random.RandomState(5)
    g = np.stack(np.meshgrid(np.arange(12), np.arange(12), np.arange(6), indexing="ij"), -1).reshape(-1, 3)
    xyz = np.stack([g[rng.permutation(len(g))][:600] for _ in range(2)]).astype(F32) * F32(0.25)
    q = xyz[:, :50].copy()
    for radius, nsample in ((0.5, 16), (0.25, 8), (1.0, 64)):
        got = query_ball_point_plain(radius, nsample, t(xyz), t(q), "fast_bf16")
        want = fast_oracle(radius, nsample, xyz, q)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(want[0], fast_oracle(radius, nsample, xyz, q, rounded=False)[0])


def test_mode_is_read_at_every_call_and_checked():
    """``query_ball_point`` without a mode reads ``ops.dispatch.bq_precision()``
    at the call; a bad mode raises the JAX package's ValueError; the CPU
    route launches no kernel."""
    xyz, q = clouds(1, B=1, N=1024, M=64)
    exact = ops.query_ball_point(0.2, 32, t(xyz), t(q))
    fast = ops.query_ball_point(0.2, 32, t(xyz), t(q), "fast_bf16")
    assert not torch.equal(exact[0], fast[0])
    assert dispatch.bq_precision() == "exact"
    try:
        dispatch.set_bq_precision("fast_bf16")
        assert torch.equal(ops.query_ball_point(0.2, 32, t(xyz), t(q))[0], fast[0])
    finally:
        dispatch.set_bq_precision("exact")
    assert torch.equal(ops.query_ball_point(0.2, 32, t(xyz), t(q))[0], exact[0])
    with pytest.raises(ValueError, match="bq_precision must be 'exact' or 'fast_bf16', got 'fast'"):
        dispatch.set_bq_precision("fast")
    with pytest.raises(ValueError, match="bq_precision"):
        ops.query_ball_point(0.2, 32, t(xyz), t(q), "bf16")
    assert query_ball_point_cuda.launches == query_ball_point_cuda.fast_bf16.launches == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        query_ball_point_cuda(0.2, 32, t(xyz), t(q), mode="fast_bf16")


def sharded_rank(rank, world, xyz, q):
    """A rank's sharded fast_bf16 query: the mode named, then read from the
    dispatch."""
    from votenet_tpu_torch.parallel import make_mesh, point_sharding, query_ball_point_sharded

    group = make_mesh(("points",)).group("points")
    slab = point_sharding(t(xyz), group)
    named = query_ball_point_sharded(0.2, 64, slab, t(q), group, "fast_bf16")
    dispatch.set_bq_precision("fast_bf16")
    read = query_ball_point_sharded(0.2, 64, slab, t(q), group)
    return [x.numpy() for x in named + read]


def test_sharded_query_under_the_mode_matches_single_device():
    xyz, q = clouds(7, B=2, N=2048, M=128)
    want = [x.numpy() for x in ops.query_ball_point(0.2, 64, t(xyz), t(q), "fast_bf16")]
    exact = ops.query_ball_point(0.2, 64, t(xyz), t(q), "exact")[0].numpy()
    assert (exact != want[0]).any()
    for got in run_ranks(sharded_rank, 2, args=(xyz, q), timeout=180):
        for a, b in zip(got, want + want):
            np.testing.assert_array_equal(a, b)
