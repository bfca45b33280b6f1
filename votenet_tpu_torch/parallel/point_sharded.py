"""Point-axis sharding, the model's sequence-parallel (SP) analogue (port of
votenet_tpu/parallel/point_sharded.py).

Each rank of a ``points`` group holds one slab of a scene's cloud: the
``index(group)``-th of ``size(group)`` equal slabs of the point axis
(:func:`~votenet_tpu_torch.parallel.mesh.point_sharding`). The O(N) working
sets (FPS's running minimum, the ball query's tests, the gather's source
table) stay on the slab's rank; queries and outputs, all O(M), come out
replicated on every rank of the group. Each op takes the group where the
JAX op takes ``mesh, axis, batch_axis``: a rank's tensors are its own rows
already, so no op names the batch axis.

Every integer output is bit-equal to the single-device op's, and the floats
are equal:

- ball query: each rank queries its slab (the CUDA kernel on the card);
  the slabs' first-k results merge in ascending index order
  (:func:`~votenet_tpu_torch.ops.grouping.merge_first_k`), then are padded
  (``finalize_first_k``): the first ``nsample`` hits in index order.
- three_nn: each slab's 3 nearest merge by (distance, global index), the
  dense op's lowest-index tie rule.
- FPS: each step's global argmax is the slabs' argmax (lowest local index
  on ties), then the argmax over the ranks' maxima (lowest rank on ties):
  the dense rule's lowest global index. Distances come from the same f32
  values in the same order, so the running minimum is the dense one's.
- group_point: each rank gathers the indices in its slab and zero-fills the
  rest; a sum over the group (:func:`~.comm.psum_replicated`) assembles the
  gather, since one rank owns each index. Its backward scatters the
  cotangent into the rank's slab through ``ops.scatter_add`` (the scatter
  kernel on the card), with no collective.
"""

from __future__ import annotations

from typing import Optional

import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.ops.grouping import finalize_first_k, merge_first_k
from votenet_tpu_torch.parallel import comm
from votenet_tpu_torch.parallel.mesh import point_sharding

__all__ = [
    "point_sharding", "query_ball_point_sharded", "three_nn_sharded", "group_point_sharded",
    "gather_point_sharded", "sample_and_group_sharded", "farthest_point_sample_sharded",
]


def query_ball_point_sharded(radius: float, nsample: int, xyz1: torch.Tensor, xyz2: torch.Tensor,
                             group: comm.Group, mode: str | None = None):
    """Ball query over a sharded cloud: xyz1 (B, N/size, 3) this rank's slab,
    xyz2 (B, M, 3) the queries (the same on every rank) -> idx (B, M,
    nsample) int32 global indices and cnt (B, M) int32, replicated; equal to
    ``ops.query_ball_point`` over the whole cloud in ``mode`` ("exact" or
    "fast_bf16"; None reads ``ops.dispatch.bq_precision()`` at this call, as
    the JAX op does, ``votenet_tpu/parallel/point_sharded.py:94-102``). The
    hit test is per (query, point) pair in either mode, so the slabs' hits
    are the whole cloud's."""
    n_l = xyz1.shape[1]
    bidx, bcnt = ops.query_ball_point(radius, nsample, xyz1, xyz2, mode)
    part = torch.cat([bidx + comm.index(group) * n_l, bcnt[..., None]], dim=-1)
    parts = comm.all_gather(part, group)  # (size, B, M, nsample + 1), in index order
    idx = torch.zeros_like(bidx)
    cnt = torch.zeros_like(bcnt)
    for p in parts:
        idx, cnt = merge_first_k(idx, cnt, p[..., :nsample], p[..., nsample], nsample)
    return finalize_first_k(idx, cnt, nsample)


def three_nn_sharded(xyz1: torch.Tensor, xyz2: torch.Tensor, group: comm.Group):
    """3-NN over sharded sources: xyz1 (B, N, 3) the queries, xyz2
    (B, M/size, 3) this rank's slab of the sources (3 or more) -> (dist2,
    idx), each (B, N, 3), replicated; equal to ``ops.three_nn``."""
    m_l = xyz2.shape[1]
    if m_l < 3:
        raise ValueError(f"need >= 3 sources per shard, got {m_l}")
    d2, idx = ops.three_nn(xyz1, xyz2)
    idx = idx + comm.index(group) * m_l
    all_d = comm.all_gather(d2, group)  # (size, B, N, 3)
    all_i = comm.all_gather(idx, group)
    B, N = xyz1.shape[0], xyz1.shape[1]
    # rank-major, rank-minor candidates: among equal distances, position
    # order is global index order, and argmin takes the first
    d = all_d.permute(1, 2, 0, 3).reshape(B, N, -1).clone()
    ci = all_i.permute(1, 2, 0, 3).reshape(B, N, -1)
    dists, idxs = [], []
    for _ in range(3):
        p = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.gather(d, -1, p))
        idxs.append(torch.gather(ci, -1, p))
        d = d.scatter(-1, p, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1)


def group_point_sharded(points: torch.Tensor, idx: torch.Tensor, group: comm.Group,
                        grad_skip_prefix: int = 0, scatter: str = "exact") -> torch.Tensor:
    """Grouped gather from a sharded table: points (B, N/size, C) this rank's
    slab, idx (B, M, S) global indices -> (B, M, S, C), replicated; equal to
    ``ops.group_point`` over the whole table. Differentiable with respect to
    ``points``: the backward is ``ops.group_point``'s scatter into this
    rank's slab (``grad_skip_prefix`` and ``scatter`` as there)."""
    n_l = points.shape[1]
    local = idx.long() - comm.index(group) * n_l
    in_range = (local >= 0) & (local < n_l)
    g = ops.group_point(points, local.clamp(0, n_l - 1).to(torch.int32), grad_skip_prefix, scatter)
    g = torch.where(in_range[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    return comm.psum_replicated(g, group)


def gather_point_sharded(points: torch.Tensor, idx: torch.Tensor, group: comm.Group) -> torch.Tensor:
    """(B, N/size, C) slab, (B, M) global indices -> (B, M, C), replicated;
    the (B, M)-indexed :func:`group_point_sharded`. Differentiable."""
    return group_point_sharded(points, idx[:, :, None], group)[:, :, 0, :]


def farthest_point_sample_sharded(npoint: int, xyz: torch.Tensor, group: comm.Group) -> torch.Tensor:
    """FPS over a sharded cloud: xyz (B, N/size, 3) this rank's slab ->
    (B, npoint) int32 global indices, replicated; equal to
    ``ops.farthest_point_sample`` (seed index 0, lowest global index on
    ties). A plain PyTorch loop of ``npoint`` steps, one exchange a step:
    each rank's (max, x, y, z, index) candidate, gathered bit for bit."""
    x_l = xyz.detach().float()
    B, n_l, _ = x_l.shape
    base = comm.index(group) * n_l
    x, y, z = x_l.unbind(-1)
    rows = torch.arange(B, device=x_l.device)
    center = comm.all_gather(x_l[:, 0, :], group)[0]  # global point 0: rank 0's first
    mindist = torch.full((B, n_l), 1e38, dtype=torch.float32, device=x_l.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=x_l.device)
    for i in range(1, npoint):
        dx = x - center[:, 0:1]
        dy = y - center[:, 1:2]
        dz = z - center[:, 2:3]
        mindist = torch.minimum(mindist, dx * dx + dy * dy + dz * dz)
        loc = torch.argmax(mindist, dim=-1)  # first maximal index on ties
        gidx = (loc + base).to(torch.int32).view(torch.float32)  # the index's bits ride along
        cand = torch.cat([mindist[rows, loc][:, None], x_l[rows, loc], gidx[:, None]], dim=-1)
        cands = comm.all_gather(cand, group)  # (size, B, 5)
        win = torch.argmax(cands[..., 0], dim=0)  # lowest rank on ties
        pick = cands[win, rows]  # (B, 5)
        center = pick[:, 1:4]
        idxs[:, i] = pick[:, 4].view(torch.int32)
    return idxs


def sample_and_group_sharded(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                             points: Optional[torch.Tensor], group: comm.Group, use_xyz: bool = True,
                             mode: str | None = None):
    """The SA layer's grouping stage over a sharded cloud: FPS, gather, ball
    query, group, centre-subtract (the JAX ``sample_and_group``, reference
    utils.py:25-61). xyz (B, N/size, 3) and points (B, N/size, C) this rank's
    slabs -> (new_xyz (B, npoint, 3), new_points (B, npoint, nsample, 3 + C
    or C or 3), idx (B, npoint, nsample) int32, grouped_xyz (B, npoint,
    nsample, 3) centred), all replicated. ``mode`` is the ball query's."""
    new_xyz = gather_point_sharded(xyz, farthest_point_sample_sharded(npoint, xyz, group), group)
    idx, _ = query_ball_point_sharded(radius, nsample, xyz, new_xyz, group, mode)
    if points is None:
        grouped_xyz = group_point_sharded(xyz, idx, group) - new_xyz[:, :, None, :]
        return new_xyz, grouped_xyz, idx, grouped_xyz
    both = group_point_sharded(torch.cat([xyz, points], dim=-1), idx, group)
    grouped_xyz = both[..., :3] - new_xyz[:, :, None, :]
    new_points = torch.cat([grouped_xyz, both[..., 3:]], dim=-1) if use_xyz else both[..., 3:]
    return new_xyz, new_points, idx, grouped_xyz
