"""Farthest-point sampling: the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/fps.cu``. It replaces the Pallas kernels
``votenet_tpu/ops/pallas/fps.py:47 _fps_kernel`` and ``:79
_fps_rowwise_kernel`` with one thread-block cluster of 1-16 CTAs per batch
row (:func:`fps_cluster_size`); each CTA keeps its slice's coordinates and
running minimum in registers (:func:`fps_points_per_thread`). Where the
rule's cluster leaves more than 32 points a thread, a row takes the staged
route (40 points a thread, 10240 a CTA, the slice's coordinates also in
shared memory: eval's sa1 at B=64) while that covers it, and past that the
global-scratch route, which reads the coordinates each step and keeps the
minimum in device memory (:func:`fps_plan`). On the H100 it is bound by the
latency of its npoint sequential steps (an argmax across the cluster each),
not by bandwidth: see the note at the top of the source.

Semantics of both versions (``votenet_tpu/ops/sampling.py:76-101``
``farthest_point_sample_xla``): slot 0 is index 0; each step picks the argmax
of the running minimum squared distance (initialised to 1e38) with the lowest
index on ties; d2 is ``(dx*dx + dy*dy) + dz*dz`` in f32, never fused.

The noscalar variant (:func:`fps_rowwise_noscalar_cuda`, after the prototype
``benchmarks/fps_noscalar_proto.py:47 _fps_rowwise_noscalar_kernel``) gives
the same indices: its candidates carry (value, index) only, and the pick's
coordinates come from masked sums in the warp that owns it, sent to every
CTA in a second exchange a step.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda


def farthest_point_sample_plain(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch FPS: (B, N, 3) f32 -> (B, npoint) int32."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)  # (B, N) each
    mindist = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        mindist = torch.minimum(mindist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mindist, dim=-1)  # first maximal index on ties
        idxs[:, i] = last.to(torch.int32)
    return idxs


FPS_THREADS = 256  # threads of a CTA (csrc/fps.cu kThreads)
# Points a CTA owns at most before a row is split further. A step's exchange
# grows with the cluster (cs * 8 candidates land in every CTA), so the split
# stops where that costs more than the CTA's share of the distances: on the
# H100, 8 CTAs beat 4 and 16 at 20480 points, and 1 CTA beats 2 at 2048
# (chip_smoke.py phase 3 times every cluster size at these two shapes).
FPS_POINTS_PER_CTA = 2560
FPS_CLUSTER_SIZES = (1, 2, 4, 8, 16)
FPS_POINTS_PER_THREAD = (1, 2, 4, 5, 8, 10, 16, 20, 32)  # register variants; 0: none fits
# The staged route's instance (csrc/fps.cu kStagedPpt): one CTA an SM, so at
# 2 CTAs a row the card holds 66 rows of 20480 points at once. Chosen on the
# H100 from 256 to 1024 threads a CTA at sa1's B=64 shape (PERF.md, section 6).
FPS_STAGED_POINTS_PER_THREAD = 40
FPS_STAGED_POINTS_PER_CTA = FPS_THREADS * FPS_STAGED_POINTS_PER_THREAD
FPS_ROUTES = ("registers", "staged", "scratch")


def fps_cluster_size(B: int, N: int, max_clusters) -> int:
    """CTAs a batch row is split over: the smallest power of two that leaves
    each CTA at most FPS_POINTS_PER_CTA points (16 at most), halved while the
    B clusters would not all be resident at once (``max_clusters(cs)``: how
    many clusters of cs CTAs the card holds), since a second wave of clusters
    doubles the time."""
    cs = 1
    while cs < FPS_CLUSTER_SIZES[-1] and cs * FPS_POINTS_PER_CTA < N:
        cs *= 2
    while cs > 1 and B > max_clusters(cs):
        cs //= 2
    return cs


def fps_points_per_thread(N: int, cs: int) -> int:
    """Points a thread keeps in registers: the smallest register variant
    that covers a CTA's slice, ceil(N / cs) points over FPS_THREADS threads;
    0 when even 32 do not (:func:`fps_plan` then takes the staged or the
    scratch route)."""
    need = -(-(-(-N // cs)) // FPS_THREADS)
    return next((p for p in FPS_POINTS_PER_THREAD if p >= need), 0)


def fps_staged_cluster_size(N: int, cs: int) -> int:
    """The smallest power of two from ``cs`` up (16 at most) whose CTAs'
    staged slices cover N points."""
    while cs < FPS_CLUSTER_SIZES[-1] and cs * FPS_STAGED_POINTS_PER_CTA < N:
        cs *= 2
    return cs


def fps_plan(B: int, N: int, max_clusters, cluster: int | None = None,
             route: str | None = None) -> tuple[int, int, str]:
    """(CTAs a row, points a thread keeps in registers, route) of a launch
    over B rows of N points.

    The CTAs are :func:`fps_cluster_size`'s against ``max_clusters`` (see
    there) unless ``cluster`` forces them. The route is ``registers`` where
    :func:`fps_points_per_thread` finds a register variant at that size, so
    every such shape keeps its variant. Else ``staged`` while its CTAs cover
    the row: with the rule's size, grown to :func:`fps_staged_cluster_size`
    (a row needing more CTAs than the card holds at once runs in waves,
    still faster than the scratch route); with a forced size, that size.
    Else ``scratch``. ``route`` forces one of :data:`FPS_ROUTES` (the
    scratch route at the rule's size is the choice before the staged route
    existed); ValueError where it cannot take the row.
    """
    cs = cluster or fps_cluster_size(B, N, max_clusters)
    ppt = fps_points_per_thread(N, cs)
    staged_cs = cs if cluster else fps_staged_cluster_size(N, cs)
    covered = staged_cs * FPS_STAGED_POINTS_PER_CTA >= N
    if route is None:
        route = "registers" if ppt else "staged" if covered else "scratch"
    if route not in FPS_ROUTES:
        raise ValueError(f"fps route must be one of {FPS_ROUTES}, got {route!r}")
    if route == "registers" and not ppt:
        raise ValueError(f"fps: {N} points do not fit the register variants at {cs} CTAs a row")
    if route == "staged":
        if not covered:
            raise ValueError(f"fps: {N} points do not fit the staged route at {staged_cs} CTAs a row")
        return staged_cs, FPS_STAGED_POINTS_PER_THREAD, route
    return cs, ppt if route == "registers" else 0, route


_max_clusters: dict = {}


def _resident_clusters(lib, device: torch.device, N: int):
    """``cs -> cudaOccupancyMaxActiveClusters`` of the variant N takes."""

    def query(cs: int) -> int:
        key = (device.index, cs, fps_points_per_thread(N, cs))
        if key not in _max_clusters:
            n = lib.votenet_fps_max_clusters(cs, key[2])
            if n < 0:
                check_launch(-n, "fps occupancy query")
            _max_clusters[key] = n
        return _max_clusters[key]

    return query


def fps_route(xyz: torch.Tensor, cluster: int | None = None, route: str | None = None) -> tuple[int, int, str]:
    """:func:`fps_plan` of a launch on the CUDA tensor ``xyz`` (B, N, 3),
    against the card's resident-cluster counts."""
    B, N, _ = xyz.shape
    with torch.cuda.device(xyz.device):
        return fps_plan(B, N, _resident_clusters(library(), xyz.device, N), cluster, route)


def _launch(name: str, npoint: int, xyz: torch.Tensor, cluster: int | None, route: str | None,
            noscalar: bool) -> tuple[torch.Tensor, str]:
    """Check the arguments and launch ``votenet_fps`` (``votenet_fps_staged``
    on the staged route) on the route :func:`fps_route` gives; the output
    and the route's name."""
    require_cuda(name, xyz, 3, 3)
    B, N, _ = xyz.shape
    if npoint < 1 or B < 1 or N < 1:
        raise ValueError(f"{name}: need npoint, B, N >= 1, got {npoint}, {B}, {N}")
    if cluster is not None and cluster not in FPS_CLUSTER_SIZES:
        raise ValueError(f"{name}: cluster must be one of {FPS_CLUSTER_SIZES}, got {cluster}")
    lib = library()
    with torch.cuda.device(xyz.device):
        cs, ppt, route = fps_route(xyz, cluster, route)
        if noscalar and route != "registers":
            raise ValueError(f"{name}: keeps its points in registers, at most "
                             f"{FPS_THREADS * FPS_POINTS_PER_THREAD[-1] * cs} a row at {cs} CTAs; got N={N}")
        out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
        stream = torch.cuda.current_stream().cuda_stream
        if route == "staged":
            err = lib.votenet_fps_staged(xyz.data_ptr(), B, N, npoint, cs, out.data_ptr(), stream)
        else:
            scratch = torch.empty((B, N), dtype=torch.float32, device=xyz.device) if ppt == 0 else None
            err = lib.votenet_fps(xyz.data_ptr(), B, N, npoint, cs, ppt, int(noscalar), out.data_ptr(),
                                  None if scratch is None else scratch.data_ptr(), stream)
    check_launch(err, name)
    return out, route


def farthest_point_sample_cuda(npoint: int, xyz: torch.Tensor, cluster: int | None = None,
                               route: str | None = None) -> torch.Tensor:
    """Launch the FPS kernel: contiguous (B, N, 3) f32 CUDA -> (B, npoint) int32.

    ``cluster`` forces the CTAs a row is split over (1, 2, 4, 8 or 16) and
    ``route`` the route (one of :data:`FPS_ROUTES`); by default
    :func:`fps_plan` picks both. Every route gives the same indices. Raises
    for a tensor that is not on a CUDA device; it never computes the plain
    version. Adds one to ``farthest_point_sample_cuda.launches`` and to the
    route's entry of ``farthest_point_sample_cuda.routes`` per launch.
    """
    out, taken = _launch("farthest_point_sample_cuda", npoint, xyz, cluster, route, noscalar=False)
    farthest_point_sample_cuda.launches += 1
    farthest_point_sample_cuda.routes[taken] += 1
    return out


farthest_point_sample_cuda.launches = 0
farthest_point_sample_cuda.routes = dict.fromkeys(FPS_ROUTES, 0)


def fps_rowwise_noscalar_cuda(npoint: int, xyz: torch.Tensor, cluster: int | None = None) -> torch.Tensor:
    """Launch the FPS kernel's noscalar variant: contiguous (B, N, 3) f32
    CUDA -> (B, npoint) int32, the indices of
    :func:`farthest_point_sample_cuda`, on the route it takes (``cluster``
    forces the CTAs a row is split over). Any B; N up to the register
    variants' reach (131072 at 16 CTAs), else ValueError. Raises for a
    tensor that is not on a CUDA device; it never computes the plain
    version. Adds one to ``fps_rowwise_noscalar_cuda.launches`` per launch.
    """
    out, _ = _launch("fps_rowwise_noscalar_cuda", npoint, xyz, cluster, None, noscalar=True)
    fps_rowwise_noscalar_cuda.launches += 1
    return out


fps_rowwise_noscalar_cuda.launches = 0
