"""Scatter-add, the group_point backward: the CUDA kernel's wrapper and its
plain version.

Kernel: ``votenet_tpu_torch/csrc/scatter.cu``. It replaces the Pallas kernel
``votenet_tpu/ops/pallas/scatter.py:43 _scatter_kernel`` (exact mode,
``passes=3``) with blocks that each own a tile of destination rows in shared
memory and add the matching update rows in ascending k, without atomics. On
the H100 it is bound by reading the updates once; see the note at the top of
the source.

Semantics of both versions: ``out[b, n, :] = sum over k with idx[b, k] == n
of g[b, k, :]``, f32, every sum in ascending k from +0.0. On the CPU the
plain version's ``index_add_`` adds sequentially, so it is bit-identical to a
sequential ``np.add.at``, and so is the kernel. On a CUDA tensor
``index_add_`` adds with atomics in an order that changes from run to run;
the kernel does not.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda


def scatter_add_plain(g: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Plain PyTorch scatter-add: g (B, K, C) f32, idx (B, K) int ->
    (B, num_rows, C) f32."""
    B, K, C = g.shape
    off = (torch.arange(B, device=idx.device) * num_rows)[:, None]
    flat = (idx.long() + off).reshape(-1)
    out = torch.zeros((B * num_rows, C), dtype=torch.float32, device=g.device)
    return out.index_add_(0, flat, g.reshape(B * K, C).float()).reshape(B, num_rows, C)


# A block walks all K indices of its batch row once per tile: the walks over
# the whole grid, B * tiles * ceil(K / 1024) * channel chunks, cost more than
# the adds past about this many (chosen from a sweep of tile heights 64-4 at
# the four live shapes, B=2 and B=8, on an H100).
SCAN_BUDGET = 16384


def tile_rows(B: int, K: int, N: int, C: int) -> int:
    """Rows of a block's tile: the smallest of 64, 32, 16, 8, 4 whose index
    walks stay within SCAN_BUDGET (smaller tiles make more blocks and fewer
    adds per block)."""
    rows = 64
    while rows > 4 and B * -(-N // (rows // 2)) * -(-K // 1024) * -(-C // 512) <= SCAN_BUDGET:
        rows //= 2
    return rows


def scatter_add_cuda(g: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Launch the scatter-add kernel: contiguous g (B, K, C) f32 and idx
    (B, K) int32 CUDA tensors -> (B, num_rows, C) f32. Indices must lie in
    [0, num_rows); the kernel drops any other. The tile height is
    :func:`tile_rows`.

    Raises for a tensor that is not on a CUDA device; it never computes the
    plain version. Adds one to ``scatter_add_cuda.launches`` per launch.
    """
    require_cuda("scatter_add_cuda", g, 3)
    if not isinstance(idx, torch.Tensor) or idx.device != g.device:
        raise RuntimeError(f"scatter_add_cuda: idx must be a CUDA tensor on {g.device}")
    B, K, C = g.shape
    if idx.dtype != torch.int32 or tuple(idx.shape) != (B, K) or not idx.is_contiguous():
        raise ValueError(
            f"scatter_add_cuda: idx must be a contiguous int32 ({B}, {K}) tensor, "
            f"got {idx.dtype} {tuple(idx.shape)} contiguous={idx.is_contiguous()}"
        )
    if B < 1 or K < 1 or C < 1 or num_rows < 1:
        raise ValueError(f"scatter_add_cuda: need B, K, C, num_rows >= 1, got {B}, {K}, {C}, {num_rows}")
    lib = library()
    rows = tile_rows(B, K, num_rows, C)
    out = torch.empty((B, num_rows, C), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.votenet_scatter_add(
            g.data_ptr(), idx.data_ptr(), B, K, num_rows, C, rows, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, "scatter_add")
    scatter_add_cuda.launches += 1
    return out


scatter_add_cuda.launches = 0
