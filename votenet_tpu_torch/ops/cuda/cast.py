"""``cast_bf16_multi``: a table of 2-d views cast between f32 and bf16 in
one launch, the CUDA kernel's wrapper and its plain version.

Kernel: ``votenet_tpu_torch/csrc/cast.cu``, the port's own (the JAX
package's flax layers cast their kernels at every call, and XLA fuses the
convert into the dot on the TPU; no Pallas kernel). ``models/bf16_copies.py``
refreshes the bf16 copies of the dense weights with it, and casts their
bf16 gradients into the f32 parameters' with it.

A pair is (src, dst): dst <- src cast to dst's dtype, f32 -> bf16 rounded
to nearest even (torch's ``.to(torch.bfloat16)``; on the card the same
conversion as torch's CUDA cast, NaN bits included) or bf16 -> f32 (exact);
src None writes zeros. Both 1-d or 2-d views of the same shape, any
strides (a 1-d view is one row); every pair of a call in the same
direction, on one device.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library

CAST_MAX_ENTRIES = 64  # entries a launch takes (csrc/cast.cu kMaxEntries)
CAST_THREADS = 256
CAST_MAX_BLOCKS = 64  # CTAs an entry at most (the grid's x)
CastPairs = Sequence[tuple[Optional[torch.Tensor], torch.Tensor]]


class CastEntry(ctypes.Structure):
    """csrc/cast.cu's CastEntry: a view's pointers, shape and strides in
    elements."""
    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p), ("rows", ctypes.c_int), ("cols", ctypes.c_int),
                ("src_row", ctypes.c_int), ("src_col", ctypes.c_int), ("dst_row", ctypes.c_int),
                ("dst_col", ctypes.c_int)]


def _as_2d(t: torch.Tensor) -> torch.Tensor:
    return t[None] if t.dim() == 1 else t


def check_pairs(pairs: CastPairs) -> bool:
    """Check a table (shapes, dtypes, one direction, one device); returns the
    direction, True for f32 -> bf16."""
    if not pairs:
        raise ValueError("cast_bf16_multi: no tensors")
    to_bf16 = pairs[0][1].dtype == torch.bfloat16
    want_dst, want_src = (torch.bfloat16, torch.float32) if to_bf16 else (torch.float32, torch.bfloat16)
    device = pairs[0][1].device
    for src, dst in pairs:
        if dst.dtype != want_dst or dst.dim() not in (1, 2) or dst.device != device:
            raise ValueError(f"cast_bf16_multi: destination {dst.dtype} {tuple(dst.shape)} on {dst.device}: "
                             f"{want_dst}, 1-d or 2-d, on {device}")
        if src is not None and (src.dtype != want_src or src.shape != dst.shape or src.device != device):
            raise ValueError(f"cast_bf16_multi: source {src.dtype} {tuple(src.shape)} on {src.device} against "
                             f"destination {dst.dtype} {tuple(dst.shape)}")
    return to_bf16


def cast_bf16_multi_plain(pairs: CastPairs) -> None:
    """The plain version: each source cast with ``.to()`` into its
    destination (zeros where the source is None)."""
    check_pairs(pairs)
    for src, dst in pairs:
        if src is None:
            dst.zero_()
        else:
            dst.copy_(src.to(dst.dtype))


def cast_bf16_multi_cuda(pairs: CastPairs) -> None:
    """The kernel: every pair in one launch (a launch per CAST_MAX_ENTRIES
    pairs past that) on the current stream. The tensors must be CUDA
    tensors: given another it raises, and computes nothing. Adds one to
    ``cast_bf16_multi_cuda.launches`` a launch."""
    for src, dst in pairs:
        for t in (src, dst):
            if t is not None and t.device.type != "cuda":
                raise RuntimeError(f"cast_bf16_multi_cuda: the CUDA kernel needs a CUDA tensor, got {t.device}")
    to_bf16 = check_pairs(pairs)
    lib = library()
    if lib.votenet_cast_entry_bytes() != ctypes.sizeof(CastEntry):
        raise RuntimeError("cast_bf16_multi_cuda: the kernel's entry layout differs from CastEntry")
    device = pairs[0][1].device
    for k in range(0, len(pairs), CAST_MAX_ENTRIES):
        chunk = [(s, d) for s, d in pairs[k:k + CAST_MAX_ENTRIES] if d.numel()]
        if not chunk:
            continue
        table = (CastEntry * len(chunk))()
        most = 0
        for e, (src, dst) in zip(table, chunk):
            d2 = _as_2d(dst)
            s2 = d2 if src is None else _as_2d(src)
            if max(d2.shape) >= 2 ** 31 or max(map(abs, (*d2.stride(), *s2.stride()))) >= 2 ** 31:
                raise ValueError("cast_bf16_multi_cuda: a view's sizes and strides must fit 32 bits")
            e.src = None if src is None else s2.data_ptr()
            e.dst = d2.data_ptr()
            e.rows, e.cols = d2.shape
            e.src_row, e.src_col = s2.stride()
            e.dst_row, e.dst_col = d2.stride()
            most = max(most, d2.numel())
        blocks = min(CAST_MAX_BLOCKS, -(-most // (4 * CAST_THREADS)))
        with torch.cuda.device(device):
            err = lib.votenet_cast_bf16_multi(ctypes.addressof(table), len(chunk), int(to_bf16), blocks,
                                              torch.cuda.current_stream(device).cuda_stream)
        check_launch(err, "cast_bf16_multi")
        cast_bf16_multi_cuda.launches += 1


cast_bf16_multi_cuda.launches = 0
