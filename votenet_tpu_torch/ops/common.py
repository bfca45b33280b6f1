"""Shared helpers for the point-cloud ops (port of votenet_tpu/ops/common.py)."""

from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact squared euclidean distances: a (..., M, 3), b (..., N, 3) -> (..., M, N).

    Written as ``(dx*dx + dy*dy) + dz*dz`` so the rounding order is fixed:
    it is the order of the JAX package's ``pairwise_sqdist`` and of the CUDA
    kernels in ``csrc/``, whose hit tests and argmaxes must agree bit for bit.
    """
    diff = a[..., :, None, :] - b[..., None, :, :]
    dx, dy, dz = diff.unbind(-1)
    return dx * dx + dy * dy + dz * dz


def pairwise_sqdist_fast_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The fast_bf16 ball query's squared distances: a (..., M, 3) queries,
    b (..., N, 3) points -> (..., M, N), as ``(a2 + b2) - 2 * ab``.

    The JAX package's "fast_bf16" hit test is the matmul expansion
    ``pairwise_sqdist_mm`` (``votenet_tpu/ops/common.py:60-76``). On the TPU,
    where the mode was measured and used, the cross term's einsum at default
    precision rounds the coordinate operands to bf16; on the CPU the same
    einsum runs in f32. The port follows the TPU semantics, as the scatter's
    fast_bf16 mode follows the TPU kernel's single pass: the CPU twin's f32
    form is an artefact of running the TPU code on a CPU, not the mode's
    meaning (its cost and its boundary band are the bf16 operands').

    Each step in f32, none fused: the norms ``a2``, ``b2`` as ``(x*x + y*y)
    + z*z`` of the unrounded coordinates; the cross term ``ab = (x'x'' +
    y'y'') + z'z''`` over the coordinates rounded to bf16 (nearest, ties to
    even), each product exact in f32 (8-bit significands); then ``(a2 + b2)
    - 2 * ab``. The kernel of ``csrc/ballquery.cu`` (``FAST``) computes the
    same floats.
    """
    a = a.float()
    b = b.float()
    a2 = (a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]) + a[..., 2] * a[..., 2]
    b2 = (b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1]) + b[..., 2] * b[..., 2]
    ar = a.to(torch.bfloat16).float()[..., :, None, :]
    br = b.to(torch.bfloat16).float()[..., None, :, :]
    ab = (ar[..., 0] * br[..., 0] + ar[..., 1] * br[..., 1]) + ar[..., 2] * br[..., 2]
    return (a2[..., :, None] + b2[..., None, :]) - 2.0 * ab


def kernel_route(t: torch.Tensor, op: str) -> str:
    """Which implementation an op runs for ``t``: "cpu" (the plain PyTorch
    version) or "cuda" (the hand-written kernel). Any other device raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise NotImplementedError(f"{op}: no implementation for device {t.device}")
