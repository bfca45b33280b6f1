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


def kernel_route(t: torch.Tensor, op: str) -> str:
    """Which implementation an op runs for ``t``: "cpu" (the plain PyTorch
    version) or "cuda" (the hand-written kernel). Any other device raises."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise NotImplementedError(f"{op}: no implementation for device {t.device}")
