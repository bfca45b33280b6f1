"""The fused SA-layer MLP + max-pool of the eval path (port of
votenet_tpu/ops/pallas/samlp.py, run when ``Config.samlp == "on"``)."""

from __future__ import annotations

from typing import Sequence

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.samlp import Layer, fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

__all__ = ["fused_sa_mlp_pool"]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def fused_sa_mlp_pool(
    h_all: torch.Tensor, idx: torch.Tensor, sh0: torch.Tensor, s0: torch.Tensor, layers: Sequence[Layer],
    precision: str = "f32",
) -> torch.Tensor:
    """``amax(chain(group_point(h_all, idx)), dim=2)`` with the eval batch
    norm folded: h_all (B, N, w0), idx (B, M, S), sh0 (B, M, w0), s0 (w0,),
    layers of (W (w_in, w_out), scale, shift) -> (B, M, w_last) f32 (the
    chain is spelled out in ``ops/cuda/samlp.py``). ``precision`` is the
    matmuls' operand precision, "f32" or "bf16" (f32 accumulation), the JAX
    kernel's ``precision``.

    A CPU tensor runs the plain version, a CUDA tensor the kernel of
    ``csrc/samlp.cu``; any other device raises.
    """
    if kernel_route(h_all, "fused_sa_mlp_pool") == "cuda":
        return fused_sa_mlp_pool_cuda(
            _f32(h_all), idx.to(torch.int32).contiguous(), _f32(sh0), _f32(s0),
            [(W.float(), _f32(s), _f32(t)) for W, s, t in layers], precision,
        )
    return fused_sa_mlp_pool_plain(h_all, idx, sh0, s0, layers, precision)
