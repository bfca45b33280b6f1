"""Batch norm + ReLU as one autograd op: flax ``nn.BatchNorm`` followed by
``nn.relu`` (``votenet_tpu/models/pointnet2.py:166-174``), in four stages.

Forward: the batch's per-channel sums (stage 1, training only), then the
normalisation with the ReLU (stage 2). Backward: the per-channel sums of the
masked cotangent and of its product with ``x - mean`` (stage 3), then the
input's cotangent (stage 4). Each stage runs a hand-written CUDA kernel for
a CUDA tensor (``ops/cuda/batchnorm.py``, ``csrc/batchnorm.cu``) and its
plain PyTorch version below for a CPU tensor; anything else raises. Between
the stages, per-channel vectors (C floats) are computed with torch ops on
either device.

Semantics (those of the port's earlier eager ``BatchNorm`` + ``torch.relu``,
which follow flax):

- Statistics in f32 whatever the input's dtype. Training normalises by the
  batch's: ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)`` (flax's fast
  variance, biased), over every axis but the last; eval by the running
  statistics. ``mul = rsqrt(var + eps) * weight``; ``y = ((x - mean) * mul)
  + bias`` rounded to ``dtype``; the ReLU in ``dtype`` (torch's: a NaN
  stays).
- ``group`` (a data-parallel process group) makes the sums the group's:
  they are all-reduced between stages 1 and 2 and the row count is this
  rank's times the group's size; in the backward the cotangents of the sums
  are summed over the group before stage 4 (``comm.psum_varying``'s rule),
  while ``weight``'s and ``bias``'s stay this rank's own. No collective
  runs inside a kernel.
- The running statistics move once, in place and outside autograd, to
  ``momentum * running + (1 - momentum) * batch`` (flax's convention),
  unless ``update_stats`` is False (remat's recompute).
- The gradient is autograd's of the formula above, written out in
  :func:`bn_input_coefficients`: ``dx = ((g * mul) + a) + (b * x)`` with
  per-channel ``a`` and ``b``, where g is the cotangent masked by the ReLU
  (``threshold_backward``: zero where the pre-ReLU output is <= 0, so a NaN
  passes). The clamp of the variance passes its gradient unless
  ``E[x^2] - mean^2 < 0`` (``torch.clamp``'s rule). Only ``x`` is saved
  of the rows: the mask is recomputed from it.
"""

from __future__ import annotations

from typing import Optional

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.batchnorm import bn_apply_cuda, bn_bwd_apply_cuda, bn_bwd_reduce_cuda, bn_stats_cuda
from votenet_tpu_torch.parallel import comm


def bn_stats_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: per-channel ``sum(x)`` and ``sum(x * x)`` of (R, C) rows, f32."""
    x = x.float()
    return x.sum(0), (x * x).sum(0)


def _normalized(x, mean, mul, bias, dtype):
    return ((x.float() - mean) * mul + bias).to(dtype)


def bn_apply_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                   relu: bool) -> torch.Tensor:
    """Stage 2: ``((x - mean) * mul) + bias`` in f32, rounded to ``dtype``,
    then ``torch.relu`` where ``relu``."""
    y = _normalized(x, mean, mul, bias, dtype)
    return torch.relu(y) if relu else y


def _masked(x, dy, mean, mul, bias, relu):
    """The cotangent through the ReLU, f32: dy where the recomputed pre-ReLU
    output (in dy's dtype) is not <= 0."""
    if relu:
        dy = torch.where(_normalized(x, mean, mul, bias, dy.dtype) <= 0, 0, dy)
    return dy.float()


def bn_bwd_reduce_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                        bias: torch.Tensor, relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3: per-channel ``sum(g)`` and ``sum(g * (x - mean))``, g the
    masked cotangent."""
    g = _masked(x, dy, mean, mul, bias, relu)
    return g.sum(0), (g * (x.float() - mean)).sum(0)


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       a: Optional[torch.Tensor], b: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """Stage 4: ``((g * mul) + a) + (b * x)`` (``g * mul`` without a and b:
    eval) in x's dtype."""
    g = _masked(x, dy, mean, mul, bias, relu)
    dx = g * mul if a is None else (g * mul + a) + b * x.float()
    return dx.to(x.dtype)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (R, C) view of x; on the card a view or an error, never a copy."""
    return x.view(-1, x.shape[-1]) if x.is_cuda else x.reshape(-1, x.shape[-1])


def _stages(x: torch.Tensor):
    """(stats, apply, bwd_reduce, bwd_apply) for x's device. Looked up at
    each call, so that a test can substitute a stage."""
    if kernel_route(x, "batch_norm_relu") == "cuda":
        return bn_stats_cuda, bn_apply_cuda, bn_bwd_reduce_cuda, bn_bwd_apply_cuda
    return bn_stats_plain, bn_apply_plain, bn_bwd_reduce_plain, bn_bwd_apply_plain


def bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, weight, var_raw, count: int, group: comm.Group = None):
    """The per-channel ``a``, ``b`` of ``dx = g * mul + a + b * x`` in
    training: autograd of ``mean = s / count``, ``var_raw = sq / count -
    mean^2``, ``var = clamp(var_raw, min=0)``, ``inv = rsqrt(var + eps)``,
    ``mul = inv * weight``, ``y = (x - mean) * mul + bias`` given the
    stage-3 sums ``sum_g`` (the cotangent of bias) and ``sum_gx`` (of mul).
    ``a`` is the cotangent of ``s = sum(x)``, ``b`` twice that of ``sq =
    sum(x * x)``, each summed over ``group`` first."""
    d_var = (sum_gx * weight) * (-0.5 * inv.pow(3))  # through mul and rsqrt
    d_var = torch.where(var_raw < 0, 0.0, d_var)  # torch.clamp(min=0)'s rule
    d_mean = -(mul * sum_g) - 2.0 * mean * d_var
    d_s, d_sq = d_mean / count, d_var / count
    if group is not None:
        d_s, d_sq = comm.all_reduce(torch.cat([d_s, d_sq]), group).chunk(2)
    return d_s, 2.0 * d_sq


class _BatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running, training, momentum, eps, group, update_stats, dtype, relu):
        stats, apply, _, _ = _stages(x)
        rows = _rows(x)
        var_raw, count = None, None
        if training:
            s, sq = stats(rows)
            count = rows.shape[0] * comm.size(group)
            if group is not None:
                s, sq = comm.all_reduce(torch.cat([s, sq]), group).chunk(2)
            mean = s / count
            var_raw = sq / count - mean * mean
            var = torch.clamp(var_raw, min=0.0)
            if update_stats:
                running_mean, running_var = running
                running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
                running_var.copy_(momentum * running_var + (1 - momentum) * var)
        else:
            mean, var = running
        inv = torch.rsqrt(var + eps)
        mul = inv * weight
        y = apply(rows, mean, mul, bias, dtype, relu).view(x.shape)
        ctx.save_for_backward(x, weight, bias, mean, mul, inv, var_raw)
        ctx.count, ctx.group, ctx.relu = count, group, relu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, mul, inv, var_raw = ctx.saved_tensors
        _, _, bwd_reduce, bwd_apply = _stages(x)
        rows, dy_rows = _rows(x), _rows(dy.contiguous())
        sum_g, sum_gx = bwd_reduce(rows, dy_rows, mean, mul, bias, ctx.relu)
        a = b = None
        if var_raw is not None:
            a, b = bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, weight, var_raw, ctx.count, ctx.group)
        dx = bwd_apply(rows, dy_rows, mean, mul, bias, a, b, ctx.relu).view(x.shape) if ctx.needs_input_grad[0] else None
        return dx, sum_gx * inv, sum_g, None, None, None, None, None, None, None, None


def batch_norm_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, *, training: bool, momentum: float = 0.9, eps: float = 1e-5,
                    group: comm.Group = None, update_stats: bool = True, dtype: Optional[torch.dtype] = None,
                    relu: bool = True) -> torch.Tensor:
    """Batch norm over the last axis of ``x`` (..., C), then the ReLU where
    ``relu``, as one autograd op; the output in ``dtype`` (x's by default).
    ``weight``, ``bias`` and the running statistics are f32 (C,); the
    running statistics move in place in training unless ``update_stats`` is
    False. See the module docstring. On a CUDA tensor each stage is one
    kernel launch; ``x`` must be contiguous there."""
    return _BatchNormReLU.apply(x, weight, bias, (running_mean, running_var), training, momentum, eps, group,
                                update_stats, dtype or x.dtype, relu)
