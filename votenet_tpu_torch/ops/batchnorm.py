"""Batch norm + ReLU with the layer around it as one autograd op: the dense
layer's bias (flax ``nn.Dense``) or the centred first layer
(``CenteredDense``), ``nn.BatchNorm``, ``nn.relu`` and, at an SA layer's
last width, ``jnp.max`` over the ball's slots
(``votenet_tpu/models/pointnet2.py:95-103, 166-174, 540-541``), in four
stages.

Forward: the batch's per-channel sums (stage 1, training only), then the
normalisation with the ReLU, and the pool where asked (stage 2). Backward:
the per-channel sums of the masked cotangent and of its product with ``x -
mean`` (stage 3), then the input's cotangent (stage 4). Each stage reads
the dense layer's output h and forms x of it (the prologue, ``x = (h -
corr) + dense_bias``, each operation rounded once to h's dtype, as the eager
ops round). Each stage runs a hand-written CUDA kernel for a CUDA tensor
(``ops/cuda/batchnorm.py``, ``csrc/batchnorm.cu``) and its plain PyTorch
version below for a CPU tensor; anything else raises. Between the stages,
per-channel vectors (C floats) are computed with torch ops on either device.

Semantics (those of the port's earlier eager ``(h - corr) + b``, batch
norm, ``torch.relu`` and ``torch.amax``, which follow flax; the plain stages
give their bits):

- Statistics in f32 whatever the input's dtype. Training normalises by the
  batch's: ``mean = E[x]``, ``var = max(0, E[x^2] - mean^2)`` (flax's fast
  variance, biased), over every axis but the last; eval by the running
  statistics. ``mul = rsqrt(var + eps) * weight``; ``y = ((x - mean) * mul)
  + bias`` rounded to ``dtype``; the ReLU in ``dtype`` (torch's: a NaN
  stays).
- The pool (``pool="max"``): ``torch.amax`` of the output over the S axis;
  its gradient is torch's and ``jnp.max``'s rule, the pooled cotangent
  divided by the count of slots equal to the max and given to each of them
  (``(gp / count) * (y == max)``, each rounded to ``dtype``). The stage
  writes the maxima and the counts; the full output is never stored.
- ``group`` (a data-parallel process group) makes the sums the group's:
  they are all-reduced between stages 1 and 2, in f64 (the kernel's sums
  are f64 until then, so that a split batch's statistics are the whole
  batch's), and the row count is this rank's times the group's size; in the backward the cotangents of the sums
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
  ``E[x^2] - mean^2 < 0`` (``torch.clamp``'s rule). dx is h's cotangent;
  ``corr``'s is ``(-dx).sum(-2)`` and the dense bias's ``dx`` summed over
  every axis but the last, the torch sums autograd takes for the eager
  prologue. Saved of the rows: h alone (the prologue, the mask and the
  pool's ties are recomputed from it), and at a pooled site the maxima and
  counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.batchnorm import bn_apply_cuda, bn_bwd_apply_cuda, bn_bwd_reduce_cuda, bn_stats_cuda
from votenet_tpu_torch.parallel import comm


def layer_rows_plain(h: torch.Tensor, corr: Optional[torch.Tensor] = None,
                     dense_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prologue: x = ``(h - corr[unit]) + dense_bias`` of (R, C) rows h,
    each operation one torch op in h's dtype (rounded once), ``corr`` (R / S,
    C) taken by each unit of S consecutive rows; either term optional."""
    x = h
    if corr is not None:
        C = h.shape[-1]
        x = (h.reshape(corr.shape[0], -1, C) - corr[:, None, :]).reshape(-1, C)
    if dense_bias is not None:
        x = x + dense_bias
    return x


def bn_stats_plain(x: torch.Tensor, corr: Optional[torch.Tensor] = None,
                   dense_bias: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 1: per-channel ``sum(x)`` and ``sum(x * x)`` of (R, C) rows, f32;
    x through the prologue (:func:`layer_rows_plain`)."""
    x = layer_rows_plain(x, corr, dense_bias).float()
    return x.sum(0), (x * x).sum(0)


def _normalized(x, mean, mul, bias, dtype):
    return ((x.float() - mean) * mul + bias).to(dtype)


def _max_pool(y: torch.Tensor, S: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``torch.amax`` over each unit of S rows of y (R, C), and the int32
    count of the unit's rows equal to it (0 where the max is NaN)."""
    y3 = y.view(-1, S, y.shape[-1])
    ymax = torch.amax(y3, dim=1)
    return ymax, (y3 == ymax[:, None]).sum(1, dtype=torch.int32)


def bn_apply_plain(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                   relu: bool, corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                   pool: int = 0):
    """Stage 2: ``((x - mean) * mul) + bias`` in f32, rounded to ``dtype``,
    then ``torch.relu`` where ``relu``; x through the prologue. With ``pool``
    = S: ``torch.amax`` over each unit of S rows and the int32 count of the
    rows equal to it, each (R / S, C)."""
    y = _normalized(layer_rows_plain(x, corr, dense_bias), mean, mul, bias, dtype)
    y = torch.relu(y) if relu else y
    return _max_pool(y, pool) if pool else y


def _slot_cotangent(y, gp, ymax, count):
    """The cotangent of each row of y (R, C) from the pooled gp (R / S, C),
    as ``torch.amax``'s backward forms it: ``(gp / count) * (y == max)``."""
    y3 = y.view(gp.shape[0], -1, y.shape[-1])
    return ((gp[:, None] / count[:, None]) * (y3 == ymax[:, None])).view(y.shape)


def _masked(x, dy, mean, mul, bias, relu, pooled=None):
    """The cotangent through the ReLU (and the pool), f32: dy where the
    recomputed pre-ReLU output (in dy's dtype) is not <= 0."""
    y = _normalized(x, mean, mul, bias, dy.dtype)
    if pooled is not None:
        dy = _slot_cotangent(torch.relu(y) if relu else y, dy, *pooled)
    if relu:
        dy = torch.where(y <= 0, 0, dy)
    return dy.float()


def bn_bwd_reduce_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                        bias: torch.Tensor, relu: bool, corr: Optional[torch.Tensor] = None,
                        dense_bias: Optional[torch.Tensor] = None,
                        pooled: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage 3: per-channel ``sum(g)`` and ``sum(g * (x - mean))``, g the
    masked cotangent; x through the prologue; with ``pooled = (ymax,
    count)``, dy is the pooled cotangent (R / S, C)."""
    x = layer_rows_plain(x, corr, dense_bias)
    g = _masked(x, dy, mean, mul, bias, relu, pooled)
    return g.sum(0), (g * (x.float() - mean)).sum(0)


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       a: Optional[torch.Tensor], b: Optional[torch.Tensor], relu: bool,
                       corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                       pooled: Optional[tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Stage 4: ``((g * mul) + a) + (b * x)`` (``g * mul`` without a and b:
    eval) in x's dtype; x, g as in :func:`bn_bwd_reduce_plain`."""
    x = layer_rows_plain(x, corr, dense_bias)
    g = _masked(x, dy, mean, mul, bias, relu, pooled)
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
    def forward(ctx, h, corr, dense_bias, weight, bias, running, training, momentum, eps, group, update_stats, dtype,
                relu, pool):
        stats, apply, _, _ = _stages(h)
        rows = _rows(h)
        C = h.shape[-1]
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias)
        var_raw, count = None, None
        if training:
            s, sq = stats(rows, **pro)  # f32 (plain) or f64 (the kernel)
            count = rows.shape[0] * comm.size(group)
            if group is not None:  # in f64: the group's sums as one process's
                s, sq = comm.all_reduce(torch.cat([s, sq]).double(), group).chunk(2)
            s, sq = s.float(), sq.float()
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
        ymax = slots = None
        if pool:
            ymax, slots = apply(rows, mean, mul, bias, dtype, relu, **pro, pool=h.shape[-2])
            y = ymax.view(*h.shape[:-2], C)
        else:
            y = apply(rows, mean, mul, bias, dtype, relu, **pro).view(h.shape)
        ctx.save_for_backward(h, corr, dense_bias, weight, bias, mean, mul, inv, var_raw, ymax, slots)
        ctx.count, ctx.group, ctx.relu = count, group, relu
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        h, corr, dense_bias, weight, bias, mean, mul, inv, var_raw, ymax, slots = ctx.saved_tensors
        _, _, bwd_reduce, bwd_apply = _stages(h)
        rows, dy_rows = _rows(h), _rows(dy.contiguous())
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias,
                   pooled=None if ymax is None else (ymax, slots))
        sum_g, sum_gx = bwd_reduce(rows, dy_rows, mean, mul, bias, ctx.relu, **pro)
        a = b = None
        if var_raw is not None:
            a, b = bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, weight, var_raw, ctx.count, ctx.group)
        d_h = d_corr = d_bias = None
        if any(ctx.needs_input_grad[:3]):
            dx = bwd_apply(rows, dy_rows, mean, mul, bias, a, b, ctx.relu, **pro).view(h.shape)
            # autograd's of (h - corr[..., None, :]) + dense_bias, each a torch sum over dx
            d_h = dx if ctx.needs_input_grad[0] else None
            if corr is not None and ctx.needs_input_grad[1]:
                d_corr = (-dx).sum(-2)
            if dense_bias is not None and ctx.needs_input_grad[2]:
                d_bias = dx.sum(tuple(range(dx.dim() - 1)))
        return (d_h, d_corr, d_bias, sum_gx * inv, sum_g) + (None,) * 9


def batch_norm_relu(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, *, training: bool, momentum: float = 0.9, eps: float = 1e-5,
                    group: comm.Group = None, update_stats: bool = True, dtype: Optional[torch.dtype] = None,
                    relu: bool = True, dense_bias: Optional[torch.Tensor] = None, corr: Optional[torch.Tensor] = None,
                    pool: Optional[str] = None) -> torch.Tensor:
    """Batch norm over the last axis of x (..., C), then the ReLU where
    ``relu``, as one autograd op; the output in ``dtype`` (h's by default).
    x is the dense layer's output h with the layer's prologue: ``x = (h -
    corr[..., None, :]) + dense_bias`` in h's dtype (the centred first
    layer, h (..., S, C) and ``corr`` (..., C), each unit of S rows taking
    its row of corr), or ``h + dense_bias``, or h itself; x is never stored.
    ``pool="max"`` takes ``torch.amax`` over the S axis (-2) of the output,
    (..., S, C) -> (..., C), with its gradient's rule (split evenly among
    tied maxima). ``weight``, ``bias`` and the running statistics are f32
    (C,); ``corr`` and ``dense_bias`` in h's dtype; the running statistics
    move in place in training unless ``update_stats`` is False. See the
    module docstring. On a CUDA tensor each stage is one kernel launch; the
    tensors must be contiguous there."""
    if corr is not None and (h.dim() < 2 or corr.shape != h.shape[:-2] + h.shape[-1:]):
        raise ValueError(f"batch_norm_relu: corr {tuple(corr.shape)} against h {tuple(h.shape)}: (..., S, C) "
                         f"takes (..., C)")
    if pool not in (None, "max") or (pool and h.dim() < 2):
        raise ValueError(f"batch_norm_relu: pool must be None or 'max' over the axis -2 of h, got {pool!r}")
    for what, t in (("corr", corr), ("dense_bias", dense_bias)):
        if t is not None and t.dtype != h.dtype:
            raise ValueError(f"batch_norm_relu: {what} is {t.dtype}, h {h.dtype}")
    return _BatchNormReLU.apply(h, corr, dense_bias, weight, bias, (running_mean, running_var), training, momentum,
                                eps, group, update_stats, dtype or h.dtype, relu, pool == "max")
