"""Batch norm + ReLU with the layer around it as one autograd op: the dense
layer's bias (flax ``nn.Dense``) or the centred first layer
(``CenteredDense``), ``nn.BatchNorm``, ``nn.relu`` and, at an SA layer's
last width, ``jnp.max`` over the ball's slots
(``votenet_tpu/models/pointnet2.py:95-103, 166-174, 540-541``), in four
stages.

Forward: the batch's per-channel sums and, from them, the statistics
(stage 1, training only), then the normalisation with the ReLU, and the
pool where asked (stage 2). Backward: the per-channel sums of the masked
cotangent and of its product with ``x - mean``, and from them the
coefficients (stage 3), then the input's cotangent and the prologue's
(stage 4). Each stage reads the dense layer's output h and forms x of it
(the prologue, ``x = (h - corr) + dense_bias``, each operation rounded once
to h's dtype, as the eager ops round). Each stage runs a hand-written CUDA
kernel for a CUDA tensor (``ops/cuda/batchnorm.py``, ``csrc/batchnorm.cu``)
and its plain PyTorch version below for a CPU tensor; anything else raises.
The per-channel arithmetic between the sums and the next stage (C floats:
:func:`bn_channel_stats_plain`, :func:`bn_channel_coefficients_plain`) runs
at the end of stages 1 and 3 on either device (inside the kernels on the
card, one torch op at a time on the CPU, the same bits on the card), and
eval's ``mul`` inside stage 2; so a site's training forward is two
launches, its backward two, an eval forward one.

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
  batch's), then the statistics' end runs alone (one launch on the card),
  and the row count is this rank's times the group's size; in the backward
  a and b are summed over the group before stage 4 (``comm.psum_varying``'s
  rule on the sums' cotangents: b is twice that of ``sum(x * x)``, and
  doubling commutes with the sum), while ``weight``'s and ``bias``'s stay
  this rank's own. No collective runs inside a kernel.
- The running statistics move once, in place and outside autograd, to
  ``momentum * running + (1 - momentum) * batch`` (flax's convention),
  unless ``update_stats`` is False (remat's recompute).
- The gradient is autograd's of the formula above, written out in
  :func:`bn_input_coefficients`: ``dx = ((g * mul) + a) + (b * x)`` with
  per-channel ``a`` and ``b``, where g is the cotangent masked by the ReLU
  (``threshold_backward``: zero where the pre-ReLU output is <= 0, so a NaN
  passes). The clamp of the variance passes its gradient unless
  ``E[x^2] - mean^2 < 0`` (``torch.clamp``'s rule). dx is h's cotangent;
  ``corr``'s is ``-sum(dx)`` over each unit of S rows and the dense bias's
  ``sum(dx)`` over every axis but the last, each the f64 sum of the rounded
  dx values rounded once to h's dtype (the dense bias's then held in f32,
  as autograd's cast of an f32 bias to h's dtype gives it). In training the
  dense bias's sum is 0 in exact arithmetic (batch norm takes out a shift):
  what it holds is the rounding of dx. Saved of the rows: h alone (the
  prologue, the mask and the pool's ties are recomputed from it), and at a
  pooled site the maxima and counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.batchnorm import (BnChannels, BnCoefficients, bn_apply_cuda, bn_bwd_apply_cuda,
                                                  bn_bwd_reduce_cuda, bn_channels_cuda, bn_stats_cuda)
from votenet_tpu_torch.parallel import comm


def layer_rows_plain(h: torch.Tensor, corr: Optional[torch.Tensor] = None,
                     dense_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The prologue: x = ``(h - corr[unit]) + dense_bias`` of (R, C) rows h,
    each operation one torch op in h's dtype (rounded once), ``corr`` (R / S,
    C) taken by each unit of S consecutive rows, the dense bias (f32 or h's
    dtype) cast to h's dtype; either term optional."""
    x = h
    if corr is not None:
        C = h.shape[-1]
        x = (h.reshape(corr.shape[0], -1, C) - corr[:, None, :]).reshape(-1, C)
    if dense_bias is not None:
        x = x + dense_bias.to(h.dtype)
    return x


def bn_stats_plain(x: torch.Tensor, corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                   channels: Optional[BnChannels] = None):
    """Stage 1: per-channel ``sum(x)`` and ``sum(x * x)`` of (R, C) rows, f32;
    x through the prologue (:func:`layer_rows_plain`). With ``channels`` the
    statistics' end (:func:`bn_channel_stats_plain`) of them."""
    x = layer_rows_plain(x, corr, dense_bias).float()
    s, sq = x.sum(0), (x * x).sum(0)
    return (s, sq) if channels is None else bn_channel_stats_plain((s, sq), channels)


def bn_channel_stats_plain(sums: Optional[tuple[torch.Tensor, torch.Tensor]], ch: BnChannels) -> torch.Tensor:
    """The statistics' end, torch ops on C floats (``csrc/batchnorm.cu``'s
    ``stats_end`` gives their bits on the card): from the sums (s, sq) (f32,
    or f64 after a data-parallel all-reduce, rounded to f32 first) ``mean =
    s / count``, ``var_raw = sq / count - mean^2``, ``var = clamp(var_raw,
    min=0)``, the running statistics moved in place to ``momentum * running
    + (1 - momentum) * batch`` when ``ch.update``, ``inv = rsqrt(var +
    eps)``, ``mul = inv * weight``. With ``sums`` None (eval): mean the
    running mean, mul and inv from the running variance, var_raw 0. Returns
    (4, C) f32: mean, mul, inv, var_raw."""
    if sums is None:
        mean, var_raw = ch.running_mean, torch.zeros_like(ch.running_var)
        inv = torch.rsqrt(ch.running_var + ch.eps)
    else:
        s, sq = sums[0].float(), sums[1].float()
        mean = s / ch.count
        var_raw = sq / ch.count - mean * mean
        var = torch.clamp(var_raw, min=0.0)
        if ch.update:
            ch.running_mean.copy_(ch.momentum * ch.running_mean + (1 - ch.momentum) * mean)
            ch.running_var.copy_(ch.momentum * ch.running_var + (1 - ch.momentum) * var)
        inv = torch.rsqrt(var + ch.eps)
    return torch.stack([mean, inv * ch.weight, inv, var_raw])


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
                   pool: int = 0, eval_var: Optional[torch.Tensor] = None, eps: float = 1e-5):
    """Stage 2: ``((x - mean) * mul) + bias`` in f32, rounded to ``dtype``,
    then ``torch.relu`` where ``relu``; x through the prologue. With
    ``eval_var`` (eval: ``mean`` the running mean, ``mul`` the BN weight)
    ``mul = rsqrt(eval_var + eps) * weight`` first. With ``pool`` = S:
    ``torch.amax`` over each unit of S rows and the int32 count of the rows
    equal to it, each (R / S, C)."""
    if eval_var is not None:
        mul = torch.rsqrt(eval_var + eps) * mul
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
                        pooled: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
                        coefficients: Optional[BnCoefficients] = None):
    """Stage 3: per-channel ``sum(g)`` and ``sum(g * (x - mean))``, g the
    masked cotangent; x through the prologue; with ``pooled = (ymax,
    count)``, dy is the pooled cotangent (R / S, C). With ``coefficients``
    the coefficients' end (:func:`bn_channel_coefficients_plain`) of them."""
    x = layer_rows_plain(x, corr, dense_bias)
    g = _masked(x, dy, mean, mul, bias, relu, pooled)
    sums = g.sum(0), (g * (x.float() - mean)).sum(0)
    return sums if coefficients is None else bn_channel_coefficients_plain(sums, coefficients)


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       a: Optional[torch.Tensor], b: Optional[torch.Tensor], relu: bool,
                       corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                       pooled: Optional[tuple[torch.Tensor, torch.Tensor]] = None, sums: bool = False):
    """Stage 4: ``((g * mul) + a) + (b * x)`` (``g * mul`` without a and b:
    eval) in x's dtype; x, g as in :func:`bn_bwd_reduce_plain`. With
    ``sums`` also the prologue's cotangents, (dx, d_corr, d_dense_bias):
    :func:`prologue_cotangents_plain`."""
    h = x
    x = layer_rows_plain(x, corr, dense_bias)
    g = _masked(x, dy, mean, mul, bias, relu, pooled)
    dx = g * mul if a is None else (g * mul + a) + b * x.float()
    dx = dx.to(x.dtype)
    return (dx, *prologue_cotangents_plain(dx, h.shape[0] // corr.shape[0] if corr is not None else 1,
                                           corr is not None, dense_bias is not None)) if sums else dx


def prologue_cotangents_plain(dx: torch.Tensor, S: int, centre: bool, bias: bool):
    """The prologue's cotangents from dx (R, C): corr's ``-sum(dx)`` over each
    unit of S rows (None unless ``centre``) and the dense bias's ``sum(dx)``
    over the rows (None unless ``bias``), each summed in f64 and rounded once
    to dx's dtype, the dense bias's held in f32."""
    d = dx.double()
    d_corr = (-d).view(-1, S, d.shape[-1]).sum(1).to(dx.dtype) if centre else None
    d_bias = d.sum(0).to(dx.dtype).float() if bias else None
    return d_corr, d_bias


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (R, C) view of x; on the card a view or an error, never a copy."""
    return x.view(-1, x.shape[-1]) if x.is_cuda else x.reshape(-1, x.shape[-1])


def _stages(x: torch.Tensor):
    """(stats, channels, apply, bwd_reduce, bwd_apply) for x's device. Looked
    up at each call, so that a test can substitute a stage."""
    if kernel_route(x, "batch_norm_relu") == "cuda":
        return bn_stats_cuda, bn_channels_cuda, bn_apply_cuda, bn_bwd_reduce_cuda, bn_bwd_apply_cuda
    return bn_stats_plain, bn_channel_stats_plain, bn_apply_plain, bn_bwd_reduce_plain, bn_bwd_apply_plain


def bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, weight, var_raw, count: int):
    """The per-channel ``a``, ``b`` of ``dx = g * mul + a + b * x`` in
    training: autograd of ``mean = s / count``, ``var_raw = sq / count -
    mean^2``, ``var = clamp(var_raw, min=0)``, ``inv = rsqrt(var + eps)``,
    ``mul = inv * weight``, ``y = (x - mean) * mul + bias`` given the
    stage-3 sums ``sum_g`` (the cotangent of bias) and ``sum_gx`` (of mul).
    ``a`` is the cotangent of ``s = sum(x)``, ``b`` twice that of ``sq =
    sum(x * x)`` (a data-parallel group sums both over its ranks)."""
    d_var = (sum_gx * weight) * (-0.5 * inv.pow(3))  # through mul and rsqrt
    d_var = torch.where(var_raw < 0, 0.0, d_var)  # torch.clamp(min=0)'s rule
    d_mean = -(mul * sum_g) - 2.0 * mean * d_var
    d_s, d_sq = d_mean / count, d_var / count
    return d_s, 2.0 * d_sq


def bn_channel_coefficients_plain(sums: tuple[torch.Tensor, torch.Tensor], co: BnCoefficients) -> torch.Tensor:
    """The coefficients' end, torch ops on C floats (``csrc/batchnorm.cu``'s
    ``coef_end`` gives their bits on the card): from stage 3's sums
    (``sum_g``, ``sum_gx``) and the statistics' end's (4, C) output, (4, C)
    f32: a and b (:func:`bn_input_coefficients`; zeros in eval), the BN
    weight's cotangent ``sum_gx * inv`` and the BN bias's ``sum_g``."""
    sum_g, sum_gx = sums
    mean, mul, inv, var_raw = co.st
    if co.training:
        a, b = bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, co.weight, var_raw, co.count)
    else:
        a = b = torch.zeros_like(sum_g)
    return torch.stack([a, b, sum_gx * inv, sum_g])


class _BatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, corr, dense_bias, weight, bias, running, training, momentum, eps, group, update_stats, dtype,
                relu, pool):
        stats, channels, apply, _, _ = _stages(h)
        rows = _rows(h)
        C = h.shape[-1]
        if dense_bias is not None and dense_bias.dtype != torch.float32:
            dense_bias = dense_bias.float()  # the stages take the f32 bias and round it to h's dtype
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias)
        running_mean, running_var = running
        count = rows.shape[0] * comm.size(group)
        st = None
        if training:
            ch = BnChannels(count, weight, eps, momentum, running_mean, running_var, update_stats)
            if group is None:
                st = stats(rows, **pro, channels=ch)  # the statistics' end at the end of stage 1
            else:  # in f64: the group's sums as one process's, then the end alone
                s, sq = stats(rows, **pro)
                st = channels(comm.all_reduce(torch.cat([s, sq]).double(), group).chunk(2), ch)
            avec = dict(mean=st[0], mul=st[1])
        else:  # stage 2 forms mul from the running statistics
            avec = dict(mean=running_mean, mul=weight, eval_var=running_var, eps=eps)
        ymax = slots = None
        if pool:
            ymax, slots = apply(rows, bias=bias, dtype=dtype, relu=relu, **avec, **pro, pool=h.shape[-2])
            y = ymax.view(*h.shape[:-2], C)
        else:
            y = apply(rows, bias=bias, dtype=dtype, relu=relu, **avec, **pro).view(h.shape)
        eval_stats = (None, None) if training else (running_mean, running_var)  # read by an eval backward
        ctx.save_for_backward(h, corr, dense_bias, weight, bias, st, *eval_stats, ymax, slots)
        ctx.count, ctx.group, ctx.relu, ctx.eps, ctx.momentum = count, group, relu, eps, momentum
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        h, corr, dense_bias, weight, bias, st, running_mean, running_var, ymax, slots = ctx.saved_tensors
        _, channels, _, bwd_reduce, bwd_apply = _stages(h)
        training = st is not None
        if not training:  # eval: the statistics from the running ones, as stage 2 formed them
            st = channels(None, BnChannels(ctx.count, weight, ctx.eps, ctx.momentum, running_mean, running_var,
                                           False))
        mean, mul = st[0], st[1]
        rows, dy_rows = _rows(h), _rows(dy.contiguous())
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias,
                   pooled=None if ymax is None else (ymax, slots))
        co = bwd_reduce(rows, dy_rows, mean, mul, bias, ctx.relu, **pro,
                        coefficients=BnCoefficients(st, weight, ctx.count, training))
        a = b = None
        if training:
            a, b = co[0], co[1]
            if ctx.group is not None:  # the sums' cotangents over the group (b: twice sq's, doubling commutes)
                a, b = comm.all_reduce(co[:2].reshape(-1), ctx.group).chunk(2)
        d_h = d_corr = d_bias = None
        need_h, need_corr, need_bias = ctx.needs_input_grad[:3]
        if need_h or need_corr or need_bias:
            sums = (corr is not None and need_corr) or (dense_bias is not None and need_bias)
            out = bwd_apply(rows, dy_rows, mean, mul, bias, a, b, ctx.relu, **pro, sums=sums)
            dx, d_corr, d_bias = out if sums else (out, None, None)
            d_h = dx.view(h.shape) if need_h else None
            d_corr = d_corr.view(corr.shape) if d_corr is not None and need_corr else None
            d_bias = d_bias if need_bias else None
        return (d_h, d_corr, d_bias, co[2], co[3]) + (None,) * 9


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
    (C,); ``corr`` in h's dtype; ``dense_bias`` f32 (the layer's own,
    rounded to h's dtype inside the op, its cotangent returned in f32 as
    autograd's cast gives it) or h's dtype; the running statistics move in
    place in training unless ``update_stats`` is False. See the module
    docstring. On a CUDA tensor each stage is one kernel launch; the tensors
    must be contiguous there."""
    if corr is not None and (h.dim() < 2 or corr.shape != h.shape[:-2] + h.shape[-1:]):
        raise ValueError(f"batch_norm_relu: corr {tuple(corr.shape)} against h {tuple(h.shape)}: (..., S, C) "
                         f"takes (..., C)")
    if pool not in (None, "max") or (pool and h.dim() < 2):
        raise ValueError(f"batch_norm_relu: pool must be None or 'max' over the axis -2 of h, got {pool!r}")
    if corr is not None and corr.dtype != h.dtype:
        raise ValueError(f"batch_norm_relu: corr is {corr.dtype}, h {h.dtype}")
    if dense_bias is not None and dense_bias.dtype not in (torch.float32, h.dtype):
        raise ValueError(f"batch_norm_relu: dense_bias is {dense_bias.dtype}: float32 or h's {h.dtype}")
    return _BatchNormReLU.apply(h, corr, dense_bias, weight, bias, (running_mean, running_var), training, momentum,
                                eps, group, update_stats, dtype or h.dtype, relu, pool == "max")
