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
to h's dtype, as the eager ops round; or, at mixed precision's and
bf16_hilo's split first layer, the split prologue ``x = (T(dot3(xyz, W3) -
dot3(centre, W3)) + h) + T(dense_bias)``: h the features' product, the
coordinates' f32 term formed in the stage and never stored, dot3 ``(p0 *
w0 + p1 * w1) + p2 * w2`` with each operation one f32 rounding). Each stage runs a hand-written CUDA
kernel for a CUDA tensor (``ops/cuda/batchnorm.py``, ``csrc/batchnorm.cu``)
and its plain PyTorch version below for a CPU tensor; anything else raises.
The per-channel arithmetic between the sums and the next stage (C floats:
:func:`bn_channel_stats_plain`, :func:`bn_channel_coefficients_plain`) runs
at the end of stages 1 and 3 on either device (inside the kernels on the
card, one torch op at a time on the CPU, the same bits on the card), under
a data-parallel group at the start of stage 2, and eval's ``mul`` inside
stages 2-4; so a site's training forward is two launches, its backward
two, an eval forward one, with or without a group.

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
  they are all-reduced in place between stages 1 and 2, in f64 (the
  kernel's sums are f64 until then, so that a split batch's statistics are
  the whole batch's), stage 2 runs the statistics' end from them, and the
  row count is this rank's times the group's size; in the backward
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
  as autograd's cast of an f32 bias to h's dtype gives it). At the split
  prologue W3's is ``sum_r (xyz_r - centre_u)[k] * dx_r[c]``, each term's
  difference and product in f64, summed in f64 and rounded once to f32;
  the coordinates' and the centres' (asked for by no path of the model)
  are autograd's of the f32 term, ``dx @ W3.T`` and ``-(sum over the
  unit's rows of dx) @ W3.T`` in f32. In training the
  dense bias's sum is 0 in exact arithmetic (batch norm takes out a shift):
  what it holds is the rounding of dx. Saved of the rows: h alone (the
  prologue, the mask and the pool's ties are recomputed from it), and at a
  pooled site the maxima and counts.
"""

from __future__ import annotations

from typing import Optional

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.batchnorm import (BnChannels, BnCoefficients, Coords, bn_apply_cuda,
                                                  bn_bwd_apply_cuda, bn_bwd_reduce_cuda, bn_stats_cuda)
from votenet_tpu_torch.parallel import comm


def dot3_plain(p: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """``(p0 * W3[0] + p1 * W3[1]) + p2 * W3[2]`` of f32 rows p (N, 3) and W3
    (3, C): (N, C) f32, each operation one torch op (one rounding, no
    FMA)."""
    return (p[:, 0:1] * w3[0] + p[:, 1:2] * w3[1]) + p[:, 2:3] * w3[2]


def coord_term_plain(coords: Coords, C: int) -> torch.Tensor:
    """The split prologue's f32 coordinate term of (R, C) rows: ``dot3(xyz_r,
    W3) - dot3(centre_u, W3)``, each unit of S rows taking its centre."""
    xyz, centre, w3 = coords
    a = dot3_plain(xyz, w3).view(centre.shape[0], -1, C)
    return (a - dot3_plain(centre, w3)[:, None, :]).view(-1, C)


def layer_rows_plain(h: torch.Tensor, corr: Optional[torch.Tensor] = None,
                     dense_bias: Optional[torch.Tensor] = None, coords: Optional[Coords] = None) -> torch.Tensor:
    """The prologue: x = ``(h - corr[unit]) + dense_bias`` of (R, C) rows h,
    each operation one torch op in h's dtype (rounded once), ``corr`` (R / S,
    C) taken by each unit of S consecutive rows, the dense bias (f32 or h's
    dtype) cast to h's dtype; either term optional. With ``coords`` (in
    place of corr) the split prologue: x = ``(T(coordinate term) + h) +
    dense_bias`` (:func:`coord_term_plain`)."""
    x = h
    if coords is not None:
        x = coord_term_plain(coords, h.shape[-1]).to(h.dtype) + h
    if corr is not None:
        C = h.shape[-1]
        x = (h.reshape(corr.shape[0], -1, C) - corr[:, None, :]).reshape(-1, C)
    if dense_bias is not None:
        x = x + dense_bias.to(h.dtype)
    return x


def bn_stats_plain(x: torch.Tensor, corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                   channels: Optional[BnChannels] = None, coords: Optional[Coords] = None):
    """Stage 1: per-channel ``sum(x)`` and ``sum(x * x)`` of (R, C) rows, f32
    (2, C); x through the prologue (:func:`layer_rows_plain`). With
    ``channels`` the statistics' end (:func:`bn_channel_stats_plain`) of
    them."""
    x = layer_rows_plain(x, corr, dense_bias, coords).float()
    sums = torch.stack([x.sum(0), (x * x).sum(0)])
    return sums if channels is None else bn_channel_stats_plain(sums, channels)


def bn_channel_stats_plain(sums, ch: BnChannels) -> torch.Tensor:
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


def _eval_mul(mul, eval_var, eps):
    """Eval's ``mul = rsqrt(eval_var + eps) * weight`` (``mul`` the BN
    weight), or ``mul`` itself without ``eval_var``."""
    return mul if eval_var is None else torch.rsqrt(eval_var + eps) * mul


def bn_apply_plain(x: torch.Tensor, mean: Optional[torch.Tensor], mul: Optional[torch.Tensor], bias: torch.Tensor,
                   dtype: torch.dtype, relu: bool, corr: Optional[torch.Tensor] = None,
                   dense_bias: Optional[torch.Tensor] = None, pool: int = 0, eval_var: Optional[torch.Tensor] = None,
                   eps: float = 1e-5, group_sums: Optional[torch.Tensor] = None,
                   channels: Optional[BnChannels] = None, coords: Optional[Coords] = None):
    """Stage 2: ``((x - mean) * mul) + bias`` in f32, rounded to ``dtype``,
    then ``torch.relu`` where ``relu``; x through the prologue. With
    ``eval_var`` (eval: ``mean`` the running mean, ``mul`` the BN weight)
    ``mul = rsqrt(eval_var + eps) * weight`` first. With ``group_sums`` (a
    data-parallel group's all-reduced stage-1 sums, (2, C)) and
    ``channels`` in place of mean and mul (None), the statistics' end
    (:func:`bn_channel_stats_plain`) first, and returns (y, st). With
    ``pool`` = S: ``torch.amax`` over each unit of S rows and the int32
    count of the rows equal to it, each (R / S, C), in place of y."""
    st = None
    if group_sums is not None:
        st = bn_channel_stats_plain(group_sums, channels)
        mean, mul = st[0], st[1]
    y = _normalized(layer_rows_plain(x, corr, dense_bias, coords), mean, _eval_mul(mul, eval_var, eps), bias, dtype)
    y = torch.relu(y) if relu else y
    out = _max_pool(y, pool) if pool else y
    return out if st is None else (out, st)


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
                        coefficients: Optional[BnCoefficients] = None, eval_var: Optional[torch.Tensor] = None,
                        eps: float = 1e-5, coords: Optional[Coords] = None):
    """Stage 3: per-channel ``sum(g)`` and ``sum(g * (x - mean))``, g the
    masked cotangent; x through the prologue; mean, mul and ``eval_var`` as
    in :func:`bn_apply_plain`; with ``pooled = (ymax, count)``, dy is the
    pooled cotangent (R / S, C). With ``coefficients`` the coefficients' end
    (:func:`bn_channel_coefficients_plain`) of them; in eval without
    ``coefficients.st``, inv is ``rsqrt(eval_var + eps)``."""
    x = layer_rows_plain(x, corr, dense_bias, coords)
    g = _masked(x, dy, mean, _eval_mul(mul, eval_var, eps), bias, relu, pooled)
    sums = g.sum(0), (g * (x.float() - mean)).sum(0)
    if coefficients is None:
        return sums
    inv = torch.rsqrt(eval_var + eps) if coefficients.st is None else None
    return bn_channel_coefficients_plain(sums, coefficients, inv)


def bn_bwd_apply_plain(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       a: Optional[torch.Tensor], b: Optional[torch.Tensor], relu: bool,
                       corr: Optional[torch.Tensor] = None, dense_bias: Optional[torch.Tensor] = None,
                       pooled: Optional[tuple[torch.Tensor, torch.Tensor]] = None, sums: bool = False,
                       eval_var: Optional[torch.Tensor] = None, eps: float = 1e-5, coords: Optional[Coords] = None):
    """Stage 4: ``((g * mul) + a) + (b * x)`` (``g * mul`` without a and b:
    eval) in x's dtype; x, g, mul and ``eval_var`` as in
    :func:`bn_bwd_reduce_plain`. With ``sums`` also the prologue's
    cotangents, (dx, d_corr, d_dense_bias): :func:`prologue_cotangents_plain`;
    with ``coords`` always, and W3's beside them: (dx, None, d_dense_bias,
    d_w3)."""
    h = x
    x = layer_rows_plain(x, corr, dense_bias, coords)
    mul = _eval_mul(mul, eval_var, eps)
    g = _masked(x, dy, mean, mul, bias, relu, pooled)
    dx = g * mul if a is None else (g * mul + a) + b * x.float()
    dx = dx.to(x.dtype)
    if not (sums or coords is not None):
        return dx
    S = h.shape[0] // (corr if corr is not None else coords.centre if coords is not None else h).shape[0]
    out = prologue_cotangents_plain(dx, S, corr is not None, dense_bias is not None, coords)
    return (dx, *out) if coords is not None else (dx, *out[:2])


def prologue_cotangents_plain(dx: torch.Tensor, S: int, centre: bool, bias: bool, coords: Optional[Coords] = None):
    """The prologue's cotangents from dx (R, C): corr's ``-sum(dx)`` over each
    unit of S rows (None unless ``centre``) and the dense bias's ``sum(dx)``
    over the rows (None unless ``bias``), each summed in f64 and rounded once
    to dx's dtype, the dense bias's held in f32; and W3's (None without
    ``coords``), ``sum_r (xyz_r - centre_u)[k] * dx_r[c]``, each difference
    and product in f64, summed in f64 and rounded once to f32 (3, C)."""
    d = dx.double()
    d_corr = (-d).view(-1, S, d.shape[-1]).sum(1).to(dx.dtype) if centre else None
    d_bias = d.sum(0).to(dx.dtype).float() if bias else None
    d_w3 = None
    if coords is not None:
        diff = (coords.xyz.double().view(-1, S, 3) - coords.centre.double()[:, None, :]).view(-1, 3)
        d_w3 = (diff.t() @ d).float()  # products of f32 and dx's values: exact in f64
    return d_corr, d_bias, d_w3


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (R, C) view of x; on the card a view or an error, never a copy."""
    return x.view(-1, x.shape[-1]) if x.is_cuda else x.reshape(-1, x.shape[-1])


def _stages(x: torch.Tensor):
    """(stats, apply, bwd_reduce, bwd_apply) for x's device. Looked up at each
    call, so that a test can substitute a stage."""
    if kernel_route(x, "batch_norm_relu") == "cuda":
        return bn_stats_cuda, bn_apply_cuda, bn_bwd_reduce_cuda, bn_bwd_apply_cuda
    return bn_stats_plain, bn_apply_plain, bn_bwd_reduce_plain, bn_bwd_apply_plain


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


def bn_channel_coefficients_plain(sums: tuple[torch.Tensor, torch.Tensor], co: BnCoefficients,
                                  inv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The coefficients' end, torch ops on C floats (``csrc/batchnorm.cu``'s
    ``coef_end`` gives their bits on the card): from stage 3's sums
    (``sum_g``, ``sum_gx``) and the statistics' end's (4, C) output (in eval
    ``inv`` in its place where ``co.st`` is None), (4, C) f32: a and b
    (:func:`bn_input_coefficients`; zeros in eval), the BN weight's
    cotangent ``sum_gx * inv`` and the BN bias's ``sum_g``."""
    sum_g, sum_gx = sums
    if co.st is not None:
        inv = co.st[2]
    if co.training:
        mean, mul, _, var_raw = co.st
        a, b = bn_input_coefficients(sum_g, sum_gx, mean, mul, inv, co.weight, var_raw, co.count)
    else:
        a = b = torch.zeros_like(sum_g)
    return torch.stack([a, b, sum_gx * inv, sum_g])


class _BatchNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, corr, dense_bias, xyz, centre, w3, weight, bias, running, training, momentum, eps, group,
                update_stats, dtype, relu, pool):
        stats, apply, _, _ = _stages(h)
        rows = _rows(h)
        C = h.shape[-1]
        if dense_bias is not None and dense_bias.dtype != torch.float32:
            dense_bias = dense_bias.float()  # the stages take the f32 bias and round it to h's dtype
        coords = None if xyz is None else Coords(_rows(xyz), _rows(centre), w3)
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias, coords=coords)
        at = dict(pro, pool=h.shape[-2]) if pool else pro  # stage 2's
        running_mean, running_var = running
        count = rows.shape[0] * comm.size(group)
        st = None
        if training:
            ch = BnChannels(count, weight, eps, momentum, running_mean, running_var, update_stats)
            if group is None:
                st = stats(rows, **pro, channels=ch)  # the statistics' end at the end of stage 1
                out = apply(rows, st[0], st[1], bias, dtype, relu, **at)
            else:  # in f64: the group's sums as one process's, summed in place; stage 2 runs the end
                sums = stats(rows, **pro).double()
                comm.all_reduce_([sums], group)
                out, st = apply(rows, None, None, bias, dtype, relu, **at, group_sums=sums, channels=ch)
        else:  # stage 2 forms mul from the running statistics
            out = apply(rows, running_mean, weight, bias, dtype, relu, **at, eval_var=running_var, eps=eps)
        ymax, slots = out if pool else (None, None)
        y = ymax.view(*h.shape[:-2], C) if pool else out.view(h.shape)
        eval_stats = (None, None) if training else (running_mean, running_var)  # read by an eval backward
        ctx.save_for_backward(h, corr, dense_bias, xyz, centre, w3, weight, bias, st, *eval_stats, ymax, slots)
        ctx.count, ctx.group, ctx.relu, ctx.eps = count, group, relu, eps
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        h, corr, dense_bias, xyz, centre, w3, weight, bias, st, running_mean, eval_var, ymax, slots = ctx.saved_tensors
        _, _, bwd_reduce, bwd_apply = _stages(h)
        training = st is not None
        # eval: the stages form mul from the running statistics, as stage 2 did
        mean, mul = (st[0], st[1]) if training else (running_mean, weight)
        rows, dy_rows = _rows(h), _rows(dy.contiguous())
        coords = None if xyz is None else Coords(_rows(xyz), _rows(centre), w3)
        pro = dict(corr=None if corr is None else _rows(corr), dense_bias=dense_bias,
                   pooled=None if ymax is None else (ymax, slots), eval_var=eval_var, eps=ctx.eps, coords=coords)
        co = bwd_reduce(rows, dy_rows, mean, mul, bias, ctx.relu, **pro,
                        coefficients=BnCoefficients(st, weight, ctx.count, training))
        a = b = None
        if training:
            # the sums' cotangents over the group, in place (b: twice sq's, doubling commutes)
            comm.all_reduce_([co[:2]], ctx.group)
            a, b = co[0], co[1]
        d_h = d_corr = d_bias = d_xyz = d_centre = d_w3 = None
        need_h, need_corr, need_bias, need_xyz, need_centre, need_w3 = ctx.needs_input_grad[:6]
        if need_h or need_corr or need_bias or need_xyz or need_centre or need_w3:
            sums = (corr is not None and need_corr) or (dense_bias is not None and need_bias)
            out = bwd_apply(rows, dy_rows, mean, mul, bias, a, b, ctx.relu, **pro, sums=sums)
            if coords is not None:  # the split prologue's K4 writes the sums always
                dx, _, d_bias, d_w3 = out
            else:
                dx, d_corr, d_bias = out if sums else (out, None, None)
            d_h = dx.view(h.shape) if need_h else None
            d_corr = d_corr.view(corr.shape) if d_corr is not None and need_corr else None
            d_bias = d_bias if need_bias else None
            d_w3 = d_w3 if need_w3 else None
            if need_xyz or need_centre:  # autograd's of the f32 coordinate term (no path of the model asks)
                d_rows = dx.float() @ w3.t()
                d_xyz = d_rows.view(xyz.shape) if need_xyz else None
                if need_centre:
                    unit_sums = dx.float().view(coords.centre.shape[0], -1, dx.shape[-1]).sum(1)
                    d_centre = (-unit_sums @ w3.t()).view(centre.shape)
        return (d_h, d_corr, d_bias, d_xyz, d_centre, d_w3, co[2], co[3]) + (None,) * 9


def batch_norm_relu(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, *, training: bool, momentum: float = 0.9, eps: float = 1e-5,
                    group: comm.Group = None, update_stats: bool = True, dtype: Optional[torch.dtype] = None,
                    relu: bool = True, dense_bias: Optional[torch.Tensor] = None, corr: Optional[torch.Tensor] = None,
                    pool: Optional[str] = None, coords: Optional[tuple] = None) -> torch.Tensor:
    """Batch norm over the last axis of x (..., C), then the ReLU where
    ``relu``, as one autograd op; the output in ``dtype`` (h's by default).
    x is the dense layer's output h with the layer's prologue: ``x = (h -
    corr[..., None, :]) + dense_bias`` in h's dtype (the centred first
    layer, h (..., S, C) and ``corr`` (..., C), each unit of S rows taking
    its row of corr), or ``h + dense_bias``, or h itself; x is never stored.
    ``coords = (xyz, centre, W3)`` (in place of corr: the split first layer,
    xyz (..., S, 3) and centre (..., 3) f32, W3 (3, C) f32, any strides)
    makes x ``(T(dot3(xyz, W3) - dot3(centre, W3)) + h) + dense_bias``, the
    output in h's dtype, no pool. ``pool="max"`` takes ``torch.amax`` over
    the S axis (-2) of the output,
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
    xyz = centre = w3 = None
    if coords is not None:
        xyz, centre, w3 = coords
        if (corr is not None or pool or h.dim() < 2 or xyz.shape != h.shape[:-1] + (3,)
                or centre.shape != h.shape[:-2] + (3,) or w3.shape != (3, h.shape[-1])
                or (dtype is not None and dtype != h.dtype)
                or any(t.dtype != torch.float32 for t in (xyz, centre, w3))):
            raise ValueError(f"batch_norm_relu: coords xyz {tuple(xyz.shape)}, centre {tuple(centre.shape)}, W3 "
                             f"{tuple(w3.shape)} against h {tuple(h.shape)}: f32 (..., S, 3), (..., 3), (3, C); "
                             f"no corr, no pool, the output in h's dtype")
    return _BatchNormReLU.apply(h, corr, dense_bias, xyz, centre, w3, weight, bias, (running_mean, running_var),
                                training, momentum, eps, group, update_stats, dtype or h.dtype, relu, pool == "max")
