"""Batch norm + ReLU with the layer around it: the CUDA kernels' wrappers
and their launch plan.

Kernels: ``votenet_tpu_torch/csrc/batchnorm.cu``, the port's own (the JAX
package runs flax ``nn.Dense``/``CenteredDense``, ``nn.BatchNorm``,
``nn.relu`` and ``jnp.max`` in XLA, ``votenet_tpu/models/pointnet2.py:95-103,
166-174, 540-541``, and reaches no Pallas kernel). Each takes the
channels-last (R, C) view of the dense layer's output h, f32 or bf16, the
prologue that makes x of it (``corr``: R / S rows subtracted from each unit
of S rows, the centred first layer's; ``dense_bias``: C added), and
per-channel f32 vectors; see the note at the top of the source. Their plain
versions are the stages of ``ops/batchnorm.py``, which chains them into one
autograd op.

The per-channel end runs inside the kernels: K1's last CTA turns its sums
into the statistics and moves the running statistics (``channels=``), K3's
into the backward's coefficients (``coefficients=``), K2, K3 and K4 form
eval's mul from the running statistics (``eval_var=``), K2 runs the
statistics' end from a data-parallel group's all-reduced sums
(``group_sums=``, ``channels=``), and K4 writes the prologue's cotangents
(``sums=True``).

Each wrapper checks what its kernel takes (contiguous CUDA tensors on one
device: a non-contiguous one raises, it is not copied), allocates its
outputs and workspace, launches on the current stream, raises on a launch
error, and adds one to its count: ``.launches`` for the kernel over full
rows, ``bn_apply_cuda.pool.launches`` for K2's pool variant and
``bn_bwd_*_cuda.pooled.launches`` for K3 and K4 at a pooled site,
``bn_bwd_apply_cuda.sums.launches`` for a K4 launch that wrote the
prologue's cotangents (either variant), ``bn_apply_cuda.group.launches``
for a K2 launch that ran the statistics' end (either variant); a launch
with a prologue also adds one to ``PROLOGUE_LAUNCHES["centre"]``
(corr given) or ``["bias"]`` (the dense bias alone). Given a tensor that is
not on a CUDA device it raises; it never computes the plain version.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace
from typing import NamedTuple, Optional

import numpy as np
import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda, sm_count

BN_THREADS = 256  # a CTA's threads (csrc/batchnorm.cu kThreads)
# Rows a thread takes at least before the plan adds CTAs: two batches of
# the rows whose loads the kernels keep in flight (kRows, kPairRows)
BN_MIN_ROWS = 8
# CTAs an SM along the rows over all channel tiles, all resident at once, by
# the plan's kind: each kernel is compiled to the register cap that keeps
# that many resident (csrc/batchnorm.cu kCtas*, which
# tests/test_torch_bn_layer.py holds equal to these). 4 x 256 threads keep
# ~64 KB a SM in flight (kRows rows of one tensor or kPairRows of two),
# enough for the memory rate; the reductions' end adds ~sqrt(CTAs) partials
# a channel at each of its two levels, so more CTAs cost it little. Kinds:
# "reduce" K1; "reduce_dy" K3 over a full dy, which reads two streams a row
# and runs best at 2 with 4 rows of each in flight (H100: at 1048576 x 128,
# 359 against 384 us at 4 CTAs an SM); "reduce_pooled" K3 at a pooled site,
# whose per-unit share needs more registers than 4 CTAs leave (at 4 it
# spills: 780 against 688 us over a B=8 step's 5 pooled sites in f32, 784
# against 797 in bf16); "reduce_pooled_wide" the pooled K3 in bf16 with 8
# channels a lane (16 f64 accumulators a thread); "reduce_dx" K4 with the
# epilogue (the prologue's cotangents: an f64 accumulator a channel, two at
# a centred site, and the dense bias's tree); "apply" K2, its f32 pool
# variant and K4 without the epilogue (K4 at a pooled site: 702 us at 4
# against 820 at 3 in bf16, equal in f32); "apply_wide" K2's pool variant in
# bf16 with 8 channels a lane (spills at 4).
BN_CTAS_PER_SM = {"reduce": 4, "reduce_dy": 2, "reduce_pooled": 3, "reduce_pooled_wide": 2, "reduce_dx": 3,
                  "apply": 4, "apply_wide": 3}
BN_DTYPES = (torch.float32, torch.bfloat16)
# launches that took a prologue, over the four stages: "centre" (corr and
# the dense bias: the centred first layer), "bias" (the dense bias alone)
PROLOGUE_LAUNCHES = {"centre": SimpleNamespace(launches=0), "bias": SimpleNamespace(launches=0)}


@functools.lru_cache(maxsize=4096)  # a pure function of its arguments, called at every launch
def bn_plan(R: int, C: int, vec: bool, sms: int, kind: str, S: int = 1,
            width: int = 4) -> tuple[int, int, int, int, int]:
    """The launch of a kernel over R rows of C channels in units of S rows:
    (W lanes a CTA, CTAs along the units, channel tiles, units a CTA, the
    reduction's fan-in). A lane holds ``width`` channels (4, or 8 in the
    bf16 pool kernels) with ``vec``, else 1; a CTA
    holds min(lanes, BN_THREADS) lanes and BN_THREADS // W row groups, each
    of which takes whole units. Along the units, enough CTAs that each
    thread takes ``BN_MIN_ROWS`` rows or more (a unit at least), at most
    ``BN_CTAS_PER_SM[kind] * sms`` over all tiles (the kinds are listed
    there). A reduction adds its CTAs' partials in blocks of ``fan_in =
    ceil(sqrt(CTAs))`` consecutive CTAs, then the blocks' sums (0 for the
    apply kernels). No rows: one CTA a channel tile, which takes none (a
    kernel's per-channel end alone). Depends on the shape and the SM count
    alone, so a reduction's order is the same in every run on one card."""
    if R % S:
        raise ValueError(f"bn_plan: {R} rows are not units of {S}")
    lanes = C // width if vec else C
    W = min(lanes, BN_THREADS)
    groups = BN_THREADS // W
    tiles = -(-lanes // W)
    units = R // S
    if units == 0:
        return W, 1, tiles, 1, 1 if kind.startswith("reduce") else 0
    min_units = -(-BN_MIN_ROWS // S)
    ctas = max(1, min(-(-units // (groups * min_units)), BN_CTAS_PER_SM[kind] * sms // tiles))
    per_cta = -(-units // ctas)
    ctas = -(-units // per_cta)
    return W, ctas, tiles, per_cta, math.isqrt(ctas - 1) + 1 if kind.startswith("reduce") else 0


def bn_reduce_levels(ctas: int, fan_in: int) -> int:
    """The blocks of a reduction's first level: ceil(ctas / fan_in)."""
    return -(-ctas // fan_in)


def _check_rows(name: str, t, C: int | None = None, dtype=None) -> None:
    """A contiguous (R, C) f32 or bf16 CUDA tensor (of ``dtype`` if given),
    R < 2^31 (the kernels' row indices are 32-bit)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise RuntimeError(f"{name}: the CUDA kernel needs a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if (t.dtype not in BN_DTYPES or t.dim() != 2 or not t.is_contiguous() or (C is not None and t.shape[1] != C)
            or (dtype is not None and t.dtype != dtype) or t.shape[0] >= 2 ** 31):
        raise ValueError(f"{name}: expected a contiguous {dtype or 'float32 or bfloat16'} (R, {C or 'C'}) tensor, "
                         f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_channels(name: str, device, C: int, **vectors) -> None:
    for what, v in vectors.items():
        require_cuda(f"{name} {what}", v, 1, C)
        if v.device != device:
            raise ValueError(f"{name}: {what} on {v.device}, x on {device}")


def _check_same_device(name: str, x, **tensors) -> None:
    for what, t in tensors.items():
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: {what} on {t.device}, x on {x.device}")


class BnChannels(NamedTuple):
    """The statistics' end's inputs (K1's and K2's ``channels=``,
    ``ops.batchnorm.bn_channel_stats_plain``): the row count (the group's),
    the BN weight, eps, the momentum and the running statistics (f32 (C,)),
    which move in place when ``update``."""
    count: int
    weight: torch.Tensor
    eps: float
    momentum: float
    running_mean: torch.Tensor
    running_var: torch.Tensor
    update: bool


class BnCoefficients(NamedTuple):
    """The coefficients' end's inputs (K3's ``coefficients=``,
    ``ops.batchnorm.bn_channel_coefficients_plain``): the statistics' end's
    (4, C) output (mean, mul, inv, var_raw; None in eval, where the end forms
    inv from the running variance), the BN weight, the row count (the
    group's) and whether a and b are wanted (training)."""
    st: torch.Tensor
    weight: torch.Tensor
    count: int
    training: bool


@functools.lru_cache(maxsize=1024)
def channel_scalars(count: int, eps: float, momentum: float) -> tuple[float, float, float, float]:
    """The f32 scalars of the per-channel end as torch's CUDA ops take them
    from Python numbers: 1 / count in f32 on the host (a division by a CPU
    scalar is a product with its reciprocal there), eps, momentum and
    ``1 - momentum`` (computed in double, then rounded)."""
    f32 = np.float32
    with np.errstate(divide="ignore"):  # no rows: inf, as torch's division by 0
        inv_count = f32(1.0) / f32(count)
    return float(inv_count), float(f32(eps)), float(f32(momentum)), float(f32(1 - momentum))


def _prologue(name: str, x, corr, dense_bias) -> int:
    """Check the prologue's tensors against x (R, C); returns S, the rows a
    unit (R / corr's rows; 1 without corr)."""
    R, C = x.shape
    S = 1
    if corr is not None:
        _check_rows(f"{name} corr", corr, C, x.dtype)
        if corr.shape[0] == 0 or R % corr.shape[0]:
            raise ValueError(f"{name}: corr {tuple(corr.shape)} does not divide x {tuple(x.shape)} into units")
        S = R // corr.shape[0]
    if dense_bias is not None:
        if (not isinstance(dense_bias, torch.Tensor) or dense_bias.dtype != torch.float32 or dense_bias.shape != (C,)
                or not dense_bias.is_contiguous()):
            raise ValueError(f"{name}: dense_bias must be a contiguous ({C},) float32 tensor")
    _check_same_device(name, x, corr=corr, dense_bias=dense_bias)
    return S


def _pooled(name: str, x, dy, pooled, S_pro: int) -> int:
    """Check a cotangent against x (R, C): a full (R, C) dy, or with
    ``pooled = (ymax, count)`` a (R / S, C) one beside the pool's maxima and
    int32 counts; returns S (the prologue's, when it has one)."""
    R, C = x.shape
    if pooled is None:
        _check_rows(f"{name} dy", dy, C)
        if dy.shape[0] != R:
            raise ValueError(f"{name}: dy {tuple(dy.shape)} against x {tuple(x.shape)}")
        _check_same_device(name, x, dy=dy)
        return S_pro
    ymax, count = pooled
    _check_rows(f"{name} dy", dy, C)
    _check_rows(f"{name} ymax", ymax, C, dy.dtype)
    if (not isinstance(count, torch.Tensor) or count.dtype != torch.int32 or count.shape != ymax.shape
            or not count.is_contiguous() or dy.shape != ymax.shape):
        raise ValueError(f"{name}: the pooled dy, ymax and int32 count must be contiguous {tuple(ymax.shape)}")
    if ymax.shape[0] == 0 or R % ymax.shape[0] or (S_pro != 1 and R // ymax.shape[0] != S_pro):
        raise ValueError(f"{name}: pooled {tuple(ymax.shape)} against x {tuple(x.shape)} in units of {S_pro}")
    _check_same_device(name, x, dy=dy, ymax=ymax, count=count)
    return R // ymax.shape[0]


def _vec(C: int, *tensors, width: int = 4) -> bool:
    """``width`` channels a lane: C % width == 0 and every row tensor aligned
    to ``width`` elements (the per-channel f32 vectors and the dense bias are
    read a channel at a time)."""
    return C % width == 0 and all(t.data_ptr() % (width * t.element_size()) == 0 for t in tensors if t is not None)


def _wide(x, out, *tensors) -> bool:
    """The bf16 pool kernels' 8 channels a lane: x and the output in bf16,
    C % 8 == 0, the rows 16-byte aligned."""
    return x.dtype == out.dtype == torch.bfloat16 and _vec(x.shape[1], x, out, *tensors, width=8)


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _count_prologue(corr, dense_bias) -> None:
    if corr is not None:
        PROLOGUE_LAUNCHES["centre"].launches += 1
    elif dense_bias is not None:
        PROLOGUE_LAUNCHES["bias"].launches += 1


# A stream's reduction tickets, (device index, stream) -> int32 zeros: the
# kernels leave them 0, so launches in one stream's order share them
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _stream_tickets(device, stream, n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < n:
        t = _tickets[key] = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    return t


def _tree(x, R: int, C: int, plan, n_sums: int):
    """A reduction's workspace (``n_sums`` x (CTAs + blocks) x C f64 partial
    sums) and the current stream's tickets for the plan's two levels."""
    _, ctas, tiles, _, fan_in = plan
    levels = bn_reduce_levels(ctas, fan_in)
    ws = torch.empty((n_sums, ctas + levels, C), dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    return ws, _stream_tickets(x.device, stream, tiles * (levels + 1)), stream


def _channel_vectors(name: str, device, C: int, ch) -> None:
    _check_channels(name, device, C, weight=ch.weight, running_mean=ch.running_mean, running_var=ch.running_var)


def _stats_args(st, ch: Optional[BnChannels]) -> list:
    """K1's and K2's arguments of the statistics' end (nulls without one)."""
    if ch is None:
        return [None, None, None, None, 0, 0.0, 0.0, 0.0, 0.0]
    inv_count, eps, f_old, f_new = channel_scalars(ch.count, ch.eps, ch.momentum)
    return [st.data_ptr(), ch.weight.data_ptr(), ch.running_mean.data_ptr(), ch.running_var.data_ptr(),
            int(ch.update), inv_count, eps, f_old, f_new]


def bn_stats_cuda(x: torch.Tensor, corr: torch.Tensor | None = None, dense_bias: torch.Tensor | None = None,
                  channels: BnChannels | None = None):
    """K1: per-channel ``sum(x)`` and ``sum(x * x)``, (2, C) f64, x = ``(h -
    corr[unit]) + dense_bias`` in h's dtype (either term optional; the dense
    bias f32, rounded to h's dtype) of a contiguous (R, C) f32 or bf16 CUDA
    tensor h, added in f64 in the kernel's fixed order. With ``channels``
    the kernel's last CTA runs the statistics' end: returns (4, C) f32,
    mean, mul, inv and var_raw (``ops.batchnorm.bn_channel_stats_plain``'s
    bits on the card), and moves the running statistics in place when
    ``channels.update``; without rows, one CTA that takes none runs it on
    zero sums. Adds one to ``bn_stats_cuda.launches`` (none for the sums of
    no rows, which are zeros)."""
    _check_rows("bn_stats_cuda", x)
    R, C = x.shape
    S = _prologue("bn_stats_cuda", x, corr, dense_bias)
    if channels is not None:
        _channel_vectors("bn_stats_cuda", x.device, C, channels)
    if x.numel() == 0 and channels is None:
        return torch.zeros((2, C), dtype=torch.float64, device=x.device)
    vec = _vec(C, x, corr)
    plan = bn_plan(R, C, vec, sm_count(x.device.index), "reduce", S)
    W, ctas, tiles, per_cta, fan_in = plan
    ws, tickets, stream = _tree(x, R, C, plan, 2)
    sums = st = None
    if channels is None:
        sums = torch.empty((2, C), dtype=torch.float64, device=x.device)  # the last CTA of each tile writes them
    else:
        st = torch.empty((4, C), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = library().votenet_bn_stats(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, R, C, 4 if vec else 1, W, ctas, tiles, per_cta,
            fan_in, ws.data_ptr(), tickets.data_ptr(), _ptr(None if sums is None else sums[0]),
            _ptr(None if sums is None else sums[1]), *_stats_args(st, channels), stream.cuda_stream)
    check_launch(err, "bn_stats")
    bn_stats_cuda.launches += 1
    _count_prologue(corr, dense_bias)
    if channels is not None and channels.update:
        _moved(channels)
    return sums if channels is None else st


def _moved(channels: BnChannels) -> None:
    """Bump the autograd versions of the running statistics a kernel moved
    in place."""
    torch.autograd.graph.increment_version(channels.running_mean)
    torch.autograd.graph.increment_version(channels.running_var)


def bn_apply_cuda(x: torch.Tensor, mean: torch.Tensor | None, mul: torch.Tensor | None, bias: torch.Tensor,
                  dtype: torch.dtype, relu: bool, corr: torch.Tensor | None = None,
                  dense_bias: torch.Tensor | None = None, pool: int = 0, eval_var: torch.Tensor | None = None,
                  eps: float = 1e-5, group_sums: torch.Tensor | None = None, channels: BnChannels | None = None):
    """K2: ``y = ((x - mean) * mul) + bias`` rounded to ``dtype``, then the
    ReLU where ``relu``, x as in :func:`bn_stats_cuda`, the rest f32 (C,).
    With ``eval_var`` (eval: ``mean`` the running mean, ``mul`` the BN
    weight) the kernel forms ``mul = rsqrt(eval_var + eps) * weight`` itself.
    With ``group_sums`` (a data-parallel group's all-reduced K1 sums, (2, C)
    f64) and ``channels`` in place of mean and mul (None), every CTA runs the
    statistics' end on the sums (``ops.batchnorm.bn_channel_stats_plain``'s
    bits on the card) and the first along the rows writes it and moves the
    running statistics in place when ``channels.update``; returns (y, st),
    st the (4, C) f32 mean, mul, inv and var_raw (without rows, one CTA that
    takes none runs the end). With ``pool`` = S, the pool variant: each unit
    of S rows' max of y (torch.amax's) and the int32 count of its rows equal
    to it, each (R / S, C), in place of y; the full y is not written; in
    bf16 with C % 8 == 0, 8 channels a lane. Equal to
    ``ops.batchnorm.bn_apply_plain`` on the card. Adds one to
    ``bn_apply_cuda.launches`` (or ``.pool.launches``), and with the group's
    sums to ``bn_apply_cuda.group.launches``."""
    _check_rows("bn_apply_cuda", x)
    R, C = x.shape
    S = _prologue("bn_apply_cuda", x, corr, dense_bias)
    if (group_sums is None) != (channels is None) or (group_sums is None) == (mean is None or mul is None):
        raise ValueError("bn_apply_cuda: mean and mul, or group_sums and channels")
    if group_sums is None:
        _check_channels("bn_apply_cuda", x.device, C, mean=mean, mul=mul, bias=bias,
                        **({} if eval_var is None else dict(eval_var=eval_var)))
    else:
        if eval_var is not None:
            raise ValueError("bn_apply_cuda: eval_var takes no group sums (eval normalises by the running statistics)")
        _check_channels("bn_apply_cuda", x.device, C, bias=bias)
        _channel_vectors("bn_apply_cuda", x.device, C, channels)
        if (not isinstance(group_sums, torch.Tensor) or group_sums.dtype != torch.float64
                or group_sums.shape != (2, C) or not group_sums.is_contiguous() or group_sums.device != x.device):
            raise ValueError(f"bn_apply_cuda: group_sums must be a contiguous (2, {C}) float64 tensor on {x.device}")
    if dtype not in BN_DTYPES:
        raise ValueError(f"bn_apply_cuda: output dtype must be float32 or bfloat16, got {dtype}")
    if pool:
        if R % pool or (corr is not None and S != pool):
            raise ValueError(f"bn_apply_cuda: pool of {pool} rows against x {tuple(x.shape)} in units of {S}")
        S = pool
    y = torch.empty((R // S if pool else R, C), dtype=dtype, device=x.device)
    count = torch.empty((R // S, C), dtype=torch.int32, device=x.device) if pool else None
    out = (y, count) if pool else y
    st = None if channels is None else torch.empty((4, C), dtype=torch.float32, device=x.device)
    if x.numel() == 0 and st is None:
        return out
    wide = bool(pool) and _wide(x, y, corr, count)
    vec = wide or _vec(C, x, y, corr, count)
    W, ctas, tiles, per_cta, _ = bn_plan(R, C, vec, sm_count(x.device.index), "apply_wide" if wide else "apply", S,
                                         8 if wide else 4)
    with torch.cuda.device(x.device):
        err = library().votenet_bn_apply(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, y.data_ptr(), _bf16(y), _ptr(count), R, C,
            8 if wide else 4 if vec else 1, W, ctas, tiles, per_cta, _ptr(mean), _ptr(mul), bias.data_ptr(),
            _ptr(eval_var), float(eps), int(relu), _ptr(group_sums), *_stats_args(st, channels),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bn_apply_pool" if pool else "bn_apply")
    (bn_apply_cuda.pool if pool else bn_apply_cuda).launches += 1
    _count_prologue(corr, dense_bias)
    if st is None:
        return out
    bn_apply_cuda.group.launches += 1
    if channels.update:
        _moved(channels)
    return out, st


def bn_bwd_reduce_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       relu: bool, corr: torch.Tensor | None = None, dense_bias: torch.Tensor | None = None,
                       pooled: tuple[torch.Tensor, torch.Tensor] | None = None,
                       coefficients: BnCoefficients | None = None, eval_var: torch.Tensor | None = None,
                       eps: float = 1e-5):
    """K3: per-channel ``sum(g)`` and ``sum(g * (x - mean))`` (f32, (C,) each),
    x as in :func:`bn_stats_cuda`, g = dy with the ReLU's mask recomputed
    from x (zero where the pre-ReLU output, in dy's dtype, is <= 0); mean,
    mul and ``eval_var`` as in :func:`bn_apply_cuda`. dy is (R, C) f32 or
    bf16, or with ``pooled = (ymax, count)`` (K2's pool outputs) the pooled
    cotangent, (R / S, C), which each row takes as torch.amax's backward
    gives it (in bf16 with C % 8 == 0, 8 channels a lane). With
    ``coefficients`` the kernel's last CTA runs the coefficients' end:
    returns (4, C) f32, a and b (training only; else left unwritten), the
    BN weight's cotangent ``sum_gx * inv`` and the BN bias's ``sum_g``
    (``ops.batchnorm.bn_channel_coefficients_plain``'s bits on the card; in
    eval with ``coefficients.st`` None, inv is ``rsqrt(eval_var + eps)``).
    Adds one to ``bn_bwd_reduce_cuda.launches`` (or ``.pooled.launches``)."""
    _check_rows("bn_bwd_reduce_cuda", x)
    R, C = x.shape
    S = _pooled("bn_bwd_reduce_cuda", x, dy, pooled, _prologue("bn_bwd_reduce_cuda", x, corr, dense_bias))
    _check_channels("bn_bwd_reduce_cuda", x.device, C, mean=mean, mul=mul, bias=bias,
                    **({} if eval_var is None else dict(eval_var=eval_var)))
    co = None
    if coefficients is not None:
        _check_channels("bn_bwd_reduce_cuda", x.device, C, weight=coefficients.weight)
        st = coefficients.st
        if st is None:
            if coefficients.training or eval_var is None:
                raise ValueError("bn_bwd_reduce_cuda: coefficients without st need eval_var, and not training")
        elif st.dtype != torch.float32 or st.shape != (4, C) or not st.is_contiguous() or st.device != x.device:
            raise ValueError(f"bn_bwd_reduce_cuda: coefficients.st must be a contiguous (4, {C}) float32 tensor")
        co = torch.zeros((4, C), dtype=torch.float32, device=x.device) if x.numel() == 0 else \
            torch.empty((4, C), dtype=torch.float32, device=x.device)
    ymax, count = pooled if pooled is not None else (None, None)
    if x.numel() == 0:
        if co is not None:
            return co
        sums = torch.zeros((2, C), dtype=torch.float32, device=x.device)
        return sums[0], sums[1]
    sums = None if co is not None else torch.empty((2, C), dtype=torch.float32, device=x.device)
    wide = pooled is not None and _wide(x, dy, corr, ymax, count)
    vec = wide or _vec(C, x, dy, corr, ymax, count)
    kind = ("reduce_pooled_wide" if wide else "reduce_pooled") if pooled is not None else "reduce_dy"
    plan = bn_plan(R, C, vec, sm_count(x.device.index), kind, S, 8 if wide else 4)
    W, ctas, tiles, per_cta, fan_in = plan
    ws, tickets, stream = _tree(x, R, C, plan, 2)
    if coefficients is None:
        end = [None, None, 0.0, 0]
    else:
        end = [_ptr(coefficients.st), coefficients.weight.data_ptr(),
               channel_scalars(coefficients.count, 0.0, 0.0)[0], int(coefficients.training)]
    with torch.cuda.device(x.device):
        err = library().votenet_bn_bwd_reduce(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, dy.data_ptr(), _bf16(dy), _ptr(ymax),
            _ptr(count), R, C, 8 if wide else 4 if vec else 1, W, ctas, tiles, per_cta, fan_in, mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(), _ptr(eval_var), float(eps), int(relu), ws.data_ptr(), tickets.data_ptr(),
            _ptr(None if sums is None else sums[0]), _ptr(None if sums is None else sums[1]), _ptr(co), *end,
            stream.cuda_stream)
    check_launch(err, "bn_bwd_reduce")
    (bn_bwd_reduce_cuda.pooled if pooled is not None else bn_bwd_reduce_cuda).launches += 1
    _count_prologue(corr, dense_bias)
    return co if co is not None else (sums[0], sums[1])


def bn_bwd_apply_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                      a: torch.Tensor | None, b: torch.Tensor | None, relu: bool, corr: torch.Tensor | None = None,
                      dense_bias: torch.Tensor | None = None,
                      pooled: tuple[torch.Tensor, torch.Tensor] | None = None, sums: bool = False,
                      eval_var: torch.Tensor | None = None, eps: float = 1e-5):
    """K4: ``dx = ((g * mul) + a) + (b * x)`` (``g * mul`` where a and b are
    None: eval) in h's dtype, x and g as in :func:`bn_bwd_reduce_cuda`
    (dx is the cotangent of x, and so of h); mean, mul and ``eval_var`` as in
    :func:`bn_apply_cuda`. Equal to ``ops.batchnorm.bn_bwd_apply_plain`` on
    the card. With ``sums`` the epilogue, and returns (dx, d_corr,
    d_dense_bias): corr's cotangent ``-sum(dx)`` over each unit (corr's
    shape and dtype; None without corr) and the dense bias's ``sum(dx)``
    over the rows (f32 (C,) holding a value of h's dtype; None without a
    dense bias), each the f64 sum of the rounded dx values in the kernel's
    order rounded once. Adds one to ``bn_bwd_apply_cuda.launches`` (or
    ``.pooled.launches``), and with the epilogue to
    ``bn_bwd_apply_cuda.sums.launches``."""
    _check_rows("bn_bwd_apply_cuda", x)
    R, C = x.shape
    S = _pooled("bn_bwd_apply_cuda", x, dy, pooled, _prologue("bn_bwd_apply_cuda", x, corr, dense_bias))
    if (a is None) != (b is None):
        raise ValueError("bn_bwd_apply_cuda: a and b both or none")
    vectors = (dict(mean=mean, mul=mul, bias=bias) | ({} if a is None else dict(a=a, b=b))
               | ({} if eval_var is None else dict(eval_var=eval_var)))
    _check_channels("bn_bwd_apply_cuda", x.device, C, **vectors)
    ymax, count = pooled if pooled is not None else (None, None)
    dx = torch.empty_like(x)
    d_corr = torch.empty_like(corr) if sums and corr is not None else None
    d_bias = torch.empty(C, dtype=torch.float32, device=x.device) if sums and dense_bias is not None else None
    tree = d_bias is not None
    epi = 2 if d_corr is not None else int(tree)
    if x.numel() == 0:
        if d_bias is not None:
            d_bias.zero_()
        return (dx, d_corr, d_bias) if sums else dx
    vec = _vec(C, x, dy, dx, corr, ymax, count, d_corr)
    plan = bn_plan(R, C, vec, sm_count(x.device.index), "reduce_dx" if epi else "apply", S)
    W, ctas, tiles, per_cta, fan_in = plan
    ws, tickets, stream = _tree(x, R, C, plan, 1) if tree else (None, None, torch.cuda.current_stream(x.device))
    with torch.cuda.device(x.device):
        err = library().votenet_bn_bwd_apply(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, dy.data_ptr(), _bf16(dy), _ptr(ymax),
            _ptr(count), dx.data_ptr(), R, C, 4 if vec else 1, W, ctas, tiles, per_cta, mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(), _ptr(eval_var), float(eps), _ptr(a), _ptr(b), int(relu), epi,
            _ptr(d_corr), _ptr(d_bias), _ptr(ws), _ptr(tickets), fan_in, stream.cuda_stream)
    check_launch(err, "bn_bwd_apply")
    (bn_bwd_apply_cuda.pooled if pooled is not None else bn_bwd_apply_cuda).launches += 1
    if tree:
        bn_bwd_apply_cuda.sums.launches += 1
    _count_prologue(corr, dense_bias)
    return (dx, d_corr, d_bias) if sums else dx


bn_stats_cuda.launches = 0
bn_apply_cuda.launches = 0
bn_bwd_reduce_cuda.launches = 0
bn_bwd_apply_cuda.launches = 0
bn_apply_cuda.pool = SimpleNamespace(launches=0)  # the pool variant's own count
bn_apply_cuda.group = SimpleNamespace(launches=0)  # K2 launches that ran the statistics' end (either variant)
bn_bwd_reduce_cuda.pooled = SimpleNamespace(launches=0)  # at a pooled site
bn_bwd_apply_cuda.pooled = SimpleNamespace(launches=0)
bn_bwd_apply_cuda.sums = SimpleNamespace(launches=0)  # K4 launches that wrote the prologue's cotangents
