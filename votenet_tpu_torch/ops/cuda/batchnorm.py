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

Each wrapper checks what its kernel takes (contiguous CUDA tensors on one
device: a non-contiguous one raises, it is not copied), allocates its
outputs and workspace, launches on the current stream, raises on a launch
error, and adds one to its count: ``.launches`` for the kernel over full
rows, ``bn_apply_cuda.pool.launches`` for K2's pool variant and
``bn_bwd_*_cuda.pooled.launches`` for K3 and K4 at a pooled site; a launch
with a prologue also adds one to ``PROLOGUE_LAUNCHES["centre"]`` (corr
given) or ``["bias"]`` (the dense bias alone). Given a tensor that is not on
a CUDA device it raises; it never computes the plain version.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

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
# against 797 in bf16); "apply" K2 and K4, each in both variants (K4 at a
# pooled site: 702 us at 4 against 820 at 3 in bf16, equal in f32).
BN_CTAS_PER_SM = {"reduce": 4, "reduce_dy": 2, "reduce_pooled": 3, "apply": 4}
BN_DTYPES = (torch.float32, torch.bfloat16)
# launches that took a prologue, over the four stages: "centre" (corr and
# the dense bias: the centred first layer), "bias" (the dense bias alone)
PROLOGUE_LAUNCHES = {"centre": SimpleNamespace(launches=0), "bias": SimpleNamespace(launches=0)}


def bn_plan(R: int, C: int, vec: bool, sms: int, kind: str, S: int = 1) -> tuple[int, int, int, int, int]:
    """The launch of a kernel over R rows of C channels in units of S rows:
    (W lanes a CTA, CTAs along the units, channel tiles, units a CTA, the
    reduction's fan-in). A lane holds 4 channels with ``vec``, else 1; a CTA
    holds min(lanes, BN_THREADS) lanes and BN_THREADS // W row groups, each
    of which takes whole units. Along the units, enough CTAs that each
    thread takes ``BN_MIN_ROWS`` rows or more (a unit at least), at most
    ``BN_CTAS_PER_SM[kind] * sms`` over all tiles (the kinds are listed
    there). A reduction adds its CTAs' partials in blocks of ``fan_in =
    ceil(sqrt(CTAs))`` consecutive CTAs, then the blocks' sums (0 for the
    apply kernels). Depends on the shape and the SM count alone, so
    a reduction's order is the same in every run on one card."""
    if R % S:
        raise ValueError(f"bn_plan: {R} rows are not units of {S}")
    lanes = C // 4 if vec else C
    W = min(lanes, BN_THREADS)
    groups = BN_THREADS // W
    tiles = -(-lanes // W)
    units = R // S
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
        if (not isinstance(dense_bias, torch.Tensor) or dense_bias.dtype != x.dtype or dense_bias.shape != (C,)
                or not dense_bias.is_contiguous()):
            raise ValueError(f"{name}: dense_bias must be a contiguous ({C},) {x.dtype} tensor")
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


def _vec(C: int, *tensors) -> bool:
    """4 channels a lane: C % 4 == 0 and every tensor aligned to 4 elements."""
    return C % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors if t is not None)


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


def _reduce(name: str, counter, x, S: int, vec: bool, launch, corr, dense_bias, kind: str,
            dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate a reduction's workspace and outputs (``dtype``), launch with
    the plan of ``kind``, add one to ``counter.launches`` (and to the
    prologue's count); no rows: zeros, no launch, no count."""
    R, C = x.shape
    if x.numel() == 0:
        out = torch.zeros((2, C), dtype=dtype, device=x.device)
        return out[0], out[1]
    out = torch.empty((2, C), dtype=dtype, device=x.device)  # the last CTA of each tile writes its channels
    W, ctas, tiles, per_cta, fan_in = bn_plan(R, C, vec, sm_count(x.device.index), kind, S)
    levels = bn_reduce_levels(ctas, fan_in)
    ws = torch.empty((2, ctas + levels, C), dtype=torch.float64, device=x.device)  # f64 partial sums
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        tickets = _stream_tickets(x.device, stream, tiles * (levels + 1))
        err = launch(R, C, int(vec), W, ctas, tiles, per_cta, fan_in, ws[0].data_ptr(), ws[1].data_ptr(),
                     tickets.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), stream.cuda_stream)
    check_launch(err, name)
    counter.launches += 1
    _count_prologue(corr, dense_bias)
    return out[0], out[1]


def bn_stats_cuda(x: torch.Tensor, corr: torch.Tensor | None = None,
                  dense_bias: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: per-channel ``sum(x)`` and ``sum(x * x)`` (f64, (C,) each: the
    caller rounds them to f32), x = ``(h - corr[unit]) + dense_bias`` in h's
    dtype (either term optional) of a contiguous (R, C) f32 or bf16 CUDA
    tensor h, added in f64 in the kernel's fixed order. Adds one to
    ``bn_stats_cuda.launches``."""
    _check_rows("bn_stats_cuda", x)
    S = _prologue("bn_stats_cuda", x, corr, dense_bias)
    lib = library()

    def launch(R, C, vec, W, ctas, tiles, per_cta, *rest):
        return lib.votenet_bn_stats(x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, R, C, vec, W, ctas,
                                    tiles, per_cta, *rest)

    return _reduce("bn_stats", bn_stats_cuda, x, S, _vec(x.shape[1], x, corr, dense_bias), launch, corr, dense_bias,
                   "reduce", dtype=torch.float64)


def bn_apply_cuda(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                  relu: bool, corr: torch.Tensor | None = None, dense_bias: torch.Tensor | None = None,
                  pool: int = 0):
    """K2: ``y = ((x - mean) * mul) + bias`` rounded to ``dtype``, then the
    ReLU where ``relu``, x as in :func:`bn_stats_cuda`, the rest f32 (C,).
    With ``pool`` = S, the pool variant: each unit of S rows' max of y
    (torch.amax's) and the int32 count of its rows equal to it, each (R / S,
    C); the full y is not written. Equal to ``ops.batchnorm.bn_apply_plain``
    on the card. Adds one to ``bn_apply_cuda.launches`` (or
    ``.pool.launches``)."""
    _check_rows("bn_apply_cuda", x)
    R, C = x.shape
    S = _prologue("bn_apply_cuda", x, corr, dense_bias)
    _check_channels("bn_apply_cuda", x.device, C, mean=mean, mul=mul, bias=bias)
    if dtype not in BN_DTYPES:
        raise ValueError(f"bn_apply_cuda: output dtype must be float32 or bfloat16, got {dtype}")
    if pool:
        if R % pool or (corr is not None and S != pool):
            raise ValueError(f"bn_apply_cuda: pool of {pool} rows against x {tuple(x.shape)} in units of {S}")
        S = pool
    y = torch.empty((R // S if pool else R, C), dtype=dtype, device=x.device)
    count = torch.empty((R // S, C), dtype=torch.int32, device=x.device) if pool else None
    if x.numel() == 0:
        return (y, count) if pool else y
    vec = _vec(C, x, y, corr, dense_bias, count)
    W, ctas, tiles, per_cta, _ = bn_plan(R, C, vec, sm_count(x.device.index), "apply", S)
    with torch.cuda.device(x.device):
        err = library().votenet_bn_apply(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, y.data_ptr(), _bf16(y), _ptr(count), R, C,
            int(vec), W, ctas, tiles, per_cta, mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), int(relu),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bn_apply_pool" if pool else "bn_apply")
    (bn_apply_cuda.pool if pool else bn_apply_cuda).launches += 1
    _count_prologue(corr, dense_bias)
    return (y, count) if pool else y


def bn_bwd_reduce_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       relu: bool, corr: torch.Tensor | None = None, dense_bias: torch.Tensor | None = None,
                       pooled: tuple[torch.Tensor, torch.Tensor] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: per-channel ``sum(g)`` and ``sum(g * (x - mean))`` (f32, (C,)
    each), x as in :func:`bn_stats_cuda`, g = dy with the ReLU's mask
    recomputed from x (zero where the pre-ReLU output, in dy's dtype, is <=
    0). dy is (R, C) f32 or bf16, or with ``pooled = (ymax, count)`` (K2's
    pool outputs) the pooled cotangent, (R / S, C), which each row takes as
    torch.amax's backward gives it. Adds one to
    ``bn_bwd_reduce_cuda.launches`` (or ``.pooled.launches``)."""
    _check_rows("bn_bwd_reduce_cuda", x)
    R, C = x.shape
    S = _pooled("bn_bwd_reduce_cuda", x, dy, pooled, _prologue("bn_bwd_reduce_cuda", x, corr, dense_bias))
    _check_channels("bn_bwd_reduce_cuda", x.device, C, mean=mean, mul=mul, bias=bias)
    ymax, count = pooled if pooled is not None else (None, None)
    lib = library()

    def launch(R_, C_, vec, W, ctas, tiles, per_cta, fan_in, *rest):
        return lib.votenet_bn_bwd_reduce(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, dy.data_ptr(), _bf16(dy), _ptr(ymax),
            _ptr(count), R_, C_, vec, W, ctas, tiles, per_cta, fan_in, mean.data_ptr(), mul.data_ptr(),
            bias.data_ptr(), int(relu), *rest)

    return _reduce("bn_bwd_reduce", bn_bwd_reduce_cuda.pooled if pooled is not None else bn_bwd_reduce_cuda, x, S,
                   _vec(C, x, dy, corr, dense_bias, ymax, count), launch, corr, dense_bias,
                   "reduce_pooled" if pooled is not None else "reduce_dy")


def bn_bwd_apply_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                      a: torch.Tensor | None, b: torch.Tensor | None, relu: bool, corr: torch.Tensor | None = None,
                      dense_bias: torch.Tensor | None = None,
                      pooled: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """K4: ``dx = ((g * mul) + a) + (b * x)`` (``g * mul`` where a and b are
    None: eval) in h's dtype, x and g as in :func:`bn_bwd_reduce_cuda`
    (dx is the cotangent of x, and so of h). Equal to
    ``ops.batchnorm.bn_bwd_apply_plain`` on the card. Adds one to
    ``bn_bwd_apply_cuda.launches`` (or ``.pooled.launches``)."""
    _check_rows("bn_bwd_apply_cuda", x)
    R, C = x.shape
    S = _pooled("bn_bwd_apply_cuda", x, dy, pooled, _prologue("bn_bwd_apply_cuda", x, corr, dense_bias))
    if (a is None) != (b is None):
        raise ValueError("bn_bwd_apply_cuda: a and b both or none")
    vectors = dict(mean=mean, mul=mul, bias=bias) | ({} if a is None else dict(a=a, b=b))
    _check_channels("bn_bwd_apply_cuda", x.device, C, **vectors)
    ymax, count = pooled if pooled is not None else (None, None)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    vec = _vec(C, x, dy, dx, corr, dense_bias, ymax, count)
    W, ctas, tiles, per_cta, _ = bn_plan(R, C, vec, sm_count(x.device.index), "apply", S)
    with torch.cuda.device(x.device):
        err = library().votenet_bn_bwd_apply(
            x.data_ptr(), _bf16(x), _ptr(corr), _ptr(dense_bias), S, dy.data_ptr(), _bf16(dy), _ptr(ymax),
            _ptr(count), dx.data_ptr(), R, C, int(vec), W, ctas, tiles, per_cta, mean.data_ptr(), mul.data_ptr(),
            bias.data_ptr(), _ptr(a), _ptr(b), int(relu), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bn_bwd_apply")
    (bn_bwd_apply_cuda.pooled if pooled is not None else bn_bwd_apply_cuda).launches += 1
    _count_prologue(corr, dense_bias)
    return dx


bn_stats_cuda.launches = 0
bn_apply_cuda.launches = 0
bn_bwd_reduce_cuda.launches = 0
bn_bwd_apply_cuda.launches = 0
bn_apply_cuda.pool = SimpleNamespace(launches=0)  # the pool variant's own count
bn_bwd_reduce_cuda.pooled = SimpleNamespace(launches=0)  # at a pooled site
bn_bwd_apply_cuda.pooled = SimpleNamespace(launches=0)
