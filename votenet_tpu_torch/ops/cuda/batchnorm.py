"""Batch norm + ReLU: the four CUDA kernels' wrappers and their launch plan.

Kernels: ``votenet_tpu_torch/csrc/batchnorm.cu``, the port's own (the JAX
package runs flax ``nn.BatchNorm`` + ``nn.relu`` in XLA,
``votenet_tpu/models/pointnet2.py:166-174``, and reaches no Pallas kernel).
Each takes the channels-last (R, C) view of a batch-norm input, f32 or bf16,
and per-channel f32 vectors; see the note at the top of the source. Their
plain versions are the stages of ``ops/batchnorm.py``, which chains the
four into one autograd op.

Each wrapper checks what its kernel takes (contiguous CUDA tensors on one
device: a non-contiguous one raises, it is not copied), allocates its
outputs and workspace, launches on the current stream, raises on a launch
error, and adds one to its ``.launches``. Given a tensor that is not on a
CUDA device it raises; it never computes the plain version.
"""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda, sm_count

BN_THREADS = 256  # a CTA's threads (csrc/batchnorm.cu kThreads)
# Rows a thread takes at least before the plan adds CTAs: a reduction's
# last CTA adds one partial a CTA in sequence, so it keeps them few (at
# 8192 x 256, 4 rows a thread gave 512 partials and 41 us on the H100)
BN_MIN_ROWS = {"reduce": 32, "apply": 4}
# CTAs an SM along the rows: the reductions keep their partials few, the
# elementwise passes fill the SM (8 x 256 threads)
BN_CTAS_PER_SM = {"reduce": 4, "apply": 8}
BN_DTYPES = (torch.float32, torch.bfloat16)


def bn_plan(R: int, C: int, vec: bool, sms: int, kind: str) -> tuple[int, int, int, int]:
    """The launch of a kernel over R rows of C channels: (W lanes a CTA,
    CTAs along the rows, channel tiles, rows a CTA). A lane holds 4
    channels with ``vec``, else 1; a CTA holds min(lanes, BN_THREADS) lanes
    and BN_THREADS // W row groups. Along the rows, enough CTAs that each
    thread takes ``BN_MIN_ROWS[kind]`` rows or more, at most ``BN_CTAS_PER_SM[kind] *
    sms`` over all tiles. Depends on the shape and the SM count alone, so a
    reduction's order is the same in every run on one card."""
    lanes = C // 4 if vec else C
    W = min(lanes, BN_THREADS)
    groups = BN_THREADS // W
    tiles = -(-lanes // W)
    ctas = max(1, min(-(-R // (groups * BN_MIN_ROWS[kind])), BN_CTAS_PER_SM[kind] * sms // tiles))
    rows = -(-R // ctas)
    return W, -(-R // rows), tiles, rows


def _check_rows(name: str, t, C: int | None = None) -> None:
    """A contiguous (R, C) f32 or bf16 CUDA tensor."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise RuntimeError(f"{name}: the CUDA kernel needs a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype not in BN_DTYPES or t.dim() != 2 or not t.is_contiguous() or (C is not None and t.shape[1] != C):
        raise ValueError(f"{name}: expected a contiguous float32 or bfloat16 (R, {C or 'C'}) tensor, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")


def _check_channels(name: str, device, C: int, **vectors) -> None:
    for what, v in vectors.items():
        require_cuda(f"{name} {what}", v, 1, C)
        if v.device != device:
            raise ValueError(f"{name}: {what} on {v.device}, x on {device}")


def _vec(C: int, *tensors) -> bool:
    """4 channels a lane: C % 4 == 0 and every row tensor aligned to 4 elements."""
    return C % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


# A stream's reduction tickets, (device index, stream) -> int32 zeros: the
# kernels leave them 0, so launches in one stream's order share them
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _stream_tickets(device, stream, tiles: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None or t.numel() < tiles:
        t = _tickets[key] = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
    return t


def _reduce(wrapper, x, vec: bool, launch) -> tuple[torch.Tensor, torch.Tensor]:
    """Allocate a reduction's workspace and outputs, launch, count on
    ``wrapper``."""
    R, C = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        out = torch.zeros((2, C), **f32)
        return out[0], out[1]
    out = torch.empty((2, C), **f32)  # the last CTA of each tile writes its channels
    W, ctas, tiles, rows = bn_plan(R, C, vec, sm_count(x.device.index), "reduce")
    ws = torch.empty((2, ctas, C), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        tickets = _stream_tickets(x.device, stream, tiles)
        err = launch(R, C, int(vec), W, ctas, tiles, rows, ws[0].data_ptr(), ws[1].data_ptr(), tickets.data_ptr(),
                     out[0].data_ptr(), out[1].data_ptr(), stream.cuda_stream)
    check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    return out[0], out[1]


def bn_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: per-channel ``sum(x)`` and ``sum(x * x)`` (f32, (C,) each) of a
    contiguous (R, C) f32 or bf16 CUDA tensor, added in the kernel's fixed
    order. Adds one to ``bn_stats_cuda.launches``."""
    _check_rows("bn_stats_cuda", x)
    lib = library()

    def launch(*plan):
        return lib.votenet_bn_stats(x.data_ptr(), _bf16(x), *plan)

    return _reduce(bn_stats_cuda, x, _vec(x.shape[1], x), launch)


def bn_apply_cuda(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype,
                  relu: bool) -> torch.Tensor:
    """K2: ``y = ((x - mean) * mul) + bias`` rounded to ``dtype``, then the
    ReLU where ``relu``: x a contiguous (R, C) f32 or bf16 CUDA tensor, the
    rest f32 (C,). Equal to ``ops.batchnorm.bn_apply_plain`` on the card.
    Adds one to ``bn_apply_cuda.launches``."""
    _check_rows("bn_apply_cuda", x)
    R, C = x.shape
    _check_channels("bn_apply_cuda", x.device, C, mean=mean, mul=mul, bias=bias)
    if dtype not in BN_DTYPES:
        raise ValueError(f"bn_apply_cuda: output dtype must be float32 or bfloat16, got {dtype}")
    y = torch.empty((R, C), dtype=dtype, device=x.device)
    if x.numel() == 0:
        return y
    vec = _vec(C, x, y)
    W, ctas, tiles, rows = bn_plan(R, C, vec, sm_count(x.device.index), "apply")
    with torch.cuda.device(x.device):
        err = library().votenet_bn_apply(
            x.data_ptr(), _bf16(x), y.data_ptr(), _bf16(y), R, C, int(vec), W, ctas, tiles, rows, mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(), int(relu), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bn_apply")
    bn_apply_cuda.launches += 1
    return y


def bn_bwd_reduce_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                       relu: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: per-channel ``sum(g)`` and ``sum(g * (x - mean))`` (f32, (C,)
    each), g = dy with the ReLU's mask recomputed from x (zero where the
    pre-ReLU output, in dy's dtype, is <= 0); x and dy contiguous (R, C) f32
    or bf16 CUDA tensors. Adds one to ``bn_bwd_reduce_cuda.launches``."""
    _check_rows("bn_bwd_reduce_cuda", x)
    _check_rows("bn_bwd_reduce_cuda dy", dy, x.shape[1])
    R, C = x.shape
    if dy.shape[0] != R:
        raise ValueError(f"bn_bwd_reduce_cuda: dy {tuple(dy.shape)} against x {tuple(x.shape)}")
    if dy.device != x.device:
        raise ValueError(f"bn_bwd_reduce_cuda: dy on {dy.device}, x on {x.device}")
    _check_channels("bn_bwd_reduce_cuda", x.device, C, mean=mean, mul=mul, bias=bias)
    lib = library()

    def launch(R_, C_, vec, W, ctas, tiles, rows, *rest):
        return lib.votenet_bn_bwd_reduce(x.data_ptr(), _bf16(x), dy.data_ptr(), _bf16(dy), R_, C_, vec, W, ctas,
                                         tiles, rows, mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), int(relu),
                                         *rest)

    return _reduce(bn_bwd_reduce_cuda, x, _vec(C, x, dy), launch)


def bn_bwd_apply_cuda(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor, bias: torch.Tensor,
                      a: torch.Tensor | None, b: torch.Tensor | None, relu: bool) -> torch.Tensor:
    """K4: ``dx = ((g * mul) + a) + (b * x)`` (``g * mul`` where a and b are
    None: eval) in x's dtype, g as in :func:`bn_bwd_reduce_cuda`. Equal to
    ``ops.batchnorm.bn_bwd_apply_plain`` on the card. Adds one to
    ``bn_bwd_apply_cuda.launches``."""
    _check_rows("bn_bwd_apply_cuda", x)
    _check_rows("bn_bwd_apply_cuda dy", dy, x.shape[1])
    R, C = x.shape
    if dy.shape[0] != R or (a is None) != (b is None):
        raise ValueError(f"bn_bwd_apply_cuda: dy {tuple(dy.shape)} against x {tuple(x.shape)}, a and b both or none")
    vectors = dict(mean=mean, mul=mul, bias=bias) | ({} if a is None else dict(a=a, b=b))
    _check_channels("bn_bwd_apply_cuda", x.device, C, **vectors)
    if dy.device != x.device:
        raise ValueError(f"bn_bwd_apply_cuda: dy on {dy.device}, x on {x.device}")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    vec = _vec(C, x, dy, dx)
    W, ctas, tiles, rows = bn_plan(R, C, vec, sm_count(x.device.index), "apply")
    with torch.cuda.device(x.device):
        err = library().votenet_bn_bwd_apply(
            x.data_ptr(), _bf16(x), dy.data_ptr(), _bf16(dy), dx.data_ptr(), R, C, int(vec), W, ctas, tiles, rows,
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), None if a is None else a.data_ptr(),
            None if b is None else b.data_ptr(), int(relu), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bn_bwd_apply")
    bn_bwd_apply_cuda.launches += 1
    return dx


bn_stats_cuda.launches = 0
bn_apply_cuda.launches = 0
bn_bwd_reduce_cuda.launches = 0
bn_bwd_apply_cuda.launches = 0
