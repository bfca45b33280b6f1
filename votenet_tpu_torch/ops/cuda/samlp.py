"""Fused SA-layer MLP + max-pool (eval): the CUDA kernel's wrapper and its
plain version.

Kernel: ``votenet_tpu_torch/csrc/samlp.cu``. It replaces the Pallas kernel
``votenet_tpu/ops/pallas/samlp.py:78 _samlp_kernel`` (wrapper
``fused_sa_mlp_pool``, ``:100``). The TPU kernel takes the gathered
``h0 = group_point(h_all, idx)``; this one takes the ungathered ``h_all`` and
the ball-query indices and gathers as its first load, so the grouped
(B, M, S, w0) tensor never reaches device memory. Its matmuls run on the
tensor cores (``wgmma``) in 3xTF32: each f32 operand split into a TF32 big
and small term, three TF32 products per f32 product, f32-accurate. A prologue
kernel of the same launch splits the weights, passed as (w_out, w_in)
(``nn.Linear``'s layout, K-major as TF32 ``wgmma`` needs), into the slices
the kernel streams; :func:`samlp_plan` lays out the launch. See the note at
the top of the source.

``precision="bf16"`` is the TPU kernel's bf16-operand mode (``samlp.py:87-94``,
``ops/dispatch.py::set_samlp_precision``): before each dense layer after the
first the f32 activations and the weights are rounded to bf16 (round to
nearest even) and multiplied with f32 accumulation, one bf16 ``wgmma`` a
product (``samlp_kernel<true>``); layer 0's affine + ReLU, the epilogues and
the pooling stay f32. Its launches count on
``fused_sa_mlp_pool_cuda.bf16.launches``.

Semantics of both versions, with the eval batch norm and the dense biases
folded by the caller (``models/pointnet2.py``, after
``votenet_tpu/models/pointnet2.py:325-347``)::

    x = relu(group_point(h_all, idx) * s0 + sh0[:, :, None, :])
    for W, s, t in layers:
        x = relu((x @ W) * s + t)
    out = amax(x, dim=2)

h_all (B, N, w0), idx (B, M, S) int in [0, N), sh0 (B, M, w0), s0 (w0,); each
layer's W is (w_in, w_out), s and t (w_out,); out (B, M, w_last), all f32.
The multiplies and adds of the affine steps round as the plain version's do;
the matmuls sum in another order and in 3xTF32 (the dropped small*small
term is ~2^-22 of a product), so the two agree to ~1e-6 of the output's
scale, not bitwise. :func:`tf32_split` and :func:`chain_3xtf32` emulate the
kernel's arithmetic in plain PyTorch, :func:`chain_bf16` the bf16 variant's.
In bf16 the products are exact and only the sums' order differs, but an
activation one f32 ulp apart can round to the neighbouring bf16 value
before the next layer, so the kernel and its plain version agree to a
bf16-sized margin, not to 3xTF32's.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace
from typing import NamedTuple, Sequence, Tuple

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda, sm_count

Layer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# mirror csrc/samlp.cu: rows of a wgmma tile, layers, ring stages, the
# shared memory a block may use on Hopper (227 KB), and the wgmma N a
# layer's output is padded to
ROWS, MAX_LAYERS, MAX_STAGES = 64, 8, 4
SMEM_LIMIT = 232448
N_PADS = (32, 64, 128, 256)
CONSUMER_WGS = 2  # consumer warpgroups of a block
PRECISIONS = ("f32", "bf16")
# bytes of one weight in the ring (3xTF32: two f32 terms; bf16: one term)
# and the slice widths tried, widest first (a bf16 slice must divide every
# layer's K: four k16 steps where it can, else two)
TERM_BYTES = {"f32": 8, "bf16": 2}
SLICE_KS = {"f32": (32, 16), "bf16": (64, 32)}


class SamlpPlan(NamedTuple):
    """A launch of the fused kernel: T centres a 64-row tile (S <= 64) or R
    tiles a centre (S > 64); each layer's wgmma N (``npad``) and K
    (``kpad``); ``ks`` channels of K a weight slice and ``stages`` slices in
    the ring; the block's dynamic shared memory and the split weights'
    scratch in floats (a float holds two bf16 terms)."""

    T: int
    R: int
    npad: Tuple[int, ...]
    kpad: Tuple[int, ...]
    ks: int
    stages: int
    smem: int
    wsplit: int


def samlp_plan(S: int, widths: Sequence[int], precision: str = "f32") -> SamlpPlan:
    """The launch plan of ``csrc/samlp.cu`` for S ball slots, the chain's
    widths (w0, then each layer's output) and the operand ``precision``
    ("f32": 3xTF32, "bf16"). Raises ValueError for another precision, where
    a width exceeds 256 or the block's shared memory would not hold two
    stages."""
    if precision not in PRECISIONS:
        raise ValueError(f"samlp: precision must be one of {PRECISIONS}, got {precision!r}")
    if S < 1 or len(widths) < 2 or min(widths) < 1 or max(widths) > N_PADS[-1]:
        raise ValueError(f"samlp: need S >= 1 and widths in [1, {N_PADS[-1]}], got S={S}, widths {list(widths)}")
    T, R = (ROWS // S, 1) if S <= ROWS else (1, -(-S // ROWS))
    npad = tuple(next(p for p in N_PADS if p >= w) for w in widths[1:])
    kpad = (-(-widths[0] // 32) * 32,) + npad[:-1]
    affine = kpad[0] + 2 * sum(npad)  # s0, then each layer's scale and shift, in floats
    fixed = (CONSUMER_WGS * (max(kpad) // 8) * 128 * 16 + CONSUMER_WGS * T * npad[-1] * 4 + affine * 4
             + 2 * MAX_STAGES * 8)
    term = TERM_BYTES[precision]
    for ks in SLICE_KS[precision]:  # the wider slice while two stages fit
        if any(k % ks for k in kpad):
            continue
        stage = max(npad) * ks * term
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
        if stages >= 2:
            wsplit = sum(k * n for k, n in zip(kpad, npad)) * term // 4
            return SamlpPlan(T, R, npad, kpad, ks, stages, fixed + stages * stage, wsplit)
    raise ValueError(f"samlp: widths {list(widths)} at S={S} need more shared memory than a block has ({SMEM_LIMIT})")


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) TF32 terms of f32 ``x`` as the kernel makes them
    (``cvt.rna.tf32.f32``: the low 13 mantissa bits rounded off, to nearest,
    ties away from zero): big = tf32(x), small = tf32(x - big)."""

    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    big = rna(x.float())
    return big, rna(x.float() - big)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest, ties to even, as ``astype(bfloat16)``
    and ``cvt.rn.bf16x2.f32``), back in f32."""
    return x.to(torch.bfloat16).float()


def _grouped_layer0(h_all, idx, sh0, s0) -> torch.Tensor:
    B, N, C = h_all.shape
    _, M, S = idx.shape
    flat = (idx.long() + (torch.arange(B, device=idx.device) * N)[:, None, None]).reshape(-1)
    h0 = h_all.reshape(B * N, C).index_select(0, flat).reshape(B, M, S, C)
    return torch.relu(h0 * s0 + sh0[:, :, None, :])


def chain_bf16(h_all, idx, sh0, s0, layers: Sequence[Layer]) -> torch.Tensor:
    """The bf16 variant's arithmetic: each matmul's operands rounded to bf16,
    their products (exact) summed in f64 and rounded once to f32 (the tensor
    core's f32 accumulation aside), the affine steps in f32."""
    x = _grouped_layer0(h_all, idx, sh0, s0)
    for W, s, t in layers:
        prod = _bf16(x).double() @ _bf16(W).double()
        x = torch.relu(prod.float() * s + t)
    return torch.amax(x, dim=2)


def chain_3xtf32(h_all, idx, sh0, s0, layers: Sequence[Layer], terms: int = 3) -> torch.Tensor:
    """The plain version with each matmul taken as the kernel takes it, in
    TF32 terms summed in f64 (the tensor core's f32 accumulation aside):
    ``terms=3`` small*big + big*small + big*big (3xTF32), ``terms=1`` big*big
    alone (1xTF32, ~1e-3 relative)."""
    x = _grouped_layer0(h_all, idx, sh0, s0)
    for W, s, t in layers:
        xb, xs = tf32_split(x)
        wb, ws = tf32_split(W)
        prod = xb.double() @ wb.double()
        if terms == 3:
            prod = prod + xs.double() @ wb.double() + xb.double() @ ws.double()
        x = torch.relu(prod.float() * s + t)
    return torch.amax(x, dim=2)


def fused_sa_mlp_pool_plain(
    h_all: torch.Tensor, idx: torch.Tensor, sh0: torch.Tensor, s0: torch.Tensor, layers: Sequence[Layer],
    precision: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch version: the gather, the chain, the max over the S
    slots. ``precision="bf16"`` rounds each matmul's operands to bf16 and
    multiplies them in f32 (the products exact, the sums in f32, as
    ``preferred_element_type=jnp.float32`` keeps them): not a bf16 matmul,
    which would round the product."""
    if precision not in PRECISIONS:
        raise ValueError(f"samlp: precision must be one of {PRECISIONS}, got {precision!r}")
    x = _grouped_layer0(h_all, idx, sh0, s0)
    for W, s, t in layers:
        y = _bf16(x) @ _bf16(W) if precision == "bf16" else x @ W
        x = torch.relu(y * s + t)
    return torch.amax(x, dim=2)


def fused_sa_mlp_pool_cuda(
    h_all: torch.Tensor, idx: torch.Tensor, sh0: torch.Tensor, s0: torch.Tensor, layers: Sequence[Layer],
    precision: str = "f32",
) -> torch.Tensor:
    """Launch the fused kernel: contiguous f32 CUDA tensors h_all (B, N, w0),
    sh0 (B, M, w0), s0 (w0,), each layer's s and t (w_out,), and int32 idx
    (B, M, S); each layer's W (w_in, w_out) f32 of any strides (the kernel
    reads W.t(), which is contiguous where W is a transposed view of
    ``nn.Linear.weight``) -> (B, M, w_last) f32. Every width at most 256.
    ``precision``: "f32" (3xTF32) or "bf16" (bf16 operands, f32
    accumulation).

    Raises for a tensor that is not on a CUDA device; it never computes the
    plain version. Adds one per launch to ``fused_sa_mlp_pool_cuda.launches``
    (f32) or ``fused_sa_mlp_pool_cuda.bf16.launches``.
    """
    require_cuda("fused_sa_mlp_pool_cuda", h_all, 3)
    B, N, w0 = h_all.shape
    if not isinstance(idx, torch.Tensor) or idx.device != h_all.device:
        raise RuntimeError(f"fused_sa_mlp_pool_cuda: idx must be a CUDA tensor on {h_all.device}")
    if idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[0] != B or not idx.is_contiguous():
        raise ValueError(
            f"fused_sa_mlp_pool_cuda: idx must be a contiguous int32 ({B}, M, S) tensor, "
            f"got {idx.dtype} {tuple(idx.shape)} contiguous={idx.is_contiguous()}"
        )
    _, M, S = idx.shape
    if min(B, N, M, S, w0) < 1:
        raise ValueError(f"fused_sa_mlp_pool_cuda: empty input: h_all {tuple(h_all.shape)}, idx {tuple(idx.shape)}")
    require_cuda("fused_sa_mlp_pool_cuda sh0", sh0, 3, w0)
    require_cuda("fused_sa_mlp_pool_cuda s0", s0, 1, w0)
    if tuple(sh0.shape) != (B, M, w0):
        raise ValueError(f"fused_sa_mlp_pool_cuda: sh0 must be ({B}, {M}, {w0}), got {tuple(sh0.shape)}")
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"fused_sa_mlp_pool_cuda: 1 to {MAX_LAYERS} layers after layer 0, got {len(layers)}")
    widths = [w0]
    for i, (W, s, t) in enumerate(layers):
        if not isinstance(W, torch.Tensor) or W.device.type != "cuda" or W.dtype != torch.float32 or W.dim() != 2:
            raise ValueError(f"fused_sa_mlp_pool_cuda: W{i + 1} must be a 2-D float32 CUDA tensor, "
                             f"got {getattr(W, 'dtype', type(W))} {getattr(W, 'device', '')}")
        if W.shape[0] != widths[-1]:
            raise ValueError(f"fused_sa_mlp_pool_cuda: W{i + 1} is {tuple(W.shape)}, its input width must be {widths[-1]}")
        require_cuda(f"fused_sa_mlp_pool_cuda s{i + 1}", s, 1, W.shape[1])
        require_cuda(f"fused_sa_mlp_pool_cuda t{i + 1}", t, 1, W.shape[1])
        widths.append(W.shape[1])
    for name, tt in [("sh0", sh0), ("s0", s0)] + [(f"layer {i + 1}", w) for i, lay in enumerate(layers) for w in lay]:
        if tt.device != h_all.device:
            raise RuntimeError(f"fused_sa_mlp_pool_cuda: {name} is on {tt.device}, h_all on {h_all.device}")
    plan = samlp_plan(S, widths, precision)
    lib = library()
    n = len(layers)
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    # (w_out, w_in), K-major: a transposed view of nn.Linear's weight is free
    wts = [W.t().contiguous() for W, _, _ in layers]
    with torch.cuda.device(h_all.device):
        items = B * (-(-M // plan.T) if S <= ROWS else M)
        out = torch.empty((B, M, widths[-1]), dtype=torch.float32, device=h_all.device)
        wsplit = torch.empty((plan.wsplit,), dtype=torch.float32, device=h_all.device)
        err = lib.votenet_samlp(
            h_all.data_ptr(), idx.data_ptr(), sh0.data_ptr(), s0.data_ptr(),
            ptrs(*[w.data_ptr() for w in wts]),
            ptrs(*[s.data_ptr() for _, s, _ in layers]),
            ptrs(*[t.data_ptr() for _, _, t in layers]),
            (ctypes.c_int * (n + 1))(*widths), ints(*plan.npad), ints(*plan.kpad), n, B, N, M, S,
            plan.T, plan.R, plan.ks, plan.stages, min(-(-items // CONSUMER_WGS), sm_count(h_all.device.index)),
            int(precision == "bf16"), wsplit.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, "fused_sa_mlp_pool")
    if precision == "bf16":
        fused_sa_mlp_pool_cuda.bf16.launches += 1
    else:
        fused_sa_mlp_pool_cuda.launches += 1
    return out


fused_sa_mlp_pool_cuda.launches = 0
fused_sa_mlp_pool_cuda.bf16 = SimpleNamespace(launches=0)  # the bf16 variant's own count
