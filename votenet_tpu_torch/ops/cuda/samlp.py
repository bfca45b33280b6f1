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
product; layer 0's affine + ReLU, the epilogues and the pooling stay f32.
It has a kernel of its own, ``samlp_bf16_kernel``: the activations chained
in registers as packed bf16, the producer warpgroup staging the gather, and
the whole weight chain resident in shared memory (``route="resident"``)
where it fits beside the tiles, else streamed through the 3xTF32 kernel's
ring (``route="ring"``); :func:`samlp_plan` chooses from the shapes, a
caller may force either. Its launches count on
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
# bytes of one weight in the 3xTF32 kernel's ring (two f32 terms; bf16's
# one term is 2) and the slice widths tried, widest first (a bf16 slice
# must divide every layer's K: four k16 steps where it can, else two)
TF32_TERM_BYTES = 8
SLICE_KS = {"f32": (32, 16), "bf16": (64, 32)}
# the bf16 kernel's routes: the weight chain resident in shared memory, or
# streamed through the ring; floats past K0 in a staged row; staged tiles
# (slots, each 64 rows of h_all and T + 1 of sh0), at most; the index rows
# held (kIdxAhead + 1 steps of two tiles); mbarriers (the chain's, each
# slot's full and empty, the ring's full and empty a stage)
ROUTES = ("resident", "ring")
CHUNK = 128  # columns of a layer's products at a time (the ring streams slices a chunk at a time)
STAGE_PAD = 8
MAX_SLOTS = 8
IDX_AHEAD_ROWS = 10
BF16_BARRIERS = 1 + 2 * MAX_SLOTS + 2 * MAX_STAGES


class SamlpPlan(NamedTuple):
    """A launch of a fused kernel: T centres a 64-row tile (S <= 64) or R
    tiles a centre (S > 64); each layer's wgmma N (``npad``) and K
    (``kpad``); ``ks`` channels of K a weight slice and ``stages`` slices in
    the ring (0 where the bf16 chain is resident); the block's dynamic shared
    memory and the weights' scratch in floats (a float holds two bf16
    terms); the route ("ring" for the 3xTF32 kernel, "resident" or "ring"
    for the bf16 one) and the bf16 kernel's staged tiles (``slots``)."""

    T: int
    R: int
    npad: Tuple[int, ...]
    kpad: Tuple[int, ...]
    ks: int
    stages: int
    smem: int
    wsplit: int
    route: str = "ring"
    slots: int = 0


def samlp_plan(S: int, widths: Sequence[int], precision: str = "f32", route: str | None = None) -> SamlpPlan:
    """The launch plan of ``csrc/samlp.cu`` for S ball slots, the chain's
    widths (w0, then each layer's output) and the operand ``precision``
    ("f32": 3xTF32, "bf16"). In bf16 ``route`` forces "resident" or "ring";
    None takes the resident chain where it fits. Raises ValueError for
    another precision or route, where a width exceeds 256 or the block's
    shared memory would not hold the route (two ring stages at least)."""
    if precision not in PRECISIONS:
        raise ValueError(f"samlp: precision must be one of {PRECISIONS}, got {precision!r}")
    if route not in (None, *ROUTES) or (precision == "f32" and route not in (None, "ring")):
        raise ValueError(f"samlp: route must be None or one of {ROUTES} (f32: the ring), got {route!r}")
    if S < 1 or len(widths) < 2 or min(widths) < 1 or max(widths) > N_PADS[-1]:
        raise ValueError(f"samlp: need S >= 1 and widths in [1, {N_PADS[-1]}], got S={S}, widths {list(widths)}")
    T, R = (ROWS // S, 1) if S <= ROWS else (1, -(-S // ROWS))
    npad = tuple(next(p for p in N_PADS if p >= w) for w in widths[1:])
    if precision == "bf16":
        return _bf16_plan(S, widths, T, R, npad, route)
    term = TF32_TERM_BYTES
    kpad = (-(-widths[0] // 32) * 32,) + npad[:-1]
    affine = kpad[0] + 2 * sum(npad)  # s0, then each layer's scale and shift, in floats
    fixed = (CONSUMER_WGS * (max(kpad) // 8) * 128 * 16 + CONSUMER_WGS * T * npad[-1] * 4 + affine * 4
             + 2 * MAX_STAGES * 8)
    for ks in SLICE_KS["f32"]:  # the wider slice while two stages fit
        if any(k % ks for k in kpad):
            continue
        stage = max(npad) * ks * term
        stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // stage)
        if stages >= 2:
            wsplit = sum(k * n for k, n in zip(kpad, npad)) * term // 4
            return SamlpPlan(T, R, npad, kpad, ks, stages, fixed + stages * stage, wsplit)
    raise ValueError(f"samlp: widths {list(widths)} at S={S} need more shared memory than a block has ({SMEM_LIMIT})")


def _bf16_plan(S, widths, T, R, npad, route) -> SamlpPlan:
    """The bf16 kernel's plan (``csrc/samlp.cu`` ``bf16_smem``): K0 a power
    of two, every K a multiple of the slice; the pooled rows, affine vectors,
    index rows, barriers and as many staged tiles as fit (2 to MAX_SLOTS)
    beside the resident chain, or beside two to four ring stages."""
    k0 = 32
    while k0 < widths[0]:
        k0 *= 2
    kpad = (k0,) + npad[:-1]
    slices = [k for k in SLICE_KS["bf16"] if all(kp % k == 0 for kp in kpad)]
    tile = (ROWS + T + 1) * (k0 + STAGE_PAD) * 4  # a slot
    # pooled rows; s0, each layer's scale and shift, the last one's signs; index rows; barriers
    fixed = (CONSUMER_WGS * T * npad[-1] * 4 + (k0 + 2 * sum(npad) + npad[-1]) * 4 + IDX_AHEAD_ROWS * ROWS * 4
             + BF16_BARRIERS * 8)
    weights = sum(k * n for k, n in zip(kpad, npad)) * 2
    wsplit = weights // 4 + N_PADS[-1]  # the chain, then a row of zeros

    def plan(ks, stages, held):
        slots = min(MAX_SLOTS, (SMEM_LIMIT - fixed - held) // tile)
        return SamlpPlan(T, R, npad, kpad, ks, stages, fixed + held + slots * tile, wsplit,
                         "ring" if stages else "resident", slots)

    if route in (None, "resident") and fixed + weights + 2 * tile <= SMEM_LIMIT:
        return plan(slices[0], 0, weights)
    if route in (None, "ring"):
        for k in slices:  # the wider slice while two stages fit beside two slots
            stage = min(max(npad), CHUNK) * k * 2  # a chunk's columns of a slice
            stages = min(MAX_STAGES, (SMEM_LIMIT - fixed - 2 * tile) // stage)
            if stages >= 2:
                return plan(k, stages, stages * stage)
    raise ValueError(f"samlp: bf16 widths {list(widths)} at S={S} need more shared memory than a block has "
                     f"({SMEM_LIMIT}) on the {route or 'resident or the ring'} route")


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
    precision: str = "f32", route: str | None = None,
) -> torch.Tensor:
    """Launch the fused kernel: contiguous f32 CUDA tensors h_all (B, N, w0),
    sh0 (B, M, w0), s0 (w0,), each layer's s and t (w_out,), and int32 idx
    (B, M, S); each layer's W (w_in, w_out) f32 of any strides (the kernel
    reads W.t(), which is contiguous where W is a transposed view of
    ``nn.Linear.weight``) -> (B, M, w_last) f32. Every width at most 256.
    ``precision``: "f32" (3xTF32, ``samlp_kernel``) or "bf16" (bf16
    operands, f32 accumulation, ``samlp_bf16_kernel``); ``route`` forces the
    bf16 kernel's "resident" or "ring" route (see :func:`samlp_plan`).

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
    plan = samlp_plan(S, widths, precision, route)
    lib = library()
    n = len(layers)
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    # (w_out, w_in), K-major: a transposed view of nn.Linear's weight is free
    wts = [W.t().contiguous() for W, _, _ in layers]
    with torch.cuda.device(h_all.device):
        items = B * (-(-M // plan.T) if S <= ROWS else M)
        out = torch.empty((B, M, widths[-1]), dtype=torch.float32, device=h_all.device)
        wsplit = torch.empty((plan.wsplit,), dtype=torch.float32, device=h_all.device)
        args = (
            h_all.data_ptr(), idx.data_ptr(), sh0.data_ptr(), s0.data_ptr(),
            ptrs(*[w.data_ptr() for w in wts]),
            ptrs(*[s.data_ptr() for _, s, _ in layers]),
            ptrs(*[t.data_ptr() for _, _, t in layers]),
            (ctypes.c_int * (n + 1))(*widths), ints(*plan.npad), ints(*plan.kpad), n, B, N, M, S,
            plan.T, plan.R, plan.ks, plan.stages, min(-(-items // CONSUMER_WGS), sm_count(h_all.device.index)),
        )
        stream = torch.cuda.current_stream().cuda_stream
        if precision == "bf16":
            err = lib.votenet_samlp_bf16(*args, plan.slots, stage_chunk(w0, h_all, sh0), wsplit.data_ptr(),
                                         out.data_ptr(), stream)
        else:
            err = lib.votenet_samlp(*args, wsplit.data_ptr(), out.data_ptr(), stream)
    check_launch(err, "fused_sa_mlp_pool")
    if precision == "bf16":
        fused_sa_mlp_pool_cuda.bf16.launches += 1
    else:
        fused_sa_mlp_pool_cuda.launches += 1
    return out


def stage_chunk(w0: int, *tensors: torch.Tensor) -> int:
    """How the bf16 kernel stages its rows: 0, a bulk copy a row, where a
    row of w0 floats and every tensor's address are multiples of 16 bytes,
    else the bytes a cp.async (8 or 4), the widest that divides them."""
    return next(c for c in (16, 8, 4) if (w0 * 4) % c == 0 and all(t.data_ptr() % c == 0 for t in tensors)) % 16


fused_sa_mlp_pool_cuda.launches = 0
fused_sa_mlp_pool_cuda.bf16 = SimpleNamespace(launches=0)  # the bf16 kernel's own count
