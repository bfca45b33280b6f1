"""Multi-head softmax attention: the CUDA kernel's wrapper and its plain
version.

Kernel: ``votenet_tpu_torch/csrc/attention.cu``, the port's own (the JAX
package has no attention: VoteNet computes none). Group-Free 3D's decoder
(``models/groupfree.py``) calls it for its self- and cross-attention. One
launch a call, f32 on the CUDA cores (the configuration keeps TF32 off),
with the scores never in device memory: keys and values stream through
shared memory in tiles and each thread keeps its queries' online softmax
(running maximum and sum, f32) and outputs in registers. See the note at
the top of the source.

Both versions compute, for each head h of E = nhead * D channels (head h
is channels [h D, (h + 1) D)), ``softmax((q_h * scale) k_h^T) v_h`` over
the keys, scale = f32(D ** -0.5), as ``torch.nn.MultiheadAttention`` does
after its input projections. They agree to rounding: the kernel sums in
another order, exponentiates with a running maximum and divides once at
the end.
"""

from __future__ import annotations

import math

import torch

from votenet_tpu_torch.ops.cuda import check_launch, library

ATTENTION_HEAD_DIM = 36  # the head width the kernel is built for (csrc/attention.cu's instance)


def attention_scale(head_dim: int) -> float:
    """f32(head_dim ** -0.5), the factor both versions multiply q by."""
    return float(torch.tensor(1.0 / math.sqrt(head_dim), dtype=torch.float32))


def _heads(x: torch.Tensor, nhead: int) -> torch.Tensor:
    B, L, E = x.shape
    return x.reshape(B, L, nhead, E // nhead).transpose(1, 2)


def multi_head_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int) -> torch.Tensor:
    """The plain version: q (B, Lq, E), k and v (B, Lk, E) -> (B, Lq, E),
    the (B, nhead, Lq, Lk) scores formed whole, softmax over the keys, then
    the product with the values."""
    B, Lq, E = q.shape
    scores = (_heads(q, nhead) * attention_scale(E // nhead)) @ _heads(k, nhead).transpose(-1, -2)
    out = torch.softmax(scores, dim=-1) @ _heads(v, nhead)
    return out.transpose(1, 2).reshape(B, Lq, E)


def _check(name: str, t: torch.Tensor, device: torch.device, B: int, E: int) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda" or t.device != device:
        raise RuntimeError(f"multi_head_attention_cuda: {name} must be a CUDA tensor on {device}, got "
                           f"{getattr(t, 'device', type(t))}")
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[0] != B or t.shape[2] != E:
        raise ValueError(f"multi_head_attention_cuda: {name} must be float32 (B={B}, L, E={E}), got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.stride(2) != 1 or t.stride(0) % 4 or t.stride(1) % 4 or t.data_ptr() % 16:
        raise ValueError(f"multi_head_attention_cuda: {name} needs a contiguous last dimension, strides that are "
                         f"multiples of 4 and 16-byte alignment, got strides {t.stride()}")


def multi_head_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int) -> torch.Tensor:
    """Launch the kernel: q (B, Lq, E), k and v (B, Lk, E) f32 on one CUDA
    device, each with a contiguous last dimension (views of a wider
    projection's output are taken as they are), E = nhead * 36 -> (B, Lq, E)
    f32, contiguous. Raises RuntimeError for a tensor that is not on the
    card (it never computes the plain version), ValueError for other shapes,
    types, strides or head widths. Adds one to
    ``multi_head_attention_cuda.launches`` per call."""
    B, Lq, E = q.shape if q.dim() == 3 else (0, 0, 0)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.device, B, E)
    Lk = k.shape[1]
    if v.shape[1] != Lk or nhead < 1 or E % nhead or E // nhead != ATTENTION_HEAD_DIM or Lq < 1 or Lk < 1:
        raise ValueError(f"multi_head_attention_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"with {nhead} heads: the kernel takes heads of {ATTENTION_HEAD_DIM} channels and Lq, Lk "
                         f">= 1")
    out = torch.empty((B, Lq, E), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = library().votenet_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Lq, Lk, nhead, ATTENTION_HEAD_DIM,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            attention_scale(ATTENTION_HEAD_DIM), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "multi_head_attention_cuda")
    multi_head_attention_cuda.launches += 1
    return out


multi_head_attention_cuda.launches = 0
