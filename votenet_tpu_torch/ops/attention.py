"""Multi-head softmax attention over already projected queries, keys and
values (Group-Free 3D's decoder, ``models/groupfree.py``)."""

from __future__ import annotations

import torch

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.attention import multi_head_attention_cuda, multi_head_attention_plain


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, nhead: int) -> torch.Tensor:
    """q (B, Lq, E), k and v (B, Lk, E) f32 -> (B, Lq, E): for each of the
    ``nhead`` heads (E / nhead channels each, head h at channels [h E /
    nhead, (h + 1) E / nhead)), ``softmax(q_h k_h^T / sqrt(E / nhead))
    v_h``. On CUDA tensors one launch of ``csrc/attention.cu`` (heads of 36
    channels); on CPU tensors the plain version; any other device raises."""
    if kernel_route(q, "multi_head_attention") == "cuda":
        return multi_head_attention_cuda(q, k, v, nhead)
    return multi_head_attention_plain(q, k, v, nhead)
