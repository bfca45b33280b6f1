"""Casts between f32 and bf16 of a table of tensors (the bf16 weight
copies' refresh and their gradients' return, ``models/bf16_copies.py``)."""

from __future__ import annotations

from votenet_tpu_torch.ops.common import kernel_route
from votenet_tpu_torch.ops.cuda.cast import CastPairs, cast_bf16_multi_cuda, cast_bf16_multi_plain


def cast_bf16_multi(pairs: CastPairs) -> None:
    """Each (src, dst) pair: dst <- src cast to dst's dtype (f32 -> bf16 to
    nearest even, or bf16 -> f32 exactly; zeros where src is None), 1-d or
    2-d views of one shape, any strides, one direction and one device a
    call. On CUDA tensors one launch of ``csrc/cast.cu`` for the whole
    table; on CPU tensors the plain version (``.to()`` tensor by tensor);
    any other device raises."""
    if kernel_route(pairs[0][1], "cast_bf16_multi") == "cuda":
        cast_bf16_multi_cuda(pairs)
    else:
        cast_bf16_multi_plain(pairs)
