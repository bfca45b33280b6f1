"""The detection head's decode: the CUDA kernel's wrapper.

Kernel: ``votenet_tpu_torch/csrc/decode.cu``, the port's own (the JAX
package decodes in XLA, ``votenet_tpu/models/decode.py:44-88``, and reaches
no Pallas kernel). One thread a proposal computes the argmaxes, the size,
centre and heading, the stated sin and cos and the 24 corner coordinates in
the order of the plain version ``models/decode.py::decode_proposals_plain``,
whose floats it equals; see the note at the top of the source.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from votenet_tpu_torch.ops.cuda import check_launch, library, require_cuda


def heading_scale(num_heading_bin: int) -> float:
    """``f32(pi / NH)``, the angle of one heading bin, as a Python float: the
    factor both versions multiply by (JAX rounds ``np.pi / NH`` so)."""
    return float(np.float32(math.pi / num_heading_bin))


def decode_proposals_cuda(out: torch.Tensor, xyz: torch.Tensor, mean_size: torch.Tensor, num_heading_bin: int,
                          num_size_cluster: int, num_class: int) -> dict:
    """Launch the decode: out (B, P, C) (the head's channels), xyz (B, P, 3)
    and mean_size (NS, 3), contiguous f32 on one CUDA device -> a dict of
    ``bboxes`` (B, P, 8, 3), ``nms_scores`` (B, P), ``center_pred`` and
    ``size_pred`` (B, P, 3), ``heading_pred`` (B, P) f32 and ``size_cls``,
    ``heading_cls`` (B, P) int32, equal to ``decode_proposals_plain``'s.
    Raises RuntimeError for a tensor that is not on a CUDA device (it never
    computes the plain version), ValueError for other shapes or types. Adds
    one to ``decode_proposals_cuda.launches`` per call."""
    require_cuda("decode_proposals_cuda", out, 3)
    require_cuda("decode_proposals_cuda", xyz, 3, 3)
    require_cuda("decode_proposals_cuda", mean_size, 2, 3)
    B, P, C = out.shape
    NH, NS, NC = num_heading_bin, num_size_cluster, num_class
    if (tuple(xyz.shape) != (B, P, 3) or mean_size.shape[0] != NS or C != 5 + 2 * NH + 4 * NS + NC
            or xyz.device != out.device or mean_size.device != out.device):
        raise ValueError(f"decode_proposals_cuda: out {tuple(out.shape)}, xyz {tuple(xyz.shape)} and mean_size "
                         f"{tuple(mean_size.shape)} on one device do not fit NH={NH}, NS={NS}, NC={NC}")
    f32 = dict(dtype=torch.float32, device=out.device)
    i32 = dict(dtype=torch.int32, device=out.device)
    res = {
        "bboxes": torch.empty((B, P, 8, 3), **f32),
        "nms_scores": torch.empty((B, P), **f32),
        "center_pred": torch.empty((B, P, 3), **f32),
        "size_pred": torch.empty((B, P, 3), **f32),
        "heading_pred": torch.empty((B, P), **f32),
        "size_cls": torch.empty((B, P), **i32),
        "heading_cls": torch.empty((B, P), **i32),
    }
    if B * P == 0:
        return res
    with torch.cuda.device(out.device):
        err = library().votenet_decode(
            out.data_ptr(), xyz.data_ptr(), mean_size.data_ptr(), B * P, C, NH, NS, NC, heading_scale(NH),
            res["bboxes"].data_ptr(), res["center_pred"].data_ptr(), res["size_pred"].data_ptr(),
            res["heading_pred"].data_ptr(), res["nms_scores"].data_ptr(), res["size_cls"].data_ptr(),
            res["heading_cls"].data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_launch(err, "decode_proposals_cuda")
    decode_proposals_cuda.launches += 1
    return res


decode_proposals_cuda.launches = 0
