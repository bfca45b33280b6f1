"""The least time of the port's own kernels in a Group-Free 3D eval forward,
from the configuration, built from ``bounds.py``'s functions.

:func:`unit_bounds` gives, by kernel family (``kernel_families.json``), the
bound of one forward at batch B:

- FPS and the ball query at the four SA layers (the queries are sampled by
  their scores, not by FPS), the ball query counted at ``nsample`` points a
  query;
- batch norm's K2 at every site: the SA MLPs (the first width with the
  centred prologue, the last pooled over the ball), the FP layers, the
  sampling module's two over the seeds, the first head's two, and in each
  decoder layer the two position embeddings' (over the queries and the
  seeds) and the head's two;
- the head: decode with the IoU self-matrix and the greedy's bytes, as
  VoteNet's.

:func:`attention_bound_ms` is the attention kernel's (``csrc/attention.cu``):
the larger of its two products at the f32 peak and its Q, K, V and O bytes
at the memory rate, over the two attentions of every layer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.yardstick.bounds import (
    PEAK_BYTES,
    PEAK_F32_FLOPS,
    ballquery_shape_bound,
    bn_bounds,
    decode_iou_bound,
    fps_bound,
    nms_bound,
)
from portbench.yardstick.gf_flops import attention_flops


def bn_sites(cfg: dict) -> List[Tuple[str, int, int, str, int, bool]]:
    """(layer, rows a scene, channels, prologue, rows a unit S, pooled) of
    each batch norm + ReLU of a forward: an SA layer's rows come in units of
    its ``nsample`` slots, its last width pooled over them."""
    sites = []
    for i, mlp in enumerate(cfg["sa_mlps"]):
        rows, S = cfg["sa_npoints"][i] * cfg["sa_nsamples"][i], cfg["sa_nsamples"][i]
        sites += [(f"sa{i + 1}", rows, w, "centre" if j == 0 else "bias", S, j == len(mlp) - 1)
                  for j, w in enumerate(mlp)]
    for i, mlp in enumerate(cfg["fp_mlps"]):  # fp1 at sa3's points, fp2 at sa2's
        sites += [(f"fp{i + 1}", cfg["sa_npoints"][2 - i], w, "bias", 1, False) for w in mlp]
    d, S, K = cfg["d_model"], cfg["sa_npoints"][1], cfg["num_queries"]
    seeds, queries = (S, d, "bias", 1, False), (K, d, "bias", 1, False)
    sites += [("sampling",) + seeds] * 2 + [("sampling",) + queries] * 2
    layer = [("decoder",) + queries, ("decoder",) + seeds] + [("decoder",) + queries] * 2
    return sites + layer * cfg["num_layers"]


def unit_bounds(cfg: dict, B: int) -> Dict[str, float]:
    """{kernel family: least ms} of one eval forward at batch B."""
    out: Dict[str, float] = {}

    def add(family, pair):
        out[family] = out.get(family, 0.0) + max(pair)

    n_in = [cfg["point_num"]] + list(cfg["sa_npoints"][:3])
    for i in range(4):
        add("fps", fps_bound(B, n_in[i], cfg["sa_npoints"][i]))
        add("ballquery", ballquery_shape_bound(B, n_in[i], cfg["sa_npoints"][i], cfg["sa_nsamples"][i]))
    for _, rows, C, prologue, S, pooled in bn_sites(cfg):
        add("batchnorm", bn_bounds(B * rows, C, 4, 4, S, prologue, pooled)["bn_apply"])
    NH, NS, NC = cfg["num_heading_bin"], cfg["num_size_cluster"], cfg["num_class"]
    P = cfg["num_queries"]
    add("head", decode_iou_bound(B, P, 5 + 2 * NH + 4 * NS + NC, NH, NS, NC))
    add("head", nms_bound(B, P, 0))
    return out


def attention_bound_ms(cfg: dict, B: int) -> float:
    """The attention kernel's least ms in one forward at batch B: for each
    call, the larger of its products' FLOPs at 67 TFLOP/s and its Q, K, V
    (read) and O (written) bytes at 3.35 TB/s, summed over the layers'
    self-attention (Lq = Lk = queries) and cross-attention (Lk = seeds)."""
    K, S, d = cfg["num_queries"], cfg["sa_npoints"][1], cfg["d_model"]
    total = 0.0
    for Lk in (K, S):
        ops = B * attention_flops(cfg, K, Lk)
        nbytes = B * 4.0 * d * (2 * K + 2 * Lk)
        total += max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    return cfg["num_layers"] * total
