"""Group-Free 3D's matmul FLOPs a scene, by layer, from the configuration
(``portbench/configs/groupfree3d_sunrgbd_l6o256.json``'s ``config``).

As ``flops.py`` counts VoteNet: 2 * in * out a row for each dense layer
(an SA layer's MLP over every (centre, slot) pair, its first layer over
``[offsets | features]``: 3 + ``input_feature_dim`` inputs at sa1; an FP
layer's over its fine points). Beyond the backbone: the sampling module
over the seeds, the query and key projections, the first head over the
queries, and each decoder layer's position embeddings (6 inputs over the
queries, 3 over the seeds), its attentions' projections (q, k and v, the
output), their two products (:func:`attention_flops`: 4 Lq Lk D a head),
its FFN and its head. The eval forward of the port projects each SA
layer's first layer before the gather, so it does less than this count:
mfu states the model's work.
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.groupfree_ref import head_channels
from portbench.yardstick.flops import _stack


def attention_flops(cfg: dict, Lq: int, Lk: int) -> float:
    """The two products of one attention over a scene: ``q k^T`` and ``p v``,
    2 Lq Lk D each, over the heads (D = d_model / nhead)."""
    return 4.0 * Lq * Lk * cfg["d_model"]


def forward_flops(cfg: dict) -> Dict[str, float]:
    """{layer: matmul FLOPs of one scene's forward}."""
    out: Dict[str, float] = {}
    cin = cfg["input_feature_dim"]
    for i, widths in enumerate(cfg["sa_mlps"]):
        out[f"sa{i + 1}"] = float(cfg["sa_npoints"][i] * cfg["sa_nsamples"][i] * _stack(3 + cin, widths))
        cin = widths[-1]
    c2, c3, c4 = (cfg["sa_mlps"][i][-1] for i in (1, 2, 3))
    out["fp1"] = float(cfg["sa_npoints"][2] * _stack(c4 + c3, cfg["fp_mlps"][0]))
    out["fp2"] = float(cfg["sa_npoints"][1] * _stack(cfg["fp_mlps"][0][-1] + c2, cfg["fp_mlps"][1]))
    d, S, K = cfg["d_model"], cfg["sa_npoints"][1], cfg["num_queries"]
    head = K * _stack(d, (d, d, head_channels(cfg)))
    out["sampling"] = float(S * _stack(d, (d, d, 1)) + head + K * 2 * d * d + S * 2 * d * d)
    layer = (K * _stack(6, (d, d)) + S * _stack(3, (d, d))  # the position embeddings
             + K * 2 * d * 3 * d + attention_flops(cfg, K, K) + K * 2 * d * d  # self-attention
             + K * 2 * d * d + S * 2 * d * 2 * d + attention_flops(cfg, K, S) + K * 2 * d * d  # cross-attention
             + K * _stack(d, (cfg["dim_feedforward"], d)) + head)  # the FFN, the head
    out["decoder"] = float(cfg["num_layers"] * layer)
    return out


def flops_by_dtype(cfg: dict, layer_dtypes: Dict[str, str]) -> Dict[str, float]:
    """{dtype: FLOPs a scene} of a forward, each layer in its stated dtype."""
    out: Dict[str, float] = {}
    for layer, f in forward_flops(cfg).items():
        dt = layer_dtypes.get(layer, "float32")
        out[dt] = out.get(dt, 0.0) + f
    return out
