"""The model's matmul FLOPs a scene, by layer, from the configuration.

Each shared MLP counts 2 * in * out operations a row it runs on, in the
model's own formulation: an SA layer's MLP over every (centre, slot) pair of
its balls, its first layer over ``[centred coordinates | features]`` (3 + C
inputs; sa1's features are the coordinates themselves, so 6); an FP layer's
MLP over its fine points; the voting MLP over the seeds; the proposal
layer's MLP over its balls and its head MLP over the proposals. A training
step counts three forwards (the forward and the two products of the
backward); a recompute is not counted. The eval forward of the port
projects each SA layer's first layer before the gather, so it does less
than this count: mfu states the model's work, not the program's.
"""

from __future__ import annotations

from typing import Dict


def _stack(cin: int, widths) -> int:
    total = 0
    for w in widths:
        total += 2 * cin * w
        cin = w
    return total


def forward_flops(cfg: dict) -> Dict[str, float]:
    """{layer: matmul FLOPs of one scene's forward}."""
    out: Dict[str, float] = {}
    cin = 3
    for i, widths in enumerate(cfg["sa_mlps"]):
        rows = cfg["sa_npoints"][i] * cfg["sa_nsamples"][i]
        out[f"sa{i + 1}"] = float(rows * _stack(3 + cin, widths))
        cin = widths[-1]
    c2, c3, c4 = (cfg["sa_mlps"][i][-1] for i in (1, 2, 3))
    out["fp1"] = float(cfg["sa_npoints"][2] * _stack(c4 + c3, cfg["fp_mlps"][0]))
    out["fp2"] = float(cfg["sa_npoints"][1] * _stack(cfg["fp_mlps"][0][-1] + c2, cfg["fp_mlps"][1]))
    seed_c = cfg["fp_mlps"][1][-1]
    out["voting"] = float(cfg["sa_npoints"][1] * _stack(3 + seed_c, cfg["vote_units"]))
    rows = cfg["proposal_num"] * cfg["proposal_nsample"]
    out["proposal"] = float(rows * _stack(3 + seed_c, cfg["proposal_mlp"]))
    channels = 5 + 2 * cfg["num_heading_bin"] + 4 * cfg["num_size_cluster"] + cfg["num_class"]
    out["head"] = float(cfg["proposal_num"] * _stack(cfg["proposal_mlp"][-1],
                                                     tuple(cfg["proposal_mlp2_hidden"]) + (channels,)))
    return out


# the head MLP runs in the proposal layer's dtype
_DTYPE_OF = {"head": "proposal"}


def flops_by_dtype(cfg: dict, layer_dtypes: Dict[str, str], train: bool) -> Dict[str, float]:
    """{dtype: FLOPs a scene} of a forward (``train``: a training step, three
    forwards' worth), each layer counted in the dtype the configuration
    states for it."""
    out: Dict[str, float] = {}
    for layer, f in forward_flops(cfg).items():
        dt = layer_dtypes.get(_DTYPE_OF.get(layer, layer), "float32")
        out[dt] = out.get(dt, 0.0) + f * (3.0 if train else 1.0)
    return out
