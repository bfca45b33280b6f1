"""The plain Group-Free 3D that decides ``correct``: the eval forward in plain
PyTorch, float32 with TF32 off (``votenet_ref.matmuls``).

It follows Liu et al., "Group-Free 3D Object Detection via Transformers"
(ICCV 2021) and its code (github.com/zeliu98/Group-Free-3D,
``models/detector.py``, ``transformer.py``, ``backbone_module.py``):

- backbone: PointNet++ set abstraction (FPS, ball query, the grouped
  offsets from the centre divided by the radius, shared MLP with batch norm
  and ReLU, max-pool) four times on the coordinates and the points' extra
  channels, then two feature-propagation layers: the seeds;
- KPS sampling: ``points_obj_cls`` scores each seed; the ``num_queries``
  seeds of highest score are the queries; the first head reads them;
- ``num_layers`` decoder layers: ``q = k = v = query + P_s(centre, size)``,
  ``query = LN1(query + SelfAttn(q, k, v))``, ``query = LN2(query +
  CrossAttn(query + P_s, key + P_c(seed xyz), key + P_c(seed xyz)))``,
  ``query = LN3(query + W2 relu(W1 query))``, each attention written out
  head by head: ``softmax((q_h * D^-0.5) k_h^T) v_h``, the heads'
  outputs concatenated and projected;
- a head after sampling and after each layer: its centre is the sampled
  seeds' xyz plus its offset, its size ``res * mean + mean`` of its argmax
  size class; the next layer embeds the two;
- the last head decoded and suppressed by ``head_ref.predict``.

Parameters are a dict keyed by the port's ``state_dict`` names (see
:func:`param_names`), so one set of tensors feeds both sides. It imports
nothing of the program.

Departures from the published code, none of which the program makes
otherwise: the size head is the class-based one (the SUN RGB-D recipe
trains the class-agnostic one); the sampling takes the top scores on the
logits, which order as the sigmoid's scores do without its ties where it
saturates, ties to the lower seed index; the objectness is handed to the
head as the two logits ``(0, x)``, so that ``logit 1 > logit 0`` is
``sigmoid(x) > 0.5``; the FP layers weigh their three neighbours by inverse
squared distance (``votenet_ref.Layers.feature_propagation``, VoteNet's),
where the published PointNet++ weighs by inverse distance.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import head_ref
from portbench.reference.votenet_ref import Layers, Precision, ball_query, fps, gather_rows, matmuls

Params = Dict[str, torch.Tensor]
LN_EPS = 1e-5  # torch.nn.LayerNorm's, which the published decoder layer keeps


def head_channels(cfg: dict) -> int:
    """A head's outputs: objectness 1, centre 3, heading 2 NH, size 4 NS,
    class NC."""
    return 4 + 2 * cfg["num_heading_bin"] + 4 * cfg["num_size_cluster"] + cfg["num_class"]


def set_abstraction(L: Layers, prefix: str, xyz, feats, npoint, radius, nsample, widths):
    new_xyz = gather_rows(xyz, fps(npoint, xyz))
    idx = ball_query(radius, nsample, xyz, new_xyz)
    offsets = (gather_rows(xyz, idx) - new_xyz[:, :, None, :]) / radius
    x = offsets if feats is None else torch.cat([offsets, gather_rows(feats, idx)], dim=-1)
    return new_xyz, torch.amax(L.mlp(x, f"{prefix}.mlp", widths, None), dim=2)


def backbone(L: Layers, points: torch.Tensor, cfg: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    xyz = points[..., :3]
    feats = points[..., 3:] if points.shape[-1] > 3 else None
    outs = []
    for i in range(4):
        xyz, feats = set_abstraction(L, f"backbone.sa{i + 1}", xyz, feats, cfg["sa_npoints"][i], cfg["sa_radii"][i],
                                     cfg["sa_nsamples"][i], cfg["sa_mlps"][i])
        outs.append((xyz, feats))
    (_, _), (l2_xyz, l2), (l3_xyz, l3), (l4_xyz, l4) = outs
    l3 = L.feature_propagation("backbone.fp1", l3_xyz, l4_xyz, l3, l4, cfg["fp_mlps"][0], None)
    return l2_xyz, L.feature_propagation("backbone.fp2", l2_xyz, l3_xyz, l2, l3, cfg["fp_mlps"][1], None)


def attention(P: Params, prefix: str, query: torch.Tensor, key: torch.Tensor, nhead: int) -> torch.Tensor:
    """``nn.MultiheadAttention`` with the value = the key, written out head
    by head."""
    W, b = P[f"{prefix}.in_proj_weight"], P[f"{prefix}.in_proj_bias"]
    E = query.shape[-1]
    D = E // nhead
    q = F.linear(query, W[:E], b[:E])
    k = F.linear(key, W[E:2 * E], b[E:2 * E])
    v = F.linear(key, W[2 * E:], b[2 * E:])
    outs = []
    for h in range(nhead):
        c = slice(h * D, (h + 1) * D)
        scores = (q[..., c] * D ** -0.5) @ k[..., c].transpose(-1, -2)
        outs.append(torch.softmax(scores, dim=-1) @ v[..., c])
    return F.linear(torch.cat(outs, dim=-1), P[f"{prefix}.out_proj.weight"], P[f"{prefix}.out_proj.bias"])


def layer_norm(P: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), P[f"{name}.weight"], P[f"{name}.bias"], eps)


def decoder_layer(L: Layers, prefix: str, query, key, query_pos, key_pos, cfg: dict) -> torch.Tensor:
    P, d, eps = L.P, cfg["d_model"], LN_EPS
    qpe = L.mlp(query_pos, f"{prefix}.self_posembed", (d, d), None, final_activation=False)
    kpe = L.mlp(key_pos, f"{prefix}.cross_posembed", (d, d), None, final_activation=False)
    x = query + qpe
    query = layer_norm(P, f"{prefix}.norm1", query + attention(P, f"{prefix}.self_attn", x, x, cfg["nhead"]), eps)
    kx = key + kpe
    query = layer_norm(P, f"{prefix}.norm2",
                       query + attention(P, f"{prefix}.multihead_attn", query + qpe, kx, cfg["nhead"]), eps)
    ffn = F.linear(torch.relu(F.linear(query, P[f"{prefix}.linear1.weight"], P[f"{prefix}.linear1.bias"])),
                   P[f"{prefix}.linear2.weight"], P[f"{prefix}.linear2.bias"])
    return layer_norm(P, f"{prefix}.norm3", query + ffn, eps)


def predict_head(L: Layers, name: str, x: torch.Tensor, base_xyz: torch.Tensor, cfg: dict):
    """(the head's 78 channels, its centre, its size)."""
    d = cfg["d_model"]
    head = L.mlp(x, name, (d, d, head_channels(cfg)), None, final_activation=False)
    NH, NS = cfg["num_heading_bin"], cfg["num_size_cluster"]
    B, K, _ = head.shape
    s0 = 4 + 2 * NH
    cls = torch.argmax(head[..., s0:s0 + NS], dim=-1)
    res = torch.gather(head[..., s0 + NS:s0 + 4 * NS].reshape(B, K, NS, 3), 2,
                       cls[..., None, None].expand(B, K, 1, 3))[..., 0, :]
    mean = torch.tensor(head_ref.MEAN_SIZE, dtype=torch.float32, device=head.device)[cls]
    return head, base_xyz + head[..., 1:4], res * mean + mean


def forward(params: Params, points: torch.Tensor, cfg: dict) -> Dict[str, torch.Tensor]:
    """The eval forward: points (B, N, 3 + C) -> end points (the port's
    names: the seeds, the sampled queries, each head's channels, centre and
    size, ``proposals_output`` (B, K, 79) and ``proposals_xyz``)."""
    L = Layers(params, cfg, Precision({}), train=False)
    seeds_xyz, seeds = backbone(L, points, cfg)
    d = cfg["d_model"]
    logits = L.mlp(seeds, "points_obj_cls", (d, d, 1), None, final_activation=False)[..., 0]
    inds = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :cfg["num_queries"]]
    xyz, feats = gather_rows(seeds_xyz, inds), gather_rows(seeds, inds)
    ep = {"seeds_xyz": seeds_xyz, "seeds_features": seeds, "seeds_obj_cls_logits": logits,
          "query_points_xyz": xyz, "query_points_sample_inds": inds}
    head, centre, size = predict_head(L, "proposal_head", feats, xyz, cfg)
    ep.update(proposal_head=head, proposal_center=centre, proposal_size=size)
    P = params
    query = F.linear(feats, P["decoder_query_proj.weight"], P["decoder_query_proj.bias"])
    key = F.linear(seeds, P["decoder_key_proj.weight"], P["decoder_key_proj.bias"])
    n = cfg["num_layers"]
    for i in range(n):
        query = decoder_layer(L, f"decoder.{i}", query, key, torch.cat([centre, size], dim=-1), seeds_xyz, cfg)
        head, centre, size = predict_head(L, f"prediction_heads.{i}", query, xyz, cfg)
        prefix = "last_" if i == n - 1 else f"{i}head_"
        ep.update({f"{prefix}head": head, f"{prefix}center": centre, f"{prefix}size": size})
    ep["proposals_output"] = torch.cat([torch.zeros_like(head[..., :1]), head], dim=-1)
    ep["proposals_xyz"] = xyz
    return ep


def eval_forward(params: Params, points: torch.Tensor, cfg: dict, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """The forward without gradients, TF32 matmuls where ``tf32`` (the
    attention's products too)."""
    with torch.no_grad(), matmuls(tf32):
        return forward(params, points, cfg)


def param_names(cfg: dict) -> Tuple[List[Tuple[str, tuple]], List[Tuple[str, tuple]]]:
    """(name, shape) of every parameter and of every batch-norm buffer, in
    the port's ``state_dict`` naming and order."""
    params, buffers = [], []

    def lin(name, cin, cout):
        params.extend([(f"{name}.weight", (cout, cin)), (f"{name}.bias", (cout,))])

    def bn(name, c):
        params.extend([(f"{name}.weight", (c,)), (f"{name}.bias", (c,))])
        buffers.extend([(f"{name}.running_mean", (c,)), (f"{name}.running_var", (c,))])

    def stack(prefix, cin, widths, final_activation=True):
        for j, w in enumerate(widths):
            lin(f"{prefix}.dense{j}", cin, w)
            if final_activation or j < len(widths) - 1:
                bn(f"{prefix}.bn{j}", w)
            cin = w

    cin = cfg["input_feature_dim"]
    for i, widths in enumerate(cfg["sa_mlps"]):
        stack(f"backbone.sa{i + 1}.mlp", 3 + cin, widths)
        cin = widths[-1]
    c2, c3, c4 = (cfg["sa_mlps"][i][-1] for i in (1, 2, 3))
    stack("backbone.fp1.mlp", c4 + c3, cfg["fp_mlps"][0])
    stack("backbone.fp2.mlp", cfg["fp_mlps"][0][-1] + c2, cfg["fp_mlps"][1])
    d, out = cfg["d_model"], head_channels(cfg)
    stack("points_obj_cls", d, (d, d, 1), final_activation=False)
    stack("proposal_head", d, (d, d, out), final_activation=False)
    lin("decoder_key_proj", d, d)
    lin("decoder_query_proj", d, d)
    for i in range(cfg["num_layers"]):
        p = f"decoder.{i}"
        stack(f"{p}.self_posembed", 6, (d, d), final_activation=False)
        stack(f"{p}.cross_posembed", 3, (d, d), final_activation=False)
        for a in ("self_attn", "multihead_attn"):
            params.extend([(f"{p}.{a}.in_proj_weight", (3 * d, d)), (f"{p}.{a}.in_proj_bias", (3 * d,))])
            lin(f"{p}.{a}.out_proj", d, d)
        lin(f"{p}.linear1", d, cfg["dim_feedforward"])
        lin(f"{p}.linear2", cfg["dim_feedforward"], d)
        for j in (1, 2, 3):
            params.extend([(f"{p}.norm{j}.weight", (d,)), (f"{p}.norm{j}.bias", (d,))])
    for i in range(cfg["num_layers"]):
        stack(f"prediction_heads.{i}", d, (d, d, out), final_activation=False)
    return params, buffers


def predict(params: Params, points: torch.Tensor, cfg: dict, tf32: bool = False) -> Dict[str, torch.Tensor]:
    """Every proposal's corners, class, score and the keep mask of the last
    head (``head_ref.predict``)."""
    return head_ref.predict(eval_forward(params, points, cfg, tf32=tf32), cfg)
