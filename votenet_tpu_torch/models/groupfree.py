"""Group-Free 3D (Liu et al., ICCV 2021, arXiv:2104.00678): a transformer
decoder over a PointNet++ backbone, eval forward.

The published model (github.com/zeliu98/Group-Free-3D, ``models/detector.py``,
``models/transformer.py``, ``models/backbone_module.py``), channels last as
the rest of the port:

- the backbone: four SA layers whose grouped offsets are divided by the
  ball's radius (``PointNetSAModule(normalize_xyz=True)``), sa1 on the
  coordinates and ``input_feature_dim`` more channels of each point (the
  height above the floor), and two FP layers, the second ending at
  ``d_model`` channels: the seeds;
- KPS sampling: ``points_obj_cls`` (dense, batch norm, ReLU twice, then one
  logit) scores each seed, and the ``num_queries`` seeds of highest logit,
  in descending order with ties to the lower seed index, become the
  queries; a first prediction head reads their features;
- ``num_layers`` decoder layers of ``d_model`` channels, ``nhead`` heads and
  a ``dim_feedforward`` FFN, post-norm (``transformer.py``'s
  ``TransformerDecoderLayer``)::

      q = k = v = query + P_s(loc);  query = LN1(query + SelfAttn(q, k, v))
      query = LN2(query + CrossAttn(query + P_s(loc), key + P_c(xyz), key + P_c(xyz)))
      query = LN3(query + W2 relu(W1 query))

  where ``P_s`` embeds the last head's centre and size (6 inputs,
  "loc_learned"), ``P_c`` the seeds' coordinates (3, "xyz_learned"), each
  dense, batch norm, ReLU, dense, and a layer's own; the values carry the
  position embedding as the keys do, as the published code passes them;
- a prediction head after sampling and after each layer (dense, batch
  norm, ReLU twice, then the 78 channels of objectness (1), centre offset
  (3), heading class and residual (NH + NH), size class and residual (NS +
  3 NS) and class (NC)). Each head's centre is the sampled seeds' xyz plus
  its offset and its size ``mean * res + mean`` of its size class, the
  published ``detector.py`` passing ``base_xyz=cluster_xyz`` to every head;
  the next layer embeds that centre and size.

Eval reads the last head: ``proposals_output`` is it in the port's
``5 + 2 NH + 4 NS + NC`` layout, the objectness as the logits ``(0, x)``
(``predict_boxes``' candidate test ``logit[1] > logit[0]`` is then
``sigmoid(x) > 0.5``), and ``proposals_xyz`` the sampled seeds' xyz, so the
port's head (decode, IoU, NMS greedy) runs it unchanged. Dropout is absent
in eval; training is not ported (:meth:`GroupFree3D.train` raises).

Departures from the published code: the size head is the class-based one
(the SUN RGB-D recipe trains the class-agnostic one); the FP layers weigh
the three neighbours by inverse squared distance, as the port's VoteNet
does (the published PyTorch PointNet++ weighs by inverse distance).

Spans (``utils/profiling.py``): ``votenet.gf.backbone``, ``votenet.gf.sampling``
(with the first head), ``votenet.gf.decoder`` (the projections, the layers
and their heads) and, inside it, ``votenet.gf.layer`` with the layer's index
as its unit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from votenet_tpu_torch import ops
from votenet_tpu_torch.config import Config, default_config, tiny_config
from votenet_tpu_torch.models.decode import class_mean_size
from votenet_tpu_torch.models.pointnet2 import (
    BatchNorm,
    MLPStack,
    PointNetFPModule,
    PointNetSAModule,
    he_normal_,
    make_linear,
)
from votenet_tpu_torch.models.votenet import check_supported
from votenet_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class GroupFreeConfig:
    """Group-Free 3D's settings: ``base`` holds the backbone's and the
    head's (SA and FP widths, the classes, ``proposal_num`` = the queries,
    NMS), the fields the decoder's."""

    base: Config
    num_queries: int = 256
    num_layers: int = 6
    d_model: int = 288
    nhead: int = 8
    dim_feedforward: int = 2048
    input_feature_dim: int = 1

    def replace(self, **kw) -> "GroupFreeConfig":
        return dataclasses.replace(self, **kw)


def groupfree_config(**overrides) -> GroupFreeConfig:
    """Group-Free 3D's SUN RGB-D model, L6 O256 with the PointNet++ backbone
    at width 1: 20000 points of 3 + 1 channels, SA layers of 2048/1024/512/256
    centres, radii 0.2/0.4/0.8/1.2 and 64/32/16/16 samples, fp2 ending at
    288 channels, 256 queries, NMS at IoU 0.25."""
    base = default_config(point_num=20000, sa_nsamples=(64, 32, 16, 16), fp_mlps=((256, 256), (256, 288)),
                          proposal_num=256, max_detections=256, nms_iou=0.25)
    return GroupFreeConfig(base=base, **overrides)


def tiny_groupfree_config(**overrides) -> GroupFreeConfig:
    """Scaled-down Group-Free 3D for CPU tests (the same topology)."""
    base = tiny_config(sa_nsamples=(8, 8, 4, 4), fp_mlps=((64, 64), (64, 48)), proposal_num=16, max_detections=16)
    fields = dict(num_queries=16, num_layers=2, d_model=48, nhead=4, dim_feedforward=64)
    fields.update(overrides)
    return GroupFreeConfig(base=base, **fields)


def head_channels(cfg: Config) -> int:
    """A prediction head's outputs: objectness 1, centre 3, heading 2 NH,
    size 4 NS, class NC."""
    return 4 + 2 * cfg.num_heading_bin + 4 * cfg.num_size_cluster + cfg.num_class


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters (``in_proj_weight``
    (3E, E) for q, k and v stacked, ``in_proj_bias``, ``out_proj``) on
    channels-last (B, L, E) tensors; the attention itself is
    ``ops.multi_head_attention`` (one kernel on the card). Where the keys
    are the values (both attentions of the decoder), k and v come from one
    product; where the queries are too, q as well."""

    def __init__(self, d: int, nhead: int, generator: torch.Generator):
        super().__init__()
        self.d, self.nhead = d, nhead
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        he_normal_(self.in_proj_weight, generator)
        self.out_proj = make_linear(d, d, generator)

    def forward(self, query: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
        """query (B, Lq, E), key = value (B, Lk, E) -> (B, Lq, E)."""
        d, W, b = self.d, self.in_proj_weight, self.in_proj_bias
        if query is key:
            q, k, v = F.linear(query, W, b).split(d, dim=-1)
        else:
            q = F.linear(query, W[:d], b[:d])
            k, v = F.linear(key, W[d:], b[d:]).split(d, dim=-1)
        return self.out_proj(ops.multi_head_attention(q, k, v, self.nhead))


class DecoderLayer(nn.Module):
    """``transformer.py``'s ``TransformerDecoderLayer`` in eval, with its own
    position embeddings (``self_posembed`` over 6 inputs, ``cross_posembed``
    over 3)."""

    def __init__(self, gcfg: GroupFreeConfig, generator: torch.Generator):
        super().__init__()
        d, eps = gcfg.d_model, gcfg.base.bn_eps
        self.self_posembed = MLPStack(6, (d, d), generator, final_activation=False, eps=eps)
        self.cross_posembed = MLPStack(3, (d, d), generator, final_activation=False, eps=eps)
        self.self_attn = MultiheadAttention(d, gcfg.nhead, generator)
        self.multihead_attn = MultiheadAttention(d, gcfg.nhead, generator)
        self.linear1 = make_linear(d, gcfg.dim_feedforward, generator)
        self.linear2 = make_linear(gcfg.dim_feedforward, d, generator)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}", nn.LayerNorm(d))  # eps 1e-5, as the published layer's

    def forward(self, query: torch.Tensor, key: torch.Tensor, query_pos: torch.Tensor,
                key_pos: torch.Tensor) -> torch.Tensor:
        qpe = self.self_posembed(query_pos)
        kpe = self.cross_posembed(key_pos)
        x = query + qpe
        query = self.norm1(query + self.self_attn(x, x))
        query = self.norm2(query + self.multihead_attn(query + qpe, key + kpe))
        return self.norm3(query + self.linear2(torch.relu(self.linear1(query))))


class Backbone(nn.Module):
    """``backbone_module.py``'s ``Pointnet2Backbone`` at width 1: sa1-sa4 with
    the radius normalisation, fp1 and fp2. points (B, N, 3 + C) -> (seeds'
    xyz (B, sa_npoints[1], 3), seeds' features (B, sa_npoints[1],
    fp_mlps[1][-1]))."""

    def __init__(self, gcfg: GroupFreeConfig, generator: torch.Generator):
        super().__init__()
        cfg = gcfg.base
        cin = gcfg.input_feature_dim
        for i in range(4):
            setattr(self, f"sa{i + 1}", PointNetSAModule(
                cfg.sa_npoints[i], cfg.sa_radii[i], cfg.sa_nsamples[i], cin, cfg.sa_mlps[i], generator,
                eps=cfg.bn_eps, coord_grad=False, samlp=cfg.samlp == "on", bq_precision=cfg.bq_precision,
                normalize_xyz=True))
            cin = cfg.sa_mlps[i][-1]
        c2, c3, c4 = (cfg.sa_mlps[i][-1] for i in (1, 2, 3))
        self.fp1 = PointNetFPModule(c4 + c3, cfg.fp_mlps[0], generator, eps=cfg.bn_eps)
        self.fp2 = PointNetFPModule(cfg.fp_mlps[0][-1] + c2, cfg.fp_mlps[1], generator, eps=cfg.bn_eps)

    def forward(self, points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:].contiguous() if points.shape[-1] > 3 else None
        out = []
        for i in range(4):
            xyz, feats, _ = getattr(self, f"sa{i + 1}")(xyz, feats)
            out.append((xyz, feats))
        (_, _), (l2_xyz, l2_feats), (l3_xyz, l3_feats), (l4_xyz, l4_feats) = out
        l3_feats = self.fp1(l3_xyz, l4_xyz, l3_feats, l4_feats)
        return l2_xyz, self.fp2(l2_xyz, l3_xyz, l2_feats, l3_feats)


class GroupFree3D(nn.Module):
    """Group-Free 3D's eval forward: points (B, N, 3 + input_feature_dim)
    f32 -> end points (see the module docstring): ``seeds_xyz``,
    ``seeds_features``, ``seeds_obj_cls_logits`` (B, S), ``query_points_xyz``
    and ``query_points_sample_inds`` (B, K), each head's ``<prefix>head``
    (B, K, 78 raw channels), ``<prefix>center`` and ``<prefix>size`` (prefixes
    ``proposal_``, ``0head_`` ... and ``last_``), and the last head as
    ``proposals_output`` (B, K, 79) with ``proposals_xyz`` (B, K, 3), which
    ``predict_boxes(end_points, gcfg.base)`` reads.

    Weights are drawn from ``generator`` (he-normal kernels, the attention's
    in-projections among them, zero biases, unit batch-norm and LayerNorm
    scales); a state dict replaces them through ``load_state_dict``. The
    model runs in f32 (TF32 off is the caller's, as ``make_packed_predict_fn``
    sets it), in eval mode only."""

    def __init__(self, gcfg: GroupFreeConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = gcfg.base
        check_supported(cfg)
        if cfg.compute_dtype != "float32" or cfg.mixed_precision:
            raise NotImplementedError("GroupFree3D runs in float32 (compute_dtype 'float32', no mixed precision)")
        if cfg.fp_mlps[1][-1] != gcfg.d_model:
            raise ValueError(f"the seeds' width fp_mlps[1][-1] = {cfg.fp_mlps[1][-1]} must be d_model "
                             f"{gcfg.d_model}")
        if cfg.proposal_num != gcfg.num_queries or gcfg.num_queries > cfg.sa_npoints[1]:
            raise ValueError(f"num_queries {gcfg.num_queries} must equal proposal_num {cfg.proposal_num} and fit "
                             f"the {cfg.sa_npoints[1]} seeds")
        if gcfg.d_model % gcfg.nhead:
            raise ValueError(f"d_model {gcfg.d_model} is not a multiple of nhead {gcfg.nhead}")
        self.gcfg = gcfg
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        d, eps = gcfg.d_model, cfg.bn_eps
        out = head_channels(cfg)
        self.backbone = Backbone(gcfg, g)
        self.points_obj_cls = MLPStack(d, (d, d, 1), g, final_activation=False, eps=eps)
        self.proposal_head = MLPStack(d, (d, d, out), g, final_activation=False, eps=eps)
        self.decoder_key_proj = make_linear(d, d, g)
        self.decoder_query_proj = make_linear(d, d, g)
        self.decoder = nn.ModuleList(DecoderLayer(gcfg, g) for _ in range(gcfg.num_layers))
        self.prediction_heads = nn.ModuleList(
            MLPStack(d, (d, d, out), g, final_activation=False, eps=eps) for _ in range(gcfg.num_layers))
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.momentum = cfg.bn_momentum
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("GroupFree3D's training (its losses and label assignment) is not ported")
        return super().train(False)

    def _box(self, head: torch.Tensor, base_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A head's centre (base + offset) and size (``mean * res + mean`` of
        the argmax size class)."""
        cfg = self.gcfg.base
        NH, NS = cfg.num_heading_bin, cfg.num_size_cluster
        B, K, _ = head.shape
        s0 = 4 + 2 * NH
        cls = torch.argmax(head[..., s0:s0 + NS], dim=-1)
        res = torch.gather(head[..., s0 + NS:s0 + 4 * NS].reshape(B, K, NS, 3), 2,
                           cls[..., None, None].expand(B, K, 1, 3))[..., 0, :]
        mean = class_mean_size(head.device)[cls]
        return base_xyz + head[..., 1:4], res * mean + mean

    def forward(self, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        gcfg = self.gcfg
        ep: Dict[str, torch.Tensor] = {}
        with annotate("votenet.gf.backbone"):
            seeds_xyz, seeds = self.backbone(points)
        with annotate("votenet.gf.sampling"):
            logits = self.points_obj_cls(seeds)[..., 0]
            inds = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :gcfg.num_queries]
            xyz = ops.gather_point(seeds_xyz, inds)
            feats = ops.gather_point(seeds, inds)
            head = self.proposal_head(feats)
            centre, size = self._box(head, xyz)
        ep.update(seeds_xyz=seeds_xyz, seeds_features=seeds, seeds_obj_cls_logits=logits, query_points_xyz=xyz,
                  query_points_sample_inds=inds, proposal_head=head, proposal_center=centre, proposal_size=size)
        with annotate("votenet.gf.decoder"):
            query = self.decoder_query_proj(feats)
            key = self.decoder_key_proj(seeds)
            for i, (layer, predict) in enumerate(zip(self.decoder, self.prediction_heads)):
                with annotate("votenet.gf.layer", i):
                    query = layer(query, key, torch.cat([centre, size], dim=-1), seeds_xyz)
                    head = predict(query)
                    centre, size = self._box(head, xyz)
                prefix = "last_" if i == gcfg.num_layers - 1 else f"{i}head_"
                ep.update({f"{prefix}head": head, f"{prefix}center": centre, f"{prefix}size": size})
        ep["proposals_output"] = F.pad(head, (1, 0))  # objectness (0, x): logit 1 > logit 0 is sigmoid(x) > 0.5
        ep["proposals_xyz"] = xyz
        return ep
