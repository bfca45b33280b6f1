"""The VoteNet model, inference forward (port of votenet_tpu/models/votenet.py).

Four SA layers and two FP layers, a 3-layer voting MLP that offsets seed
coordinates and features, and the proposal SA layer (FPS on the seeds,
grouping of the votes) ending in the head of
``config.num_proposal_channels`` channels. Module and parameter names follow
the flax tree (``sa1.mlp.dense0``, ``voting.voting0_bn``, ...), so a flax
checkpoint converts by renaming (``models/convert.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from votenet_tpu.config import Config
from votenet_tpu_torch.models.pointnet2 import (
    BatchNorm,
    PointNetFPModule,
    PointNetSAModule,
    make_linear,
)


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for a Config this port does not run yet.

    The port runs the parity defaults. The ROADMAP item named in each
    message brings the rest.
    """
    unsupported = {
        "compute_dtype": (config.compute_dtype, "float32", "opt-in modes (bf16 serving)"),
        "mixed_precision": (config.mixed_precision, False, "opt-in modes (mixed precision)"),
        "bq_precision": (config.bq_precision, "exact", "opt-in modes (fast_bf16 ball query)"),
        "samlp": (config.samlp, "off", "opt-in modes plus kernel 5 (fused SA MLP+pool)"),
    }
    for name, (value, supported, item) in unsupported.items():
        if value != supported:
            raise NotImplementedError(
                f"votenet_tpu_torch runs {name}={supported!r} only, got {value!r}: "
                f"see ROADMAP.md, 'Modules still to port', {item}"
            )


class VotingModule(nn.Module):
    """Shared FC stack producing per-seed (xyz, feature) offsets:
    Linear + BN + ReLU on all but the last layer."""

    def __init__(self, cin: int, units, generator: torch.Generator, eps: float):
        super().__init__()
        self.n = len(units)
        for i, w in enumerate(units):
            setattr(self, f"voting{i}", make_linear(cin, w, generator))
            if i < self.n - 1:
                setattr(self, f"voting{i}_bn", BatchNorm(w, eps))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"voting{i}")(x)
            if i < self.n - 1:
                x = torch.relu(getattr(self, f"voting{i}_bn")(x))
        return x


class VoteNet(nn.Module):
    """Full VoteNet inference forward -> end-points dict with the JAX
    model's keys.

    Weights are drawn from ``generator`` (flax's initialisers: he-normal
    kernels, zero biases, unit batch-norm scales); a checkpoint replaces
    them through ``load_state_dict``. The module is always in eval mode:
    training batch norm comes with the training port.
    """

    def __init__(self, config: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        eps = cfg.bn_eps
        cin = 3  # the input cloud's xyz are also its l0 features
        for i in range(4):
            sa = PointNetSAModule(
                cfg.sa_npoints[i], cfg.sa_radii[i], cfg.sa_nsamples[i], cin,
                cfg.sa_mlps[i], g, eps=eps,
            )
            setattr(self, f"sa{i + 1}", sa)
            cin = cfg.sa_mlps[i][-1]
        c2, c3, c4 = (cfg.sa_mlps[i][-1] for i in (1, 2, 3))
        self.fp1 = PointNetFPModule(c4 + c3, cfg.fp_mlps[0], g, eps=eps)
        self.fp2 = PointNetFPModule(cfg.fp_mlps[0][-1] + c2, cfg.fp_mlps[1], g, eps=eps)
        seed_c = cfg.fp_mlps[1][-1]
        if cfg.vote_units[-1] != 3 + seed_c:
            raise ValueError(f"vote_units must end at 3 + {seed_c}, got {cfg.vote_units}")
        self.voting = VotingModule(3 + seed_c, cfg.vote_units, g, eps)
        self.proposal = PointNetSAModule(
            cfg.proposal_num, cfg.proposal_radius, cfg.proposal_nsample, seed_c,
            cfg.proposal_mlp, g,
            mlp2=tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,),
            eps=eps,
        )
        self.eval()

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(
                "votenet_tpu_torch runs inference only: see ROADMAP.md, "
                "'Modules still to port', training step"
            )
        return super().train(False)

    def forward(self, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        """points (B, N, 3) f32 -> end points (the JAX model's keys)."""
        xyz, feats = points, points
        sa_out = []
        for i in range(4):
            xyz, feats, _ = getattr(self, f"sa{i + 1}")(xyz, feats)
            sa_out.append((xyz, feats))
        (_, _), (l2_xyz, l2_points), (l3_xyz, l3_points), (l4_xyz, l4_points) = sa_out

        l3_points = self.fp1(l3_xyz, l4_xyz, l3_points, l4_points)
        seeds_points = self.fp2(l2_xyz, l3_xyz, l2_points, l3_points)
        seeds_xyz = l2_xyz

        # votes shift coordinates and features alike
        seed_state = torch.cat([seeds_xyz, seeds_points], dim=2)
        votes = seed_state + self.voting(seed_state)
        votes_xyz = votes[:, :, :3]
        votes_points = votes[:, :, 3:]

        proposals_xyz, proposals_output, _ = self.proposal(
            votes_xyz, votes_points, sample_xyz=seeds_xyz
        )
        return {
            "seeds_xyz": seeds_xyz,
            "seeds_points": seeds_points,
            "votes_xyz": votes_xyz,
            "votes_points": votes_points,
            "proposals_xyz": proposals_xyz,
            "proposals_output": proposals_output,
            "obj_scores": proposals_output[..., :2],
        }
