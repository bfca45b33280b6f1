"""The VoteNet model, eval and train forward (port of votenet_tpu/models/votenet.py).

Four SA layers and two FP layers, a 3-layer voting MLP that offsets seed
coordinates and features, and the proposal SA layer (FPS on the seeds,
grouping of the votes) ending in the head of
``config.num_proposal_channels`` channels. Module and parameter names follow
the flax tree (``sa1.mlp.dense0``, ``voting.voting0_bn``, ...), so a flax
checkpoint converts by renaming (``models/convert.py``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from votenet_tpu_torch.config import Config
from votenet_tpu_torch.models.pointnet2 import (
    BatchNorm,
    PointNetFPModule,
    PointNetSAModule,
    dense,
    dense_product,
    frozen_running_stats,
    make_linear,
)
from votenet_tpu_torch.ops.dispatch import check_bq_mode
from votenet_tpu_torch.parallel import comm
from votenet_tpu_torch.parallel.mesh import POINTS_AXIS, Mesh, point_sharding


COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(config: Config) -> torch.dtype:
    """``Config.compute_dtype`` as a torch dtype. A name that is not a dtype
    raises TypeError, as ``jnp.dtype`` does; a dtype other than float32 and
    bfloat16 raises NotImplementedError."""
    name = config.compute_dtype
    if name not in COMPUTE_DTYPES:
        try:
            np.dtype(name)
        except TypeError as e:
            raise TypeError(f"compute_dtype: data type {name!r} not understood") from e
        raise NotImplementedError(f"votenet_tpu_torch runs compute_dtype 'float32' or 'bfloat16', got {name!r}")
    return COMPUTE_DTYPES[name]


def check_supported(config: Config) -> None:
    """Raise for a Config this port does not run.

    The port runs every mode of the JAX package's Config. A ``samlp`` other
    than "on" or "off", a ``scatter_precision`` or ``bq_precision`` other
    than "exact" or "fast_bf16", or a ``gather_packing`` other than "none"
    or "bf16_hilo" raises ValueError, as ``votenet_tpu.ops.dispatch`` does;
    ``compute_dtype`` raises as :func:`compute_dtype` says.
    """
    if config.samlp not in ("on", "off"):
        raise ValueError(f"samlp must be 'on' or 'off', got {config.samlp!r}")
    if config.scatter_precision not in ("exact", "fast_bf16"):
        raise ValueError(f"scatter_precision must be 'exact' or 'fast_bf16', got {config.scatter_precision!r}")
    check_bq_mode(config.bq_precision)
    compute_dtype(config)
    if config.gather_packing not in ("none", "bf16_hilo"):
        raise ValueError(f"gather_packing must be 'none' or 'bf16_hilo', got {config.gather_packing!r}")


def _remat_contexts(layer: nn.Module):
    """``checkpoint``'s context_fn under remat: nothing around the first
    forward; the recompute leaves ``layer``'s running statistics alone."""
    return contextlib.nullcontext(), frozen_running_stats(layer)


class VotingModule(nn.Module):
    """Shared FC stack producing per-seed (xyz, feature) offsets:
    Linear + BN + ReLU on all but the last layer, in ``dtype``."""

    def __init__(self, cin: int, units, generator: torch.Generator, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(units)
        self.dtype = dtype
        for i, w in enumerate(units):
            setattr(self, f"voting{i}", make_linear(cin, w, generator))
            if i < self.n - 1:
                setattr(self, f"voting{i}_bn", BatchNorm(w, eps, dtype=dtype))
            cin = w
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            layer = getattr(self, f"voting{i}")
            if i < self.n - 1:  # the batch norm adds the dense bias
                x = getattr(self, f"voting{i}_bn")(dense_product(layer, x, self.dtype), relu=True,
                                                   dense_bias=layer.bias.to(self.dtype))
            else:
                x = dense(layer, x, self.dtype)
        return x


class VoteNet(nn.Module):
    """Full VoteNet inference forward -> end-points dict with the JAX
    model's keys.

    With ``config.samlp == "on"`` the eval forward of the f32 SA layers
    (sa1-sa4 and the proposal layer in f32; sa1 and the proposal layer under
    ``mixed_precision``; none in bf16) runs the fused MLP + max-pool
    (``PointNetSAModule``'s ``samlp``); the flag is fixed when the model is
    built.

    Precision follows ``votenet_tpu/models/votenet.py:96-196``.
    ``compute_dtype="bfloat16"``: every MLP in bf16, coordinates f32.
    ``mixed_precision`` (with f32 ``compute_dtype``): sa2-sa4 in bf16 on the
    split path (f32 coordinates, bf16 features), the rest f32. The seed
    state concatenates f32 coordinates with the seed features and so is f32,
    as are the votes; the head is cast to f32. ``config.scatter_precision``
    is the mode of every training gather's backward scatter,
    ``config.bq_precision`` the mode of every ball query,
    ``config.gather_packing`` the backbone layers' training gather
    (``PointNetSAModule``).

    ``config.remat`` (the JAX model's ``nn.remat`` around sa1-sa4,
    ``votenet.py:114,127``; the FP, voting and proposal layers are not
    wrapped there either): in training with grad enabled, each backbone SA
    layer runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
    only its inputs and recomputes its forward in the backward, dropping the
    grouped (B, npoint, nsample, C) activations between the two. The
    recompute re-runs FPS and the ball query, which are deterministic and
    draw from no generator (so no RNG state is saved), and runs with the
    running statistics' update off (``frozen_running_stats``): the batch
    statistics it normalises with are the first forward's numbers, and the
    running statistics move once a step, as flax's do. Under ``sp_mesh``
    every rank recomputes its layers in the same order, so the recompute's
    collectives pair up across the ranks.

    Weights are drawn from ``generator`` (flax's initialisers: he-normal
    kernels, zero biases, unit batch-norm scales); a checkpoint replaces
    them through ``load_state_dict``. The module starts in eval mode;
    ``train()`` switches batch norm to batch statistics and the SA layers to
    their gather-first path (the JAX model's ``train=True``).

    ``sp_mesh`` shards the large-N backbone over its ``points`` axis (the
    JAX model's ``sp_mesh``, ``votenet.py:75-130``): each backbone SA layer
    whose input cloud holds ``sp_min_points`` points or more, in a number the
    axis divides, runs its grouping stage point-sharded
    (``PointNetSAModule``'s ``sp``). At the default widths only sa1 (20480
    points) qualifies. The forward then takes this rank's slab of the cloud
    (:meth:`local_points`); every output is replicated over the axis. The
    model alone decides this: ``Trainer`` cuts each batch's clouds with
    ``local_points``. A rank's tensors are its own rows already, so the port
    has no ``sp_batch_axis``: no sharded op names the batch axis.
    """

    def __init__(self, config: Config, generator: Optional[torch.Generator] = None,
                 sp_mesh: Optional[Mesh] = None, sp_min_points: int = 4096):
        super().__init__()
        check_supported(config)
        cfg = self.config = config
        if sp_mesh is not None and POINTS_AXIS not in sp_mesh.axis_names:
            raise ValueError(f"sp_mesh {sp_mesh.axis_names} has no {POINTS_AXIS!r} axis")
        self.sp_group: comm.Group = sp_mesh.group(POINTS_AXIS) if sp_mesh is not None else None
        self.sp_input = sp_mesh is not None  # forward takes a slab of the cloud
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        eps = cfg.bn_eps
        samlp = cfg.samlp == "on"
        dt = self.dtype = compute_dtype(cfg)
        mixed = cfg.mixed_precision and dt == torch.float32
        scatter = cfg.scatter_precision
        bq = cfg.bq_precision
        cin = 3  # the input cloud's xyz are also its l0 features
        n_in = cfg.point_num
        for i in range(4):
            sp = sp_mesh is not None and n_in >= sp_min_points and n_in % sp_mesh.size(POINTS_AXIS) == 0
            n_in = cfg.sa_npoints[i]
            sa = PointNetSAModule(
                cfg.sa_npoints[i], cfg.sa_radii[i], cfg.sa_nsamples[i], cin,
                cfg.sa_mlps[i], g, eps=eps,
                coord_grad=False,  # backbone xyz come from the input cloud alone
                samlp=samlp,
                dtype=torch.bfloat16 if mixed and i > 0 else dt,
                split_coords=mixed and i > 0,
                scatter=scatter,
                sp=sp,
                sp_group=self.sp_group,
                bq_precision=bq,
                gather_packing=cfg.gather_packing,
            )
            setattr(self, f"sa{i + 1}", sa)
            cin = cfg.sa_mlps[i][-1]
        c2, c3, c4 = (cfg.sa_mlps[i][-1] for i in (1, 2, 3))
        self.fp1 = PointNetFPModule(c4 + c3, cfg.fp_mlps[0], g, eps=eps, dtype=dt)
        self.fp2 = PointNetFPModule(cfg.fp_mlps[0][-1] + c2, cfg.fp_mlps[1], g, eps=eps, dtype=dt)
        seed_c = cfg.fp_mlps[1][-1]
        if cfg.vote_units[-1] != 3 + seed_c:
            raise ValueError(f"vote_units must end at 3 + {seed_c}, got {cfg.vote_units}")
        self.voting = VotingModule(3 + seed_c, cfg.vote_units, g, eps, dtype=dt)
        self.proposal = PointNetSAModule(
            cfg.proposal_num, cfg.proposal_radius, cfg.proposal_nsample, seed_c,
            cfg.proposal_mlp, g,
            mlp2=tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,),
            eps=eps, samlp=samlp, dtype=dt, scatter=scatter, bq_precision=bq,
        )
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.momentum = cfg.bn_momentum
        self.eval()

    def local_points(self, points):
        """What :meth:`forward` takes of whole (B, N, 3) clouds: this rank's
        slab of them with ``sp_mesh``, else the clouds themselves."""
        return point_sharding(points, self.sp_group) if self.sp_input else points

    def forward(self, points: torch.Tensor) -> Dict[str, torch.Tensor]:
        """points (B, N, 3) f32 -> end points (the JAX model's keys). With
        ``sp_mesh``, points is this rank's (B, N / size, 3) slab."""
        xyz, feats = points, points
        slab = self.sp_input
        remat = self.config.remat and self.training and torch.is_grad_enabled()
        sa_out = []
        for i in range(4):
            sa = getattr(self, f"sa{i + 1}")
            if slab and not sa.sp:  # the whole cloud, from every rank's slab
                xyz = feats = comm.all_gather(xyz, self.sp_group).permute(1, 0, 2, 3).flatten(1, 2)
            elif sa.sp and not slab:  # a replicated input: this rank's slab of it
                xyz, feats = point_sharding(xyz, self.sp_group), point_sharding(feats, self.sp_group)
            if remat:
                xyz, feats, _ = checkpoint(sa, xyz, feats, use_reentrant=False, preserve_rng_state=False,
                                           context_fn=functools.partial(_remat_contexts, sa))
            else:
                xyz, feats, _ = sa(xyz, feats)
            slab = False
            sa_out.append((xyz, feats))
        (_, _), (l2_xyz, l2_points), (l3_xyz, l3_points), (l4_xyz, l4_points) = sa_out

        l3_points = self.fp1(l3_xyz, l4_xyz, l3_points, l4_points)  # the FP layers cast to their dtype
        seeds_points = self.fp2(l2_xyz, l3_xyz, l2_points, l3_points)
        seeds_xyz = l2_xyz

        # votes shift coordinates and features alike; the f32 coordinates
        # promote the seed state, and with it the votes, to f32
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
            "proposals_output": proposals_output.float(),
            "obj_scores": proposals_output[..., :2].float(),
        }
