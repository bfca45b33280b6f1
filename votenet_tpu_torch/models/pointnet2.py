"""PointNet++ set-abstraction and feature-propagation layers.

Port of :mod:`votenet_tpu.models.pointnet2`, eval and train forward. Every
module starts in eval mode, as the port's ``VoteNet`` does; ``train()``
switches it to the JAX package's ``train=True`` path. Tensors keep the JAX
package's channels-last layout (B, N, C); the reference's 1x1 convolutions
are :class:`torch.nn.Linear` layers on the last axis, whose ``weight`` is
(out, in) (the flax kernel transposed, see ``models/convert.py``). Batch
norm follows flax's ``nn.BatchNorm`` (momentum 0.9 on the running value,
biased fast variance), in its rounding order.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from votenet_tpu_torch import ops

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: the weight of the old running value


def he_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``he_normal``: truncated normal at +-2 std, variance 2 / fan_in.

    ``weight`` is (out, in); 0.87962566 is the std of a unit normal cut at 2.
    """
    std = math.sqrt(2.0 / weight.shape[1]) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def make_linear(cin: int, cout: int, generator: torch.Generator) -> nn.Linear:
    layer = nn.Linear(cin, cout)
    he_normal_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class BatchNorm(nn.Module):
    """Batch norm over the last axis, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.

    In training mode (``self.training``) mean and var are the batch's, taken
    over every axis but the last as flax 0.12 does (``_compute_stats`` with
    ``use_fast_variance=True``): ``mean = E[x]``, ``var = max(0, E[x^2] -
    mean^2)``, biased. The running statistics then move in place, outside
    autograd, to ``momentum * running + (1 - momentum) * batch``: flax's
    convention, where ``momentum=0.9`` weights the old value (torch's
    ``F.batch_norm`` weights the new one and updates the variance unbiased,
    so it is not used). In eval mode the running statistics normalise.
    """

    def __init__(self, channels: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = torch.clamp((x * x).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class MLPStack(nn.Module):
    """Shared per-point MLP: Linear + BN + ReLU per width (``dense{i}``,
    ``bn{i}``). ``final_activation=False`` leaves the last layer linear.

    With ``center`` the first layer is the JAX package's ``CenteredDense``:
    ``(h - center @ W[:3]) + b`` in that association. Without ``idx``, ``x``
    is the grouped (B, M, S, Cin) tensor and ``h = x @ W`` (the training
    path, gather first); with ``idx``, ``x`` holds the ungrouped (B, N, Cin)
    points and ``h = gather(x @ W, idx)`` (eval, project before gather).
    """

    def __init__(
        self,
        cin: int,
        widths: Sequence[int],
        generator: torch.Generator,
        final_activation: bool = True,
        eps: float = BN_EPS,
    ):
        super().__init__()
        self.n = len(widths)
        self.final_activation = final_activation
        for i, w in enumerate(widths):
            setattr(self, f"dense{i}", make_linear(cin, w, generator))
            if final_activation or i < self.n - 1:
                setattr(self, f"bn{i}", BatchNorm(w, eps))
            cin = w
        self.eval()

    def forward(
        self,
        x: torch.Tensor,
        center: Optional[torch.Tensor] = None,
        idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        for i in range(self.n):
            dense = getattr(self, f"dense{i}")
            if i == 0 and center is not None:
                w = dense.weight.t()  # (in, out)
                h = x @ w if idx is None else ops.group_point(x @ w, idx)  # (B, M, S, out)
                x = (h - (center @ w[:3])[:, :, None, :]) + dense.bias
            else:
                x = dense(x)
            if self.final_activation or i < self.n - 1:
                x = torch.relu(getattr(self, f"bn{i}")(x))
        return x


class PointNetSAModule(nn.Module):
    """Set abstraction with ball-query grouping and max pooling (the JAX
    module's fused path, ``pointnet2.py:422-525``).

    FPS picks ``npoint`` centres (on ``sample_xyz`` when given: the proposal
    layer samples seeds but groups votes), the ball query groups
    ``[xyz | points]`` around them, the MLP runs, the ball slots are
    max-pooled, and the optional ``mlp2`` head follows with a linear last
    layer. Eval projects before the gather; training gathers first
    (``pointnet2.py:468-515``), so that the backward scatters the narrow
    ``[xyz | points]`` rows and not the wide dense0 output.

    ``coord_grad=False`` declares ``xyz`` non-differentiable: the backbone's
    coordinates derive from the input cloud alone. They are detached before
    the gather, and its backward scatters only the feature channels. The
    proposal layer keeps ``True``: its xyz are votes, which carry gradient.
    Pooling is ``torch.amax``, which, like ``jnp.max``, splits the gradient
    evenly among tied maxima (ties are common: the ball query fills empty
    slots with the first hit).
    """

    def __init__(
        self,
        npoint: int,
        radius: float,
        nsample: int,
        cin: int,
        mlp: Sequence[int],
        generator: torch.Generator,
        mlp2: Optional[Sequence[int]] = None,
        eps: float = BN_EPS,
        coord_grad: bool = True,
    ):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.coord_grad = coord_grad
        self.mlp = MLPStack(3 + cin, mlp, generator, eps=eps)
        self.mlp2 = (
            MLPStack(mlp[-1], mlp2, generator, final_activation=False, eps=eps)
            if mlp2 is not None
            else None
        )
        self.eval()

    def forward(
        self,
        xyz: torch.Tensor,
        points: torch.Tensor,
        sample_xyz: Optional[torch.Tensor] = None,
    ):
        """xyz (B, N, 3), points (B, N, C) -> (new_xyz (B, npoint, 3),
        features (B, npoint, C'), idx (B, npoint, nsample) int32)."""
        fps_src = sample_xyz if sample_xyz is not None else xyz
        new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(self.npoint, fps_src))
        idx, _ = ops.query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        if self.training:
            gather_xyz = xyz if self.coord_grad else xyz.detach()
            grouped = ops.group_point(
                torch.cat([gather_xyz, points], dim=-1), idx,
                grad_skip_prefix=0 if self.coord_grad else 3,
            )
            new_points = self.mlp(grouped, center=new_xyz)
        else:
            new_points = self.mlp(torch.cat([xyz, points], dim=-1), center=new_xyz, idx=idx)
        new_points = torch.amax(new_points, dim=2)
        if self.mlp2 is not None:
            new_points = self.mlp2(new_points)
        return new_xyz, new_points, idx


class PointNetFPModule(nn.Module):
    """Feature propagation: inverse-squared-distance interpolation from the
    3 nearest coarse points, concatenated with the skip features, then an MLP."""

    def __init__(self, cin: int, mlp: Sequence[int], generator: torch.Generator, eps: float = BN_EPS):
        super().__init__()
        self.mlp = MLPStack(cin, mlp, generator, eps=eps)
        self.eval()

    def forward(self, xyz1, xyz2, points1, points2):
        """xyz1 (B, N, 3) fine, xyz2 (B, M, 3) coarse, points1 (B, N, C1),
        points2 (B, M, C2) -> (B, N, mlp[-1])."""
        dist, idx = ops.three_nn(xyz1, xyz2)
        inv = 1.0 / torch.clamp(dist, min=1e-10)
        weight = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
        interpolated = ops.three_interpolate(points2, idx, weight)
        return self.mlp(torch.cat([interpolated, points1], dim=2))
