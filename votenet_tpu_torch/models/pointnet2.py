"""PointNet++ set-abstraction and feature-propagation layers.

Port of :mod:`votenet_tpu.models.pointnet2`, eval and train forward. Every
module starts in eval mode, as the port's ``VoteNet`` does; ``train()``
switches it to the JAX package's ``train=True`` path. Tensors keep the JAX
package's channels-last layout (B, N, C); the reference's 1x1 convolutions
are :class:`torch.nn.Linear` layers on the last axis, whose ``weight`` is
(out, in) (the flax kernel transposed, see ``models/convert.py``). Batch
norm follows flax's ``nn.BatchNorm`` (momentum 0.9 on the running value,
biased fast variance), in its rounding order.

Precision: each module takes the ``dtype`` of its flax counterpart
(``Config.compute_dtype``, and bf16 feature layers under
``Config.mixed_precision``) and rounds where flax rounds, with explicit
casts (``torch.autocast`` would fold a dense layer's bias into its GEMM and
round once, where flax rounds the product and then the sum). Parameters and
batch-norm statistics stay f32 in every mode, so one checkpoint serves all.
The bf16 products run on cuBLAS under the caller's
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(torch's default lets a split-K GEMM reduce its partial sums in bf16, where
XLA reduces in f32). The port leaves that process-wide flag alone: at these
widths (K <= 259) switching it moves no output bit (``chip_smoke.py`` phase
14 runs the forward both ways).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from votenet_tpu_torch import ops
from votenet_tpu_torch.ops.dispatch import samlp_precision

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


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias promoted to
    ``dtype``, the product rounded to ``dtype``, then the bias added in
    ``dtype``. In f32 that is the layer's own fused product and bias."""
    if dtype == torch.float32:
        return layer(x.float())
    return x.to(dtype) @ layer.weight.t().to(dtype) + layer.bias.to(dtype)


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

    As flax's ``_compute_stats`` and ``_normalize``: statistics and the
    normalisation run in f32 whatever the input's dtype, and the output is
    cast to ``dtype``.
    """

    def __init__(
        self, channels: int, eps: float = BN_EPS, momentum: float = BN_MOMENTUM,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
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
        return ((x - mean) * mul + self.bias).to(self.dtype)


class MLPStack(nn.Module):
    """Shared per-point MLP: Linear + BN + ReLU per width (``dense{i}``,
    ``bn{i}``), in ``dtype``. ``final_activation=False`` leaves the last
    layer linear.

    With ``center`` the first layer is the JAX package's ``CenteredDense``:
    ``(h - center @ W[:3]) + b`` in that association, ``x``, ``center``, the
    kernel and the bias all promoted to ``dtype`` first (in bf16 the
    coordinates too, as in the JAX package). Without ``idx``, ``x`` is the
    grouped (B, M, S, Cin) tensor and ``h = x @ W`` (the training path,
    gather first); with ``idx``, ``x`` holds the ungrouped (B, N, Cin) points
    and ``h = gather(x @ W, idx)`` (eval, project before gather).

    Under mixed precision ``x`` is the pair ``(xyz, features)`` instead: the
    split path of ``CenteredDense._split_call``
    (``votenet_tpu/models/pointnet2.py:105-130``), coordinates in f32 and
    features in ``dtype``; see :meth:`_split_dense0`.
    """

    def __init__(
        self,
        cin: int,
        widths: Sequence[int],
        generator: torch.Generator,
        final_activation: bool = True,
        eps: float = BN_EPS,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.n = len(widths)
        self.final_activation = final_activation
        self.dtype = dtype
        for i, w in enumerate(widths):
            setattr(self, f"dense{i}", make_linear(cin, w, generator))
            if final_activation or i < self.n - 1:
                setattr(self, f"bn{i}", BatchNorm(w, eps, dtype=dtype))
            cin = w
        self.eval()

    def forward(
        self,
        x,
        center: Optional[torch.Tensor] = None,
        idx: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        dt = self.dtype
        for i in range(self.n):
            layer = getattr(self, f"dense{i}")
            if i == 0 and isinstance(x, tuple):
                x = self._split_dense0(*x, center, idx)
            elif i == 0 and center is not None:
                w = layer.weight.t().to(dt)  # (in, out)
                x = x.to(dt)
                h = x @ w if idx is None else ops.group_point(x @ w, idx)  # (B, M, S, out)
                x = (h - (center.to(dt) @ w[:3])[:, :, None, :]) + layer.bias.to(dt)
            else:
                x = dense(layer, x, dt)
            if self.final_activation or i < self.n - 1:
                x = torch.relu(getattr(self, f"bn{i}")(x))
        return x

    def _split_dense0(self, xyz: torch.Tensor, feat: torch.Tensor, center: torch.Tensor,
                      idx: Optional[torch.Tensor]) -> torch.Tensor:
        """Mixed precision's first layer: ``xyz @ W[:3]`` in f32 with the
        centre's product subtracted before the cast, ``feat @ W[3:]`` in
        ``dtype``, then ``(h_xyz + h_feat) + b`` in ``dtype``. With ``idx``
        the (B, N, .) sources are gathered here (a narrow f32 gather and a
        wide one of the projected features: eval's project-first form);
        without, they come grouped (training)."""
        dt = self.dtype
        layer = self.dense0
        w = layer.weight.t()
        w_xyz, w_feat = w[:3], w[3:].to(dt)
        feat = feat.to(dt)
        if idx is not None:
            h_feat = ops.group_point(feat @ w_feat, idx)
            xyz = ops.group_point(xyz, idx)
        else:
            h_feat = feat @ w_feat
        h_xyz = xyz @ w_xyz - (center @ w_xyz)[:, :, None, :]
        return (h_xyz.to(dt) + h_feat) + layer.bias.to(dt)


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

    ``samlp=True`` runs the eval forward's MLP and max-pool as one fused op,
    ``ops.fused_sa_mlp_pool`` (the kernel of ``csrc/samlp.cu`` on a CUDA
    tensor), on eval batch norm folded into per-channel scales and shifts:
    the JAX module's ``_fused_eval_mlp_pool`` under ``Config.samlp="on"``,
    its matmul operands in ``ops.dispatch.samlp_precision()`` ("f32" or
    "bf16"), read at every forward as the JAX module reads it. Training
    ignores it, as in the JAX package, and so does an MLP of one
    layer (the fused chain starts at a second layer) or of another dtype than
    f32 (the JAX gate, ``pointnet2.py:304-313``).

    ``dtype`` is the MLPs' (f32 or bf16). ``split_coords`` is the JAX
    module's mixed-precision path (``pointnet2.py:454-467``): a narrow f32
    gather of the coordinates and a wide ``dtype`` one of the features, in
    place of one gather of ``[xyz | points]``; see ``MLPStack``. ``scatter``
    ("exact" or "fast_bf16", ``Config.scatter_precision``) is the mode of the
    training gathers' backward scatter.
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
        samlp: bool = False,
        dtype: torch.dtype = torch.float32,
        split_coords: bool = False,
        scatter: str = "exact",
    ):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.coord_grad = coord_grad
        self.samlp = samlp and len(mlp) >= 2 and dtype == torch.float32
        self.split_coords = split_coords
        self.scatter = scatter
        self.mlp = MLPStack(3 + cin, mlp, generator, eps=eps, dtype=dtype)
        self.mlp2 = (
            MLPStack(mlp[-1], mlp2, generator, final_activation=False, eps=eps, dtype=dtype)
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
        gather_xyz = xyz if self.coord_grad else xyz.detach()
        if self.split_coords:
            feat = points.to(self.mlp.dtype)
            if self.training:
                grouped = (ops.group_point(gather_xyz, idx, scatter=self.scatter),
                           ops.group_point(feat, idx, scatter=self.scatter))
                new_points = self.mlp(grouped, center=new_xyz)
            else:
                new_points = self.mlp((gather_xyz, feat), center=new_xyz, idx=idx)
            new_points = torch.amax(new_points, dim=2)
        elif self.training:
            # torch.cat promotes f32 coordinates and bf16 features to f32, as jnp.concatenate does
            grouped = ops.group_point(
                torch.cat([gather_xyz, points], dim=-1), idx,
                grad_skip_prefix=0 if self.coord_grad else 3, scatter=self.scatter,
            )
            new_points = torch.amax(self.mlp(grouped, center=new_xyz), dim=2)
        elif self.samlp:
            new_points = self._fused_eval_mlp_pool(torch.cat([xyz, points], dim=-1), new_xyz, idx)
        else:
            new_points = self.mlp(torch.cat([xyz, points], dim=-1), center=new_xyz, idx=idx)
            new_points = torch.amax(new_points, dim=2)
        if self.mlp2 is not None:
            new_points = self.mlp2(new_points)
        return new_xyz, new_points, idx

    def _fused_eval_mlp_pool(self, both: torch.Tensor, new_xyz: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """The eval MLP and max-pool through ``ops.fused_sa_mlp_pool``, with
        the fold of ``votenet_tpu/models/pointnet2.py:325-347``: dense0 over
        the N unique points (``h_all``), its centre correction and bias and
        bn0 in the shift ``sh0``, each later layer's bias inside its batch
        norm's shift; the matmuls' operand precision is
        ``samlp_precision()``, read at every call (JAX's ``:349``). Returns
        the pooled (B, npoint, mlp[-1]) features."""
        mlp = self.mlp

        def bn_fold(i):
            bn = getattr(mlp, f"bn{i}")
            s = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
            return s, bn.bias - bn.running_mean * s

        W0 = mlp.dense0.weight.t()  # (in, out)
        h_all = both @ W0
        corr = new_xyz @ W0[:3]
        s0, t0 = bn_fold(0)
        sh0 = (mlp.dense0.bias - corr) * s0 + t0
        layers = []
        for i in range(1, mlp.n):
            dense = getattr(mlp, f"dense{i}")
            si, ti = bn_fold(i)
            layers.append((dense.weight.t(), si, dense.bias * si + ti))
        return ops.fused_sa_mlp_pool(h_all, idx, sh0, s0, layers, samlp_precision())


class PointNetFPModule(nn.Module):
    """Feature propagation: inverse-squared-distance interpolation from the
    3 nearest coarse points, concatenated with the skip features, then an MLP.
    Distances and weights are f32; the interpolation and the MLP run in
    ``dtype`` (``votenet_tpu/models/pointnet2.py:618-637``)."""

    def __init__(self, cin: int, mlp: Sequence[int], generator: torch.Generator, eps: float = BN_EPS,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLPStack(cin, mlp, generator, eps=eps, dtype=dtype)
        self.eval()

    def forward(self, xyz1, xyz2, points1, points2):
        """xyz1 (B, N, 3) fine, xyz2 (B, M, 3) coarse, points1 (B, N, C1),
        points2 (B, M, C2) -> (B, N, mlp[-1])."""
        dt = self.mlp.dtype
        dist, idx = ops.three_nn(xyz1, xyz2)
        inv = 1.0 / torch.clamp(dist, min=1e-10)
        weight = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
        interpolated = ops.three_interpolate(points2.to(dt), idx, weight.to(dt))
        return self.mlp(torch.cat([interpolated, points1.to(dt)], dim=2))
