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
batch-norm statistics stay f32 in every mode, so one checkpoint serves all;
a bf16 layer multiplies by a bf16 copy of its weight made once a parameter
version (``models/bf16_copies.py``), the bits of the per-call cast.
The bf16 products run on cuBLAS under the caller's
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(torch's default lets a split-K GEMM reduce its partial sums in bf16, where
XLA reduces in f32). The port leaves that process-wide flag alone: at these
widths (K <= 259) switching it moves no output bit (``chip_smoke.py`` phase
14 runs the forward both ways).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
from torch import nn

from votenet_tpu_torch import ops
from votenet_tpu_torch.models import bf16_copies
from votenet_tpu_torch.models.bf16_copies import bf16_view
from votenet_tpu_torch.ops.dispatch import samlp_precision
from votenet_tpu_torch.parallel import comm
from votenet_tpu_torch.parallel import point_sharded as sp_ops

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
    ``dtype``. In f32 that is the layer's own fused product and bias. A
    dense layer that a batch norm follows leaves its bias to the batch
    norm's prologue instead (:func:`dense_product`)."""
    if dtype == torch.float32:
        return layer(x.float())
    return dense_product(layer, x, dtype) + bf16_view(layer, "bias", dtype)


def dense_product(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x @ W`` of ``nn.Dense(dtype=dtype)``, rounded to ``dtype``, without
    its bias: the h of a batch-norm site, whose op adds the bias
    (``BatchNorm.forward``'s ``dense_bias``). W is the layer's bf16 copy
    where it keeps one (``bf16_copies``)."""
    return x.to(dtype) @ bf16_view(layer, "weight", dtype).t()


class BatchNorm(nn.Module):
    """Batch norm over the last axis, in flax's order:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, through
    ``ops.batch_norm_relu`` (four hand-written kernels on the card, their
    plain versions on the CPU; see ``ops/batchnorm.py``).

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
    cast to ``dtype``. ``forward(h, relu=True)`` also applies the ReLU, in
    the same op (the MLP stacks' and the voting module's call), and takes
    the layer around it: x = ``h + dense_bias``, or ``(h - corr[..., None,
    :]) + dense_bias`` (the centred first layer), or the split first
    layer's ``coords`` (its coordinate term), formed inside the op;
    ``pool="max"`` returns the max over the slots (axis -2) of the output
    (an SA layer's last width). See ``ops/batchnorm.py``.

    ``group`` (set by :func:`batch_norm_group`) makes it synced batch norm
    over a data-parallel group: the sums of x and x^2 and the row count are
    all-reduced over its ranks (each rank normalises its own rows, so the
    backward sums the sums' cotangents, ``comm.psum_varying``'s rule), and
    the statistics are the whole batch's, identical on every rank, as the
    JAX package's are over its mesh. In one process the sums are the same
    ones.

    ``frozen`` (set by :func:`frozen_running_stats`) keeps the running
    statistics where they are in training.
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
        self.group: comm.Group = None
        self.frozen = False  # set by frozen_running_stats
        self.eval()

    def forward(self, x: torch.Tensor, relu: bool = False, *, dense_bias: Optional[torch.Tensor] = None,
                corr: Optional[torch.Tensor] = None, pool: Optional[str] = None, coords=None) -> torch.Tensor:
        return ops.batch_norm_relu(
            x, self.weight, self.bias, self.running_mean, self.running_var, training=self.training,
            momentum=self.momentum, eps=self.eps, group=self.group, update_stats=not self.frozen, dtype=self.dtype,
            relu=relu, dense_bias=dense_bias, corr=corr, pool=pool, coords=coords,
        )


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Within the block, every training :class:`BatchNorm` of ``model``
    normalises by the batch's statistics as always but does not move its
    running statistics: remat's recompute (``models/votenet.py``) runs a
    layer's forward a second time, and flax's ``nn.remat`` updates the
    statistics once a step."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m in bns:
            m.frozen = False


@contextlib.contextmanager
def batch_norm_group(model: nn.Module, group: comm.Group):
    """Within the block, every :class:`BatchNorm` of ``model`` takes its
    training statistics over the ranks of ``group`` (None: this rank's rows
    alone)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.group = group
    try:
        yield
    finally:
        for m in bns:
            m.group = None


class MLPStack(nn.Module):
    """Shared per-point MLP: Linear + BN + ReLU per width (``dense{i}``,
    ``bn{i}``), in ``dtype``. ``final_activation=False`` leaves the last
    layer linear; ``use_bn=False`` drops the batch norms (a dense layer with
    its bias, then the ReLU).

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

    Each dense layer that a batch norm follows hands the batch norm its
    product h and its f32 bias, which the op rounds to ``dtype`` (and the
    first layer its centre correction
    ``center @ W[:3]``, or the split first layer the grouped coordinates,
    the centres and W[:3], the split prologue's ``coords``): the op forms x
    of them (``BatchNorm.forward``), so x is never stored. ``pool="max"``
    (an SA layer's max-pool; the last width must have its batch norm) makes
    the last batch norm return the max over the slots (axis 2), (B, M, C).
    In bf16 the weights (and the biases that no batch norm takes) are the
    layers' bf16 copies (``bf16_copies``).
    """

    def __init__(
        self,
        cin: int,
        widths: Sequence[int],
        generator: torch.Generator,
        final_activation: bool = True,
        eps: float = BN_EPS,
        dtype: torch.dtype = torch.float32,
        use_bn: bool = True,
    ):
        super().__init__()
        self.n = len(widths)
        self.final_activation = final_activation
        self.dtype = dtype
        self.use_bn = use_bn
        for i, w in enumerate(widths):
            setattr(self, f"dense{i}", make_linear(cin, w, generator))
            if use_bn and (final_activation or i < self.n - 1):
                setattr(self, f"bn{i}", BatchNorm(w, eps, dtype=dtype))
            if dtype == torch.bfloat16:  # the bias too where no batch norm takes it (dense())
                bf16_copies.register(getattr(self, f"dense{i}"), "weight",
                                     *(() if hasattr(self, f"bn{i}") else ("bias",)))
            cin = w
        bf16_copies.attach(self)
        self.eval()

    def forward(
        self,
        x,
        center: Optional[torch.Tensor] = None,
        idx: Optional[torch.Tensor] = None,
        pool: Optional[str] = None,
    ) -> torch.Tensor:
        dt = self.dtype
        if pool is not None and not hasattr(self, f"bn{self.n - 1}"):
            raise ValueError("MLPStack: pool takes the last width's batch norm")
        for i in range(self.n):
            layer = getattr(self, f"dense{i}")
            bn = getattr(self, f"bn{i}", None)
            last_pool = pool if i == self.n - 1 else None
            corr = b = coords = None
            if i == 0 and isinstance(x, tuple):
                h, coords = self._split_dense0(*x, center, idx)
                b = layer.bias  # the op rounds the f32 bias to dt (the prologue), or below without a batch norm
                if bn is None or last_pool:  # no split prologue (a pooled width): the coordinate term formed here
                    xyz, cen, w3 = coords
                    h, coords = (xyz @ w3 - (cen @ w3)[:, :, None, :]).to(dt) + h, None
            elif i == 0 and center is not None:
                w = bf16_view(layer, "weight", dt).t()  # (in, out)
                x = x.to(dt)
                h = x @ w if idx is None else ops.group_point(x @ w, idx)  # (B, M, S, out)
                corr, b = center.to(dt) @ w[:3], layer.bias  # the op rounds the f32 bias to dt
            elif bn is not None:
                h, b = dense_product(layer, x, dt), layer.bias
            else:
                h = dense(layer, x, dt)
            if bn is not None:
                x = bn(h, relu=True, dense_bias=b, corr=corr, pool=last_pool, coords=coords)
            else:
                x = h if corr is None else h - corr[:, :, None, :]
                x = x if b is None else x + bf16_view(layer, "bias", dt)
                if self.final_activation or i < self.n - 1:
                    x = torch.relu(x)
        return x

    def _split_dense0(self, xyz: torch.Tensor, feat: torch.Tensor, center: torch.Tensor,
                      idx: Optional[torch.Tensor]):
        """Mixed precision's first layer, ``(h_xyz + h_feat) + b`` in
        ``dtype``: returns ``h_feat = feat @ W[3:]`` in ``dtype`` (the layer's
        bf16 copy of W[3:] in bf16) and the coordinate term's inputs
        ``(xyz, center, W[:3])``, the grouped f32 coordinates (B, M, S, 3),
        the f32 centres and the f32 rows of the kernel, from which the batch
        norm's split prologue forms ``h_xyz = xyz @ W[:3] - center @ W[:3]``
        in f32 and rounds it to ``dtype`` (the f32 (B, M, S, C) term is never
        stored). With ``idx`` the (B, N, .) sources are gathered here (a
        narrow f32 gather and a wide one of the projected features: eval's
        project-first form); without, they come grouped (training)."""
        dt = self.dtype
        layer = self.dense0
        w = layer.weight.t()
        w_feat = bf16_view(layer, "feat", dt) if dt == torch.bfloat16 else w[3:].to(dt)
        feat = feat.to(dt)
        if idx is not None:
            h_feat = ops.group_point(feat @ w_feat, idx)
            xyz = ops.group_point(xyz, idx)
        else:
            h_feat = feat @ w_feat
        return h_feat, (xyz, center, w[:3])


def split_hilo(x: torch.Tensor):
    """``gather_packing="bf16_hilo"``'s coordinate split: ``hi = bf16(x)``,
    ``lo = bf16(x - f32(hi))``; ``f32(hi) + f32(lo)`` rebuilds ``x`` to ~16
    significant bits."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor, points: Optional[torch.Tensor],
                     knn: bool = False, use_xyz: bool = True, sample_xyz: Optional[torch.Tensor] = None,
                     bq_precision: Optional[str] = None):
    """FPS, gather, ball query (or kNN), group, centre-subtract (the JAX
    ``sample_and_group``, reference utils.py:25-61). FPS runs on
    ``sample_xyz`` when given. ``bq_precision`` is the ball query's mode
    (None: ``ops.dispatch.bq_precision()``). Returns (new_xyz (B, npoint,
    3), new_points (B, npoint, nsample, 3 + C, C or 3), idx (B, npoint,
    nsample) int32, grouped_xyz (B, npoint, nsample, 3) centred)."""
    fps_src = sample_xyz if sample_xyz is not None else xyz
    new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(npoint, fps_src))
    if knn:
        _, idx = ops.knn_point(nsample, xyz, new_xyz)
    else:
        idx, _ = ops.query_ball_point(radius, nsample, xyz, new_xyz, bq_precision)
    if points is None:
        grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
        return new_xyz, grouped_xyz, idx, grouped_xyz
    both = ops.group_point(torch.cat([xyz, points], dim=-1), idx)  # one gather of [xyz | features]
    grouped_xyz = both[..., :3] - new_xyz[:, :, None, :]
    new_points = torch.cat([grouped_xyz, both[..., 3:]], dim=-1) if use_xyz else both[..., 3:]
    return new_xyz, new_points, idx, grouped_xyz


def sample_and_group_all(xyz: torch.Tensor, points: Optional[torch.Tensor], use_xyz: bool = True):
    """One group of all points, centred at the origin (the JAX
    ``sample_and_group_all``, utils.py:64-90): (new_xyz (B, 1, 3) zeros,
    new_points (B, 1, N, 3 + C, C or 3), idx (B, 1, N) int32 0..N-1,
    grouped_xyz (B, 1, N, 3) the points themselves)."""
    B, N, _ = xyz.shape
    new_xyz = torch.zeros((B, 1, 3), dtype=xyz.dtype, device=xyz.device)
    idx = torch.arange(N, dtype=torch.int32, device=xyz.device).expand(B, 1, N)
    grouped_xyz = xyz[:, None, :, :]
    if points is None:
        return new_xyz, grouped_xyz, idx, grouped_xyz
    new_points = torch.cat([xyz, points], dim=-1) if use_xyz else points
    return new_xyz, new_points[:, None, :, :], idx, grouped_xyz


POOLINGS = ("max", "avg", "weighted_avg", "max_and_avg")


class PointNetSAModule(nn.Module):
    """Set abstraction (the JAX module, ``pointnet2.py:233-555``).

    FPS picks ``npoint`` centres (on ``sample_xyz`` when given: the proposal
    layer samples seeds but groups votes), the ball query groups
    ``[xyz | points]`` around them, the MLP runs, the ball slots are
    pooled, and the optional ``mlp2`` head follows with a linear last
    layer. ``points`` may be None (the grouped coordinates alone).

    The reference's other options, on no path of the model: ``group_all``
    (one group of every point, :func:`sample_and_group_all`), ``knn`` (the
    ``nsample`` nearest points, ``ops.knn_point``, in place of the ball),
    ``use_xyz=False`` (the features alone, without the centred
    coordinates), ``use_bn=False`` (no batch norm) and ``pooling`` "avg",
    "weighted_avg" (``exp(-5 d)`` weights over the centred grouped
    coordinates' norms, normalised over the slots) or "max_and_avg" (the
    mean's channels, then the max's). As in the JAX module, ``group_all``,
    ``use_xyz=False``, "weighted_avg" and an empty ``mlp`` take the
    explicit path (:func:`sample_and_group`, the centred grouped tensor
    into a plain MLP, in training and eval alike); the rest take the fused
    path described below.

    Fused path (``pointnet2.py:422-525``): eval projects before the gather;
    training gathers first (``pointnet2.py:468-515``), so that the backward
    scatters the narrow ``[xyz | points]`` rows and not the wide dense0
    output.

    ``coord_grad=False`` declares ``xyz`` non-differentiable: the backbone's
    coordinates derive from the input cloud alone. They are detached before
    the gather, and its backward scatters only the feature channels. The
    proposal layer keeps ``True``: its xyz are votes, which carry gradient.
    Max pooling is ``torch.amax``, which, like ``jnp.max``, splits the
    gradient evenly among tied maxima (ties are common: the ball query fills
    empty slots with the first hit). On the fused and point-sharded paths
    with batch norm (``mlp_pool``) the last batch norm of the MLP takes
    it (``MLPStack``'s ``pool``): the full last layer is not stored; the
    explicit path and the other poolings pool eagerly.

    ``samlp=True`` runs the eval forward's MLP and max-pool as one fused op,
    ``ops.fused_sa_mlp_pool`` (the kernel of ``csrc/samlp.cu`` on a CUDA
    tensor), on eval batch norm folded into per-channel scales and shifts:
    the JAX module's ``_fused_eval_mlp_pool`` under ``Config.samlp="on"``,
    its matmul operands in ``ops.dispatch.samlp_precision()`` ("f32" or
    "bf16"), read at every forward as the JAX module reads it. Training
    ignores it, as in the JAX package, and so do the explicit path, a
    pooling other than max, ``use_bn=False``, an MLP of one layer (the
    fused chain starts at a second layer) and another dtype than f32 (the
    JAX gate, ``pointnet2.py:304-313``).

    ``dtype`` is the MLPs' (f32 or bf16). ``split_coords`` is the JAX
    module's mixed-precision path (``pointnet2.py:454-467``): a narrow f32
    gather of the coordinates and a wide ``dtype`` one of the features, in
    place of one gather of ``[xyz | points]``; see ``MLPStack``. ``scatter``
    ("exact" or "fast_bf16", ``Config.scatter_precision``) is the mode of the
    training gathers' backward scatter. ``bq_precision`` ("exact",
    "fast_bf16", ``Config.bq_precision``) is the ball query's; None reads
    ``ops.dispatch.bq_precision()`` at every forward.

    ``gather_packing="bf16_hilo"`` (``Config.gather_packing``, the JAX
    module's packed transport, ``pointnet2.py:467-505``) changes the fused
    training gather of a layer with ``coord_grad=False`` and features: one
    bf16 gather of ``[xyz_hi | xyz_lo | features]``, ``hi = bf16(xyz)`` and
    ``lo = bf16(xyz - f32(hi))``, the coordinates rebuilt in f32 as ``hi +
    lo`` (~16 significant bits) and fed with the bf16 features to the split
    first layer (``MLPStack._split_dense0``); the backward scatters the
    feature channels' bf16 cotangent (``grad_skip_prefix=6``). The JAX
    module needs an optimization barrier there against an XLA fold of the
    round trip; eager PyTorch folds nothing. Mixed precision's split path
    and the point-sharded path take precedence, and eval is unchanged, as
    in the JAX module.

    ``normalize_xyz=True`` divides the grouped coordinates' offsets from
    their centre by the ball's radius before the MLP (Group-Free 3D's
    backbone, ``models/groupfree.py``), on the fused path in training and
    eval alike; the MLP takes ``x / r`` and ``c / r`` where it took the
    coordinates and the centres, so that the offsets are ``x / r - c / r``.
    The default leaves the arithmetic as it was, bit for bit; the explicit
    and point-sharded paths raise ValueError with it.

    ``sp=True`` runs the grouping stage point-sharded over ``sp_group``
    (the JAX module's ``sp_mesh``, ``pointnet2.py:370-420``): ``xyz`` and
    ``points`` are this rank's slabs of the cloud, FPS, the centres' gather,
    the ball query and the grouped gather run through
    :mod:`votenet_tpu_torch.parallel.point_sharded`, and the MLP and the
    pool run on the replicated grouped tensor, gather-first in training and
    in eval alike (samlp is not taken), as the JAX module does. It takes the
    ball-query grouping only (``group_all`` and ``knn`` raise ValueError, as
    does mixed precision's split coordinates, as in the JAX package).
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
        sp: bool = False,
        sp_group: comm.Group = None,
        group_all: bool = False,
        pooling: str = "max",
        knn: bool = False,
        use_xyz: bool = True,
        use_bn: bool = True,
        bq_precision: Optional[str] = None,
        gather_packing: str = "none",
        normalize_xyz: bool = False,
    ):
        super().__init__()
        if normalize_xyz and (sp or group_all or not use_xyz or pooling == "weighted_avg" or len(mlp) == 0):
            raise ValueError("normalize_xyz is wired on the fused path only")
        if sp and split_coords:
            raise ValueError("sp + split_coords (mixed precision) is not wired; run SP in f32")
        if sp and (group_all or knn):
            raise ValueError("sp_mesh supports ball-query grouping only (no knn/group_all)")
        if pooling not in POOLINGS:
            raise ValueError(f"unknown pooling {pooling!r}")
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.sp, self.sp_group = sp, sp_group
        self.group_all, self.pooling, self.knn, self.use_xyz = group_all, pooling, knn, use_xyz
        self.bq_precision = bq_precision
        self.normalize_xyz = normalize_xyz
        self.fused = not group_all and use_xyz and pooling != "weighted_avg" and len(mlp) > 0
        self.coord_grad = coord_grad
        self.mlp_pool = "max" if pooling == "max" and use_bn and len(mlp) > 0 else None  # the fused paths' pool
        self.samlp = (samlp and self.fused and pooling == "max" and use_bn and len(mlp) >= 2
                      and dtype == torch.float32)
        self.split_coords = split_coords
        self.scatter = scatter
        self.packed = gather_packing == "bf16_hilo" and not coord_grad
        c_mlp = 3 + cin if use_xyz or cin == 0 else cin  # cin == 0: the coordinates alone
        self.mlp = MLPStack(c_mlp, mlp, generator, eps=eps, dtype=dtype, use_bn=use_bn)
        c_pool = mlp[-1] if len(mlp) else c_mlp
        self.mlp2 = (
            MLPStack(2 * c_pool if pooling == "max_and_avg" else c_pool, mlp2, generator, final_activation=False,
                     eps=eps, dtype=dtype, use_bn=use_bn)
            if mlp2 is not None
            else None
        )
        if dtype == torch.bfloat16 and (split_coords or self.packed) and len(mlp) > 0:
            bf16_copies.register(self.mlp.dense0, "feat")  # the split first layer's W[3:]
        bf16_copies.attach(self)
        self.eval()

    def forward(
        self,
        xyz: torch.Tensor,
        points: Optional[torch.Tensor],
        sample_xyz: Optional[torch.Tensor] = None,
    ):
        """xyz (B, N, 3), points (B, N, C) or None -> (new_xyz (B, npoint,
        3), features (B, npoint, C'), idx (B, npoint, nsample) int32)."""
        if self.sp:
            new_xyz, new_points, idx = self._sharded_forward(xyz, points, sample_xyz)
        elif not self.fused:
            if self.group_all:
                new_xyz, grouped, idx, grouped_xyz = sample_and_group_all(xyz, points, self.use_xyz)
            else:
                new_xyz, grouped, idx, grouped_xyz = sample_and_group(
                    self.npoint, self.radius, self.nsample, xyz, points, self.knn, self.use_xyz, sample_xyz,
                    self.bq_precision,
                )
            new_points = self._pool(self.mlp(grouped), grouped_xyz)
        else:
            new_xyz, new_points, idx = self._fused_forward(xyz, points, sample_xyz)
        if self.mlp2 is not None:
            new_points = self.mlp2(new_points)
        return new_xyz, new_points, idx

    def _pool(self, x: torch.Tensor, grouped_xyz: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, M, S, C) -> (B, M, C), or 2C for "max_and_avg"
        (``pointnet2.py:540-555``)."""
        if self.pooling == "max":
            return torch.amax(x, dim=2)
        if self.pooling == "avg":
            return torch.mean(x, dim=2)
        if self.pooling == "weighted_avg":  # exp(-5d) inverse-distance weights (utils.py:135-142)
            e = torch.exp(-torch.linalg.vector_norm(grouped_xyz, dim=-1, keepdim=True) * 5)
            return torch.sum(x * (e / torch.sum(e, dim=2, keepdim=True)), dim=2)
        return torch.cat([torch.mean(x, dim=2), torch.amax(x, dim=2)], dim=-1)

    def _fused_forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor], sample_xyz):
        fps_src = sample_xyz if sample_xyz is not None else xyz
        new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(self.npoint, fps_src))
        if self.knn:
            _, idx = ops.knn_point(self.nsample, xyz, new_xyz)
        else:
            idx, _ = ops.query_ball_point(self.radius, self.nsample, xyz, new_xyz, self.bq_precision)
        centre = new_xyz
        if self.normalize_xyz:  # the offsets over the radius, (x - c) / r, formed as x / r - c / r
            xyz, centre = xyz / self.radius, new_xyz / self.radius
        gather_xyz = xyz if self.coord_grad else xyz.detach()
        if self.split_coords and points is not None:
            feat = points.to(self.mlp.dtype)
            if self.training:
                grouped = (ops.group_point(gather_xyz, idx, scatter=self.scatter),
                           ops.group_point(feat, idx, scatter=self.scatter))
                new_points = self.mlp(grouped, center=centre, pool=self.mlp_pool)
            else:
                new_points = self.mlp((gather_xyz, feat), center=centre, idx=idx, pool=self.mlp_pool)
        elif self.training and self.packed and points is not None:
            hi, lo = split_hilo(gather_xyz)
            table = torch.cat([hi, lo, points.to(torch.bfloat16)], dim=-1)
            g = ops.group_point(table, idx, grad_skip_prefix=6, scatter=self.scatter)
            new_points = self.mlp((g[..., :3].float() + g[..., 3:6].float(), g[..., 6:]), center=centre,
                                  pool=self.mlp_pool)
        elif self.training:
            # torch.cat promotes f32 coordinates and bf16 features to f32, as jnp.concatenate does
            both = gather_xyz if points is None else torch.cat([gather_xyz, points], dim=-1)
            skip = 0 if self.coord_grad or points is None else 3
            grouped = ops.group_point(both, idx, grad_skip_prefix=skip, scatter=self.scatter)
            new_points = self.mlp(grouped, center=centre, pool=self.mlp_pool)
        else:
            dt = self.mlp.dtype
            if points is None:
                both = xyz
            elif points.dtype == dt != torch.float32:
                # features already in dt: the coordinates' rounding alone, no cast of an f32 concatenation (which
                # would round the features a second time, and costs a launch)
                both = torch.cat([xyz.to(dt), points], dim=-1)
            else:
                both = torch.cat([xyz, points], dim=-1)
            if self.samlp:  # pooled by the fused op
                return new_xyz, self._fused_eval_mlp_pool(both, centre, idx), idx
            new_points = self.mlp(both, center=centre, idx=idx, pool=self.mlp_pool)
        return new_xyz, self._pool_rest(new_points), idx

    def _pool_rest(self, x: torch.Tensor) -> torch.Tensor:
        """The fused paths' pool where the MLP has not taken it."""
        return x if self.mlp_pool else self._pool(x, None)

    def _sharded_forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor], sample_xyz):
        """The forward over this rank's slabs of a point-sharded cloud (see
        the class docstring), up to the pool; the outputs are replicated
        over ``sp_group``."""
        g = self.sp_group
        if not self.fused:
            new_xyz, grouped, idx, grouped_xyz = sp_ops.sample_and_group_sharded(
                self.npoint, self.radius, self.nsample, xyz, points, g, self.use_xyz, self.bq_precision)
            return new_xyz, self._pool(self.mlp(grouped), grouped_xyz), idx
        fps_src = sample_xyz if sample_xyz is not None else xyz
        new_xyz = sp_ops.gather_point_sharded(xyz, sp_ops.farthest_point_sample_sharded(self.npoint, fps_src, g), g)
        idx, _ = sp_ops.query_ball_point_sharded(self.radius, self.nsample, xyz, new_xyz, g, self.bq_precision)
        gather_xyz = xyz if self.coord_grad else xyz.detach()
        both = gather_xyz if points is None else torch.cat([gather_xyz, points], dim=-1)
        grouped = sp_ops.group_point_sharded(
            both, idx, g, grad_skip_prefix=0 if self.coord_grad or points is None else 3, scatter=self.scatter,
        )
        return new_xyz, self._pool_rest(self.mlp(grouped, center=new_xyz, pool=self.mlp_pool)), idx

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


class PointNetSAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction (the JAX module,
    ``pointnet2.py:565-602``, reference utils.py:161-201; on no path of the
    model). FPS picks ``npoint`` centres; for each scale i, the ball of
    ``radius_list[i]`` and ``nsample_list[i]`` groups the features and the
    centred coordinates, concatenated in the reference's reversed order
    ``[grouped, grouped_xyz]`` (``use_xyz``; the features alone without it,
    the coordinates alone where ``cin`` is 0), ``mlp_scale{i}`` runs on
    them and the slots are max-pooled; the scales' features are
    concatenated. The ball query's mode is ``ops.dispatch.bq_precision()``,
    read at every forward, as the JAX module reads it. Returns (new_xyz
    (B, npoint, 3), (B, npoint, sum of the scales' last widths))."""

    def __init__(
        self,
        npoint: int,
        radius_list: Sequence[float],
        nsample_list: Sequence[int],
        cin: int,
        mlp_list: Sequence[Sequence[int]],
        generator: torch.Generator,
        use_xyz: bool = True,
        use_bn: bool = True,
        eps: float = BN_EPS,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.npoint = npoint
        self.radius_list, self.nsample_list = tuple(radius_list), tuple(nsample_list)
        self.use_xyz = use_xyz
        c_in = cin + 3 if use_xyz or cin == 0 else cin
        for i, widths in enumerate(mlp_list):
            setattr(self, f"mlp_scale{i}", MLPStack(c_in, widths, generator, eps=eps, dtype=dtype, use_bn=use_bn))
        bf16_copies.attach(self)
        self.eval()

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        new_xyz = ops.gather_point(xyz, ops.farthest_point_sample(self.npoint, xyz))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list, self.nsample_list)):
            idx, _ = ops.query_ball_point(radius, nsample, xyz, new_xyz)
            grouped_xyz = ops.group_point(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = ops.group_point(points, idx)
                if self.use_xyz:  # the reversed order of utils.py:190
                    grouped = torch.cat([grouped, grouped_xyz], dim=-1)
            else:
                grouped = grouped_xyz
            outs.append(torch.amax(getattr(self, f"mlp_scale{i}")(grouped), dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


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
