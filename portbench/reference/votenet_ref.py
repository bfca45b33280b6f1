"""The plain VoteNet that decides ``correct``: forward (eval and train),
loss, per-leaf clip and Adam, in plain PyTorch.

It follows the model the configuration file states (``portbench/configs``):
PointNet++ set abstraction (FPS, ball query, centred grouping, shared MLP
with batch norm and ReLU, max-pool), two feature-propagation layers, the
voting MLP and the proposal layer with its head, as in Qi et al. (ICCV
2019) and the reference's ``model.py``. Parameters are a dict keyed by the
port's ``state_dict`` names (``sa1.mlp.dense0.weight`` (out, in), ...), so
one set of tensors feeds both sides. It imports nothing of the program.

Precision: every layer computes in float32 with TF32 off (:func:`matmuls`).
A layer whose dtype the configuration states as ``bfloat16`` rounds, as
that dtype does, the matmul operands and products, the bias sum and the
batch norm's output; its coordinate term stays float32, as the
configuration's mixed-precision recipe states. Rounding is an op of its own
whose backward rounds the cotangent the same way. :class:`Precision` with
``low="fp8"`` rounds those same points to scaled float8 instead: the
control one step below bfloat16.

Departures from the program, none of which moves a result beyond rounding:
the grouped coordinates are centred before the first layer (the program
subtracts ``centre @ W[:3]`` after it); eval batch norm is torch's; the
head decodes in float64. Training batch norm is the model's (flax's fast
variance, :class:`_TrainBatchNorm`).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def matmuls(tf32: bool):
    """Within the block, float32 matmuls run in TF32 when ``tf32``, else in
    full float32; the flags are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _scaled_fp8(dtype: torch.dtype, fmax: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def rnd(t: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(t.detach().abs().amax(), min=1e-30) / fmax
        return (t / s).to(dtype).to(t.dtype) * s

    return rnd


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


LOW = {
    "bfloat16": (_bf16, _bf16),
    # per-tensor scaled float8: e4m3 for values, e5m2 for cotangents
    "fp8": (_scaled_fp8(torch.float8_e4m3fn, 448.0), _scaled_fp8(torch.float8_e5m2, 57344.0)),
}


class Precision:
    """Which layers round, and to what. ``layer_dtypes`` maps a layer name
    (``sa1`` ... ``proposal``) to ``float32`` or ``bfloat16``; ``low`` is the
    rounding of the ``bfloat16`` layers: ``bfloat16`` (as stated) or ``fp8``
    (the control)."""

    def __init__(self, layer_dtypes: Dict[str, str], low: str = "bfloat16"):
        self.layer_dtypes = dict(layer_dtypes)
        self.low = low

    def q(self, layer: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
        if self.layer_dtypes.get(layer, "float32") == "float32":
            return None
        fwd, bwd = LOW[self.low]
        return lambda t: _Round.apply(t, fwd, bwd)


# ----------------------------------------------------------------- point ops


def fps(npoint: int, xyz: torch.Tensor) -> torch.Tensor:
    """Farthest-point sampling from index 0: (B, N, 3) -> (B, npoint)
    int64; distances ``(dx*dx + dy*dy) + dz*dz`` in float32, the first
    maximal index on ties."""
    B, N, _ = xyz.shape
    x, y, z = xyz.detach().float().unbind(-1)
    mindist = torch.full((B, N), 1e38, dtype=torch.float32, device=xyz.device)
    idx = torch.zeros((B, npoint), dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        mindist = torch.minimum(mindist, dx * dx + dy * dy + dz * dz)
        last = torch.argmax(mindist, dim=-1)
        idx[:, i] = last
    return idx


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, centres: torch.Tensor,
               rows_per_block: int = 512) -> torch.Tensor:
    """The first ``nsample`` points (in index order) with squared distance
    strictly under float32(radius)^2; slots past the last hit repeat the
    first hit, an empty ball is index 0. (B, N, 3), (B, M, 3) -> (B, M,
    nsample) int64."""
    xyz = xyz.detach().float()
    centres = centres.detach().float()
    B, M = centres.shape[:2]
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = float(r * r)
    out = torch.empty((B, M, nsample), dtype=torch.long, device=xyz.device)
    want = torch.arange(1, nsample + 1, device=xyz.device)
    slot = torch.arange(nsample, device=xyz.device)
    for b in range(B):
        for m0 in range(0, M, rows_per_block):
            d = centres[b, m0:m0 + rows_per_block, None, :] - xyz[b, None, :, :]
            dx, dy, dz = d.unbind(-1)
            hit = (dx * dx + dy * dy + dz * dz) < r2
            cum = torch.cumsum(hit.to(torch.int32), dim=-1)
            pos = torch.searchsorted(cum, want.to(torch.int32).expand(hit.shape[0], nsample).contiguous())
            cnt = torch.clamp(cum[:, -1], max=nsample)
            pos = torch.where(slot < cnt[:, None], pos, pos[:, :1])
            out[b, m0:m0 + rows_per_block] = torch.where(cnt[:, None] > 0, pos, torch.zeros_like(pos))
    return out


def gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, ...) int -> (B, ..., C)."""
    B, _, C = t.shape
    flat = idx.reshape(B, -1)
    return torch.gather(t, 1, flat[..., None].expand(-1, -1, C)).reshape(*idx.shape, C)


def three_nn(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """The 3 nearest xyz2 points of each xyz1 point: (dist2, idx), (B, N,
    3); the lowest index among equal distances."""
    d = xyz1.detach()[:, :, None, :] - xyz2.detach()[:, None, :, :]
    dx, dy, dz = d.unbind(-1)
    d = dx * dx + dy * dy + dz * dz
    dists, idxs = [], []
    for _ in range(3):
        i = torch.argmin(d, dim=-1, keepdim=True)
        dists.append(torch.gather(d, -1, i))
        idxs.append(i)
        d = d.scatter(-1, i, float("inf"))
    return torch.cat(dists, -1), torch.cat(idxs, -1)


# ----------------------------------------------------------------- layers


class _TrainBatchNorm(torch.autograd.Function):
    """Training batch norm of (R, C) rows as the model states it (flax's
    fast variance): ``mean = E[x]``, ``var = max(E[x^2] - mean^2, 0)``, the
    sums taken in float64 and the rest in float32, ``y = (x - mean) *
    (rsqrt(var + eps) * w) + b``. Its backward is autograd's of that
    formula written out, so that only x is kept: ``dx = s w (g - E[g]) - w
    s^3 (x - mean) E[g (x - mean)]`` with ``s = rsqrt(var + eps)``, the
    second term dropped where the clamp holds."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        R = x.shape[0]
        mean = (torch.sum(x, 0, dtype=torch.float64) / R).float()
        var_raw = (torch.sum(x * x, 0, dtype=torch.float64) / R).float() - mean * mean
        s = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
        ctx.save_for_backward(x, w, mean, s, var_raw)
        return (x - mean) * (s * w) + b

    @staticmethod
    def backward(ctx, g):
        x, w, mean, s, var_raw = ctx.saved_tensors
        R = x.shape[0]
        xc = x - mean
        sum_g = torch.sum(g, 0, dtype=torch.float64).float()
        sum_gx = torch.sum(g * xc, 0, dtype=torch.float64).float()
        var_term = torch.where(var_raw < 0, 0.0, w * s ** 3 * (sum_gx / R))
        dx = (s * w) * (g - sum_g / R) - xc * var_term
        return dx, sum_gx * s, sum_g, None


class Layers:
    """The model's layers over one parameter dict, in train or eval mode.
    Train mode normalises by the batch's statistics (the biased variance);
    the running statistics are not moved (nothing compares them)."""

    def __init__(self, params: Params, cfg: dict, prec: Precision, train: bool):
        self.P = params
        self.cfg = cfg
        self.prec = prec
        self.train = train

    def dense(self, x, name, q):
        W, b = self.P[name + ".weight"], self.P[name + ".bias"]
        if q is None:
            return F.linear(x, W, b)
        return q(q(q(x) @ q(W).t()) + q(b))

    def batch_norm(self, x, name, q, relu=True):
        w, b = self.P[name + ".weight"], self.P[name + ".bias"]
        C = x.shape[-1]
        if self.train:  # the batch's statistics; the running statistics stay
            y = _TrainBatchNorm.apply(x.reshape(-1, C), w, b, self.cfg["bn_eps"])
        else:
            y = F.batch_norm(x.reshape(-1, C), self.P[name + ".running_mean"], self.P[name + ".running_var"], w, b,
                             training=False, eps=self.cfg["bn_eps"])
        y = y.view(x.shape)
        y = y if q is None else q(y)
        return torch.relu(y) if relu else y

    def mlp(self, x, prefix, widths, q, final_activation=True):
        for j in range(len(widths)):
            h = self.dense(x, f"{prefix}.dense{j}", q)
            if final_activation or j < len(widths) - 1:
                x = self.batch_norm(h, f"{prefix}.bn{j}", q)
            else:
                x = h
        return x

    def first_layer(self, gxyz, gfeat, prefix, q):
        """The SA layer's first dense layer on ``[centred coordinates |
        features]``; in a rounded layer the coordinate term stays float32
        and is rounded once, the feature term runs in the low precision."""
        name = f"{prefix}.dense0"
        if q is None:
            return self.dense(torch.cat([gxyz, gfeat], dim=-1), name, None)
        W, b = self.P[name + ".weight"], self.P[name + ".bias"]
        coord = q(gxyz @ W[:, :3].t())
        feat = q(q(gfeat) @ q(W[:, 3:]).t())
        return q(q(coord + feat) + q(b))

    def set_abstraction(self, prefix, xyz, feats, npoint, radius, nsample, widths, q,
                        sample_xyz=None, mlp2=None):
        new_xyz = gather_rows(xyz, fps(npoint, sample_xyz if sample_xyz is not None else xyz))
        idx = ball_query(radius, nsample, xyz, new_xyz)

        def grouped_mlp(xyz, feats, new_xyz):
            gxyz = gather_rows(xyz, idx) - new_xyz[:, :, None, :]
            x = self.batch_norm(self.first_layer(gxyz, gather_rows(feats, idx), f"{prefix}.mlp", q),
                                f"{prefix}.mlp.bn0", q)
            for j in range(1, len(widths)):
                x = self.batch_norm(self.dense(x, f"{prefix}.mlp.dense{j}", q), f"{prefix}.mlp.bn{j}", q)
            return torch.amax(x, dim=2)

        if torch.is_grad_enabled():  # the grouped activations are recomputed in the backward, not kept
            x = checkpoint(grouped_mlp, xyz, feats, new_xyz, use_reentrant=False)
        else:
            x = grouped_mlp(xyz, feats, new_xyz)
        if mlp2 is not None:
            x = self.mlp(x, f"{prefix}.mlp2", mlp2, q, final_activation=False)
        return new_xyz, x

    def feature_propagation(self, prefix, xyz1, xyz2, p1, p2, widths, q):
        dist, idx = three_nn(xyz1, xyz2)
        inv = 1.0 / torch.clamp(dist, min=1e-10)
        w = inv / ((inv[..., 0:1] + inv[..., 1:2]) + inv[..., 2:3])
        g = gather_rows(p2, idx)  # (B, N, 3, C)
        interp = (g * w[..., None]).sum(2)
        return self.mlp(torch.cat([interp, p1], dim=-1), f"{prefix}.mlp", widths, q)


def forward(params: Params, points: torch.Tensor, cfg: dict, prec: Precision, train: bool) -> Dict:
    """The VoteNet forward: points (B, N, 3) -> end points (seeds, votes,
    proposals and the head's raw channels), all float32."""
    L = Layers(params, cfg, prec, train)
    xyz, feats = points, points
    outs = []
    for i in range(4):
        name = f"sa{i + 1}"
        xyz, feats = L.set_abstraction(name, xyz, feats, cfg["sa_npoints"][i], cfg["sa_radii"][i],
                                       cfg["sa_nsamples"][i], cfg["sa_mlps"][i], prec.q(name))
        outs.append((xyz, feats.float()))
    (_, _), (l2_xyz, l2_pts), (l3_xyz, l3_pts), (l4_xyz, l4_pts) = outs
    l3_pts = L.feature_propagation("fp1", l3_xyz, l4_xyz, l3_pts, l4_pts, cfg["fp_mlps"][0], prec.q("fp1"))
    seeds = L.feature_propagation("fp2", l2_xyz, l3_xyz, l2_pts, l3_pts, cfg["fp_mlps"][1], prec.q("fp2"))
    state = torch.cat([l2_xyz, seeds], dim=2)
    x, q = state, prec.q("voting")
    units = cfg["vote_units"]
    for j in range(len(units)):
        h = L.dense(x, f"voting.voting{j}", q)
        x = L.batch_norm(h, f"voting.voting{j}_bn", q) if j < len(units) - 1 else h
    votes = state + x
    votes_xyz, votes_pts = votes[:, :, :3], votes[:, :, 3:]
    head = tuple(cfg["proposal_mlp2_hidden"]) + (num_proposal_channels(cfg),)
    prop_xyz, prop_out = L.set_abstraction("proposal", votes_xyz, votes_pts, cfg["proposal_num"],
                                           cfg["proposal_radius"], cfg["proposal_nsample"], cfg["proposal_mlp"],
                                           prec.q("proposal"), sample_xyz=l2_xyz, mlp2=head)
    return {"seeds_xyz": l2_xyz, "votes_xyz": votes_xyz, "proposals_xyz": prop_xyz,
            "proposals_output": prop_out.float()}


def num_proposal_channels(cfg: dict) -> int:
    return 5 + 2 * cfg["num_heading_bin"] + 4 * cfg["num_size_cluster"] + cfg["num_class"]


# ----------------------------------------------------------------- loss


def _huber(err, delta=1.0):
    a = torch.abs(err)
    return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))


def _ce(logits, labels):
    return torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _mmean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def _per_proposal(attr, assign):
    idx = assign.long()
    while idx.dim() < attr.dim():
        idx = idx[..., None]
    return torch.gather(attr, 1, idx.expand(tuple(assign.shape) + tuple(attr.shape[2:])))


def loss(ep: Dict, gt: Dict, cfg: dict) -> torch.Tensor:
    """The VoteNet loss (the reference's ``model.py:62-233``): vote
    regression on surface seeds, objectness on positives and negatives,
    centre (with the dual chamfer term), heading and size classes and
    residuals, semantics; GT edge-padded, the GT-axis terms over the batch's
    largest ``gt_count``."""
    seeds, votes, prop, out = ep["seeds_xyz"], ep["votes_xyz"], ep["proposals_xyz"], ep["proposals_output"]
    bxyz = gt["bboxes_xyz"]
    B, G = bxyz.shape[:2]
    gt_limit = torch.clamp(torch.max(gt["gt_count"]), min=1)
    dual_mask = (torch.arange(G, device=bxyz.device)[None, :] < gt_limit).expand(B, G)

    d = torch.abs(seeds[:, :, None, :] - bxyz[:, None, :, :])
    ang = -gt["bboxes_roty"]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    rot = torch.stack([c * d[..., 0] + s * d[..., 2], d[..., 1], -s * d[..., 0] + c * d[..., 2]], dim=-1)
    surface = torch.any(torch.all(rot < gt["bboxes_lwh"][:, None] / 2.0, dim=-1), dim=-1)
    assign = torch.argmin(torch.sqrt(torch.sum(d * d, dim=-1)), dim=-1)
    l1 = torch.sum(torch.abs(votes - _per_proposal(bxyz, assign)), dim=-1)
    vote_loss = torch.sum(l1 * surface.to(l1.dtype)) / l1.numel()

    dist = torch.sqrt(torch.sum((prop[:, :, None, :] - bxyz[:, None, :, :]) ** 2, dim=-1))
    ba = torch.argmin(dist, dim=-1)
    mind = torch.amin(dist, dim=-1)
    pos, neg = mind < cfg["positive_thres"], mind > cfg["negative_thres"]
    obj = out[..., :2]
    obj_loss = _mmean(_ce(obj, torch.ones_like(ba)), pos) + _mmean(_ce(obj, torch.zeros_like(ba)), neg)

    delta = out[..., 2:5]
    centre = _mmean(torch.sum(_huber(delta - (_per_proposal(bxyz, ba) - prop)), dim=-1), pos)
    dual = torch.argmin(dist, dim=1)
    centre = centre + _mmean(torch.sum(_huber(_per_proposal(delta, dual) - (bxyz - _per_proposal(prop, dual))),
                                       dim=-1), dual_mask)
    NH, NS, NC = cfg["num_heading_bin"], cfg["num_size_cluster"], cfg["num_class"]
    hcls = _per_proposal(gt["heading_labels"], ba)
    hcls_loss = _mmean(_ce(out[..., 5:5 + NH], hcls), pos)
    hres = torch.gather(out[..., 5 + NH:5 + 2 * NH], -1, hcls[..., None].long())[..., 0]
    hres_loss = _mmean(_huber(hres - _per_proposal(gt["heading_residuals"], ba)), pos)
    scls = _per_proposal(gt["size_labels"], ba)
    scls_loss = _mmean(_ce(out[..., 5 + 2 * NH:5 + 2 * NH + NS], scls), pos)
    P = scls.shape[1]
    sres_all = out[..., 5 + 2 * NH + NS:5 + 2 * NH + 4 * NS].reshape(B, P, NS, 3)
    sres = torch.gather(sres_all, 2, scls.long()[..., None, None].expand(B, P, 1, 3))[..., 0, :]
    sres_loss = _mmean(torch.sum(_huber(sres - _per_proposal(gt["size_residuals"], ba)), dim=-1), pos)
    box = centre + cfg["w_heading_cls"] * hcls_loss + hres_loss + cfg["w_size_cls"] * scls_loss + sres_loss
    sem = _mmean(_ce(out[..., -NC:], _per_proposal(gt["semantic_labels"], ba)), pos)
    return vote_loss + cfg["w_obj"] * obj_loss + cfg["w_box"] * box + cfg["w_sem"] * sem


# ----------------------------------------------------------------- step


def param_names(cfg: dict):
    """(name, shape) of every parameter and (name, shape) of every batch-norm
    buffer, in the port's ``state_dict`` naming."""
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

    cin = 3
    for i, widths in enumerate(cfg["sa_mlps"]):
        stack(f"sa{i + 1}.mlp", cin + 3, widths)
        cin = widths[-1]
    c2, c3, c4 = (cfg["sa_mlps"][i][-1] for i in (1, 2, 3))
    stack("fp1.mlp", c4 + c3, cfg["fp_mlps"][0])
    stack("fp2.mlp", cfg["fp_mlps"][0][-1] + c2, cfg["fp_mlps"][1])
    cin = 3 + cfg["fp_mlps"][1][-1]
    units = cfg["vote_units"]
    for j, w in enumerate(units):
        lin(f"voting.voting{j}", cin, w)
        if j < len(units) - 1:
            bn(f"voting.voting{j}_bn", w)
        cin = w
    stack("proposal.mlp", 3 + cfg["fp_mlps"][1][-1], cfg["proposal_mlp"])
    stack("proposal.mlp2", cfg["proposal_mlp"][-1],
          tuple(cfg["proposal_mlp2_hidden"]) + (num_proposal_channels(cfg),), final_activation=False)
    return params, buffers


def clip_by_average_norm_(grads: Dict[str, torch.Tensor], clip: float) -> None:
    """``tf.clip_by_average_norm`` per leaf: ``g *= min(1, clip * numel /
    ||g||)``."""
    for g in grads.values():
        g.mul_(torch.clamp(clip * g.numel() / torch.clamp(torch.linalg.vector_norm(g), min=1e-30), max=1.0))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with bias-corrected moments."""

    def __init__(self, lr: float):
        self.lr, self.t = lr, 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    def step(self, params: Params, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g)).mul_(0.9).add_(0.1 * g)
            v = self.v.setdefault(k, torch.zeros_like(g)).mul_(0.999).add_(0.001 * g * g)
            params[k].sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))


def train_steps(params: Params, batches, cfg: dict, prec: Precision, steps: int, tf32: bool = False):
    """``steps`` training steps of the plain model from ``params`` (a dict
    of tensors, updated in place) on ``batches`` (dicts of tensors on the
    parameters' device). Returns (losses, first clipped gradient by leaf,
    the parameters' change by leaf after the last step)."""
    trainable, _ = param_names(cfg)
    names = [n for n, _ in trainable]
    start = {n: params[n].detach().clone() for n in names}
    opt = Adam(cfg["base_lr"])
    losses, first = [], None
    with matmuls(tf32):
        for k in range(steps):
            leaves = {n: params[n].detach().requires_grad_(True) for n in names}
            run = dict(params, **leaves)
            b = batches[k]
            total = loss(forward(run, b["points"], cfg, prec, train=True), b, cfg)
            grads = dict(zip(names, torch.autograd.grad(total, [leaves[n] for n in names], allow_unused=True)))
            grads = {n: (g if g is not None else torch.zeros_like(params[n])).detach() for n, g in grads.items()}
            losses.append(float(total.detach()))
            clip_by_average_norm_(grads, cfg["grad_clip_avg_norm"])
            if first is None:
                first = {n: g.clone() for n, g in grads.items()}
            with torch.no_grad():
                opt.step(params, grads)
            del total, grads, leaves, run
    change = {n: (params[n] - start[n]) for n in names}
    return losses, first, change


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}


def eval_forward(params: Params, points: torch.Tensor, cfg: dict, prec: Precision, tf32: bool = False) -> Dict:
    """The eval forward without gradients (TF32 matmuls where ``tf32``)."""
    with torch.no_grad(), matmuls(tf32):
        return forward(params, points, cfg, prec, train=False)
