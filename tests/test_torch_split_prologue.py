"""The split prologue: mixed precision's and bf16_hilo's first layer
(``CenteredDense._split_call``, ``votenet_tpu/models/pointnet2.py:105-130``)
formed inside batch norm's stages, ``ops.batch_norm_relu(h, ...,
coords=(xyz, centre, W3))``, on the CPU.

What is held, and to what:

- The four plain stages against a numpy transcription of the stated order,
  bit for bit: ``x = (T(dot3(xyz, W3) - dot3(centre, W3)) + h) + T(b)``,
  dot3 ``(p0 * w0 + p1 * w1) + p2 * w2``, each operation one f32 rounding,
  each step rounded to T (numpy's own round to nearest even); stage 1 and
  3's sums are torch's of that x, stage 2's output and stage 4's dx its
  arithmetic; stage 4's W3 and bias cotangents the f64 sums of the same
  rounded dx within 2^-40 of the sum of |terms| (the sums' order) after an
  f32 (bf16 for the bias) rounding.
- The op's gradients against autograd of the same layer in f64 (f32 h:
  within 1e-4 of each gradient's norm, the f32 roundings of the forward;
  the coordinates' and the centres' when asked for, by the stated formula
  on either device).
- Part A's form, the split layer that a pool ends (none at the reference
  widths): the forward bit-equal to the eager formula it replaces,
  ``(h_xyz.to(dt) + h_feat) + b.to(dt)`` into the batch norm, and the
  bias's cotangent within the allowance tests/test_torch_bn_layer.py sets
  for the other dense biases.
- The model's split first layer against the JAX package's ``_split_call``
  and flax's batch norm, in training with gradients (within
  tests/test_torch_precision.py's BF16_ULPS and GRAD_REL), and its calls
  (every stage with the split prologue).
"""

import numpy as np
import pytest
import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.ops import batchnorm as bn
from votenet_tpu_torch.ops.cuda.batchnorm import Coords

BF16 = torch.bfloat16
DTYPES = {"float32": torch.float32, "bfloat16": BF16}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(a):
    a = a.detach()
    return a.view(torch.int16 if a.dtype == BF16 else torch.int32)


def same(a, b) -> bool:
    """Equal values and NaNs at the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def round_np(v: np.ndarray, dtype: str) -> np.ndarray:
    """f32 values rounded to ``dtype`` (nearest, ties to even) as f32: bf16
    by the bits (NaNs kept NaN), f32 unchanged."""
    v = np.asarray(v, np.float32)
    if dtype == "float32":
        return v
    u = v.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = u.view(np.float32)
    return np.where(np.isnan(v), v, out).astype(np.float32)


def dot3_np(p, w3):
    f = np.float32
    return ((p[:, 0:1].astype(f) * w3[0]).astype(f) + (p[:, 1:2] * w3[1]).astype(f)).astype(f) \
        + (p[:, 2:3] * w3[2]).astype(f)


def x_np(h, xyz, centre, w3, db, dtype):
    """The stated order in numpy, f32 ops, rounded to ``dtype`` after each
    step."""
    S = h.shape[0] // centre.shape[0]
    a = dot3_np(xyz, w3).astype(np.float32)
    b = np.repeat(dot3_np(centre, w3).astype(np.float32), S, axis=0)
    tt = round_np((a - b).astype(np.float32), dtype)
    x = round_np((tt + h).astype(np.float32), dtype)
    return round_np((x + round_np(db, dtype)).astype(np.float32), dtype)


def split_inputs(seed, R=96, S=8, C=12, cin=9, dtype="bfloat16", nan=True):
    """A split site's rows: h rounded to ``dtype``, coordinates around each
    unit's centre with the ball query's padding, W3 the first rows of a
    (C, cin) weight's transpose (a strided view, as the model passes it),
    the dense bias, BN parameters, a cotangent; a NaN in h."""
    rng = np.random.RandomState(seed)
    U = R // S
    centre = rng.uniform(-3, 3, (U, 3)).astype(np.float32)
    xyz = (np.repeat(centre, S, 0) + rng.randn(R, 3) * 0.3).astype(np.float32)
    keep = rng.randint(1, S + 1, (U, 1, 1))
    pad = np.arange(S)[None, :, None] >= keep
    xyz = np.where(pad, xyz.reshape(U, S, 3)[:, :1], xyz.reshape(U, S, 3)).reshape(R, 3).astype(np.float32)
    h = round_np((rng.randn(R, C) * 3 + 1).astype(np.float32), dtype)
    if nan:
        h[R // 3, C // 2] = np.nan
    weight = (rng.randn(C, cin) * np.sqrt(2 / cin)).astype(np.float32)
    db = (rng.randn(C) * 0.1).astype(np.float32)
    return dict(h=h, xyz=xyz, centre=centre, weight=weight, db=db,
                bn_w=rng.uniform(0.5, 1.5, C).astype(np.float32), bn_b=rng.randn(C).astype(np.float32),
                dy=round_np(rng.randn(R, C).astype(np.float32), dtype),
                mean=rng.randn(C).astype(np.float32), mul=rng.uniform(0.2, 1, C).astype(np.float32),
                a=(rng.randn(C) * 1e-3).astype(np.float32), b=(rng.randn(C) * 1e-3).astype(np.float32))


def as_torch(d, dtype):
    dt = DTYPES[dtype]
    w = t(d["weight"])
    return t(d["h"]).to(dt), Coords(t(d["xyz"]), t(d["centre"]), w.t()[:3]), t(d["db"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stages_follow_the_stated_order(dtype):
    """Stages 1-4 with the split prologue against numpy's transcription, bit
    for bit (sums: torch's of the transcribed x and g; NaN where the NaN
    row's channel reaches)."""
    d = split_inputs(1, dtype=dtype)
    h, coords, db = as_torch(d, dtype)
    dt = DTYPES[dtype]
    w3 = d["weight"].T[:3].astype(np.float32)
    xn = x_np(d["h"], d["xyz"], d["centre"], w3, d["db"], dtype)
    x = bn.layer_rows_plain(h, None, db, coords)
    assert x.dtype == dt and same(x.float(), t(xn))  # a NaN's payload aside
    xf = t(xn)
    sums = bn.bn_stats_plain(h, dense_bias=db, coords=coords)
    assert same(sums, torch.stack([xf.sum(0), (xf * xf).sum(0)]))
    mean, mul, bias = t(d["mean"]), t(d["mul"]), t(d["bn_b"])
    y = bn.bn_apply_plain(h, mean, mul, bias, dt, True, dense_bias=db, coords=coords)
    yn = round_np(((xn - d["mean"]) * d["mul"]).astype(np.float32) + d["bn_b"], dtype)
    yn = np.where(np.isnan(yn), yn, np.maximum(yn, 0)).astype(np.float32)
    nan = np.isnan(yn)
    assert np.array_equal(torch.isnan(y).numpy(), nan)
    assert np.array_equal(y.float().numpy()[~nan], yn[~nan])
    # stages 3 and 4 on the NaN-free rows' channels (a NaN reaches its channel's sums)
    keep = ~np.isnan(xn).any(0)
    dy = t(d["dy"]).to(dt)
    sg, sgx = bn.bn_bwd_reduce_plain(h, dy, mean, mul, bias, True, dense_bias=db, coords=coords)
    pre = round_np(((xn - d["mean"]) * d["mul"]).astype(np.float32) + d["bn_b"], dtype)
    g = np.where(pre <= 0, 0, d["dy"]).astype(np.float32)
    assert torch.equal(sg[keep], t(g).sum(0)[keep])
    assert torch.equal(sgx[keep], (t(g) * (xf - mean)).sum(0)[keep])
    a, b = t(d["a"]), t(d["b"])
    dx, d_corr, d_bias, d_w3 = bn.bn_bwd_apply_plain(h, dy, mean, mul, bias, a, b, True, dense_bias=db,
                                                      coords=coords, sums=True)
    dxn = round_np((((g * d["mul"]).astype(np.float32) + d["a"]).astype(np.float32)
                    + (d["b"] * xn).astype(np.float32)).astype(np.float32), dtype)
    rows = ~np.isnan(dxn).any(1)
    assert d_corr is None and torch.equal(bits(dx[rows]), bits(t(dxn[rows]).to(dt)))
    # the cotangents: f64 sums of the rounded dx's exact terms, rounded once
    dd = dx.double()[:, keep]
    S = h.shape[0] // coords.centre.shape[0]
    diff = (coords.xyz.double().view(-1, S, 3) - coords.centre.double()[:, None]).view(-1, 3)
    want_w3, terms_w3 = diff.t() @ dd, diff.abs().t() @ dd.abs()
    ulp_b = 2.0 ** -23 if dtype == "float32" else 2.0 ** -7
    assert bool(((d_w3[:, keep].double() - want_w3).abs() <= 2.0 ** -23 * want_w3.abs() + 2.0 ** -40 * terms_w3).all())
    want_b = dd.sum(0)
    assert bool(((d_bias[keep].double() - want_b).abs() <= ulp_b * want_b.abs() + 2.0 ** -40 * dd.abs().sum(0)).all())


def unit_term_np(xyz, centre, w3):
    """The split K1 and K2's coordinate term (``csrc/batchnorm.cu``
    ``SplitLane``): a unit's centre term b = dot3(centre_u, W3) formed once
    when a row group enters the unit, then each row's a = dot3(xyz_r, W3)
    and a - b, unit by unit, each operation one f32 rounding."""
    U, S = centre.shape[0], xyz.shape[0] // centre.shape[0]
    out = np.empty((xyz.shape[0], w3.shape[1]), np.float32)
    for u in range(U):
        b = dot3_np(centre[u:u + 1], w3)[0].astype(np.float32)  # once a unit, kept for its S rows
        for r in range(u * S, (u + 1) * S):
            out[r] = (dot3_np(xyz[r:r + 1], w3)[0] - b).astype(np.float32)
    return out


@pytest.mark.parametrize("R,S", [(96, 8), (7 * 30, 30), (5 * 1, 1)])
def test_centre_term_once_a_unit_is_the_plain_term(R, S):
    """The per-unit form of the coordinate term, the centre's dot3 formed
    once a unit and subtracted from every row's, equals
    ``ops.batchnorm.coord_term_plain`` (the centre's term broadcast over its
    unit) bit for bit, on units the ball query pads (rows repeating the
    unit's first) and with a NaN among the coordinates."""
    d = split_inputs(R + S, R=R, S=S, nan=False)
    xyz = d["xyz"].copy()
    xyz[R // 2, 1] = np.nan
    w3 = d["weight"].T[:3].astype(np.float32)
    got = unit_term_np(xyz, d["centre"], w3)
    want = bn.coord_term_plain(Coords(t(xyz), t(d["centre"]), t(d["weight"]).t()[:3]), w3.shape[1])
    assert np.array_equal(np.isnan(got), torch.isnan(want).numpy()) and np.isnan(got).any()
    assert np.array_equal(got.view(np.uint32)[~np.isnan(got)], want.numpy().view(np.uint32)[~np.isnan(got)])
    padded = (d["xyz"].reshape(-1, S, 3) == d["xyz"].reshape(-1, S, 3)[:, :1]).all(-1).sum(1) > 1
    assert S == 1 or padded.any()  # units with repeated rows are among them


def round_bf16_exact(v: np.ndarray) -> np.ndarray:
    """f64 values rounded once to bf16 (8 significant bits, nearest, ties to
    even), for normal values."""
    m, e = np.frexp(np.asarray(v, np.float64))
    return np.ldexp(np.rint(m * 256), e - 8)


def le0_mask_np(t: np.ndarray) -> np.ndarray:
    """__hle2_mask(t, 0) on bf16 values held in f32, by their 16 bits:
    0xffff where t <= 0 (either zero, or a negative that is not a NaN), 0
    elsewhere (a NaN compares false)."""
    h = (np.asarray(t, np.float32).view(np.uint32) >> 16).astype(np.uint32)
    mag = h & 0x7FFF
    return np.where((mag == 0) | ((h >> 15 == 1) & (mag <= 0x7F80)), 0xFFFF, 0).astype(np.uint32)


def packed_backward_np(x, dy, mean, mul, bias, a, b):
    """The split K3's and K4's bf16 pair arithmetic (``csrc/batchnorm.cu``
    ``bn_bwd_reduce_split_kernel``, ``bn_bwd_apply_split_kernel``) in numpy on
    bf16 values held in f32: t = pack_rn(((x - mean) * mul) + bias) (each f32
    op one rounding, the pack one bf16 rounding of each half), the ReLU's
    mask ``__hle2_mask(t, 0)`` cleared from dy's 16 bits (g), and dx =
    pack_rn(((g * mul) + a) + (b * x)). Returns (g, dx) as f32."""
    f = np.float32
    t = round_np((((x - mean).astype(f) * mul).astype(f) + bias).astype(f), "bfloat16")
    bits = (np.asarray(dy, f).view(np.uint32) >> 16) & ~le0_mask_np(t)
    g = (bits.astype(np.uint32) << 16).view(f)
    dx = round_np(((((g * mul).astype(f) + a).astype(f)) + (b * x).astype(f)).astype(f), "bfloat16")
    return g, dx


def test_packed_adds_round_as_the_f32_op_and_the_cast():
    """The split K1 and K2 add bf16 pairs with bf16x2 adds, which round the
    exact sum once to bf16; the plain stages add in f32 and cast. The two
    agree on every pair of bf16 values: the sums of split_inputs' terms and
    h, pairs whose exact sum is a bf16 tie, pairs a tie's f32 rounding would
    move (a bf16 far below the other), and random pairs of wide exponent
    range. The split K3 and K4 form the normalised t, the ReLU's mask and
    dx in pairs (:func:`packed_backward_np`): g and dx equal the plain
    stages' (``_masked``, ``bn_bwd_apply_plain``) bit for bit on
    split_inputs' rows, with t's NaNs (a NaN in h passes dy), both zeros and
    exact ties of the pack among them."""
    rng = np.random.RandomState(7)
    d = split_inputs(3, R=512, S=16, C=32, nan=False)
    w3 = d["weight"].T[:3].astype(np.float32)
    term = round_np(unit_term_np(d["xyz"], d["centre"], w3), "bfloat16").ravel()
    h = d["h"].ravel()
    one = np.float32(1.0)  # a binade of bf16 steps 2^-7 from it
    ties = (np.float32(1 + 2.0 ** -7 * rng.randint(0, 128, 4096)), np.float32(2.0 ** -8 * rng.choice([-1, 1], 4096)))
    tiny = (np.full(2048, one) + np.float32(2.0 ** -7) * rng.randint(0, 128, 2048).astype(np.float32),
            round_np((rng.choice([-1, 1], 2048) * (1 + rng.rand(2048)) * 2.0 ** -rng.randint(9, 40, 2048))
                     .astype(np.float32), "bfloat16"))
    wide = tuple(round_np((rng.randn(8192) * 2.0 ** rng.randint(-40, 40, 8192)).astype(np.float32), "bfloat16")
                 for _ in range(2))
    for a, b in ((term, h), ties, tiny, wide):
        a, b = a.astype(np.float32), b.astype(np.float32)
        assert np.array_equal(round_np(a, "bfloat16"), a) and np.array_equal(round_np(b, "bfloat16"), b)
        via_f32 = round_np((a + b).astype(np.float32), "bfloat16")
        once = round_bf16_exact(a.astype(np.float64) + b.astype(np.float64)).astype(np.float32)
        assert np.array_equal(via_f32, once)
    # the backward's pairs
    d = split_inputs(5, R=2048, S=16, C=32)
    h, coords, db = as_torch(d, "bfloat16")
    x = bn.layer_rows_plain(h, None, db, coords)
    xf = x.float().numpy()
    mean = np.float32(xf[~np.isnan(xf).any(1)].mean(0))
    mean[:4] = xf[0, :4]  # t = bias exactly on row 0: ties of the pack, zeros with bias 0
    mul, a, b = d["mul"], d["a"], d["b"]
    bias = d["bn_b"].copy()
    bias[:2] = 0.0
    dy = t(d["dy"]).to(BF16)
    g, dx = packed_backward_np(xf, d["dy"], mean, mul, bias, a, b)
    want_g = bn._masked(x, dy, t(mean), t(mul), t(bias), True)
    want_dx = bn.bn_bwd_apply_plain(h, dy, t(mean), t(mul), t(bias), t(a), t(b), True, dense_bias=db,
                                    coords=coords, sums=True)[0]
    for got, want in ((t(g), want_g), (t(dx), want_dx.float())):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan) and torch.equal(bits(got)[~nan], bits(want)[~nan])
    assert np.isnan(xf).any() and (g == 0).any() and (g != 0).any() and (xf[0, :2] == mean[:2]).all()


def f64_layer(h, xyz, centre, w3, db, bn_w, bn_b, S):
    """The layer in f64 autograd: x = (xyz @ W3 - centre @ W3) + h + b, batch
    statistics (biased variance), the ReLU."""
    C = h.shape[-1]
    x = (xyz @ w3).view(-1, S, C) - (centre @ w3)[:, None]
    x = x.view(-1, C) + h + db
    mean = x.mean(0)
    var = (x * x).mean(0) - mean * mean
    return torch.relu((x - mean) * torch.rsqrt(var + 1e-5) * bn_w + bn_b)


@pytest.mark.parametrize("coord_grad", [False, True], ids=["features", "with-coordinates"])
def test_op_gradients_match_autograd_in_f64(coord_grad):
    """The op in f32 with the split prologue in training: y and the
    gradients of h, the dense bias, W3 (through the layer's weight view)
    and, asked for, the coordinates and the centres, within 1e-4 of each
    norm of autograd's in f64 on the same inputs."""
    d = split_inputs(2, R=128, S=16, C=10, cin=7, dtype="float32", nan=False)
    S = 16
    leaves32, leaves64 = {}, {}
    for name in ("h", "xyz", "centre", "weight", "db", "bn_w", "bn_b"):
        v = t(d[name])
        leaves32[name] = v.clone().requires_grad_(name not in ("xyz", "centre") or coord_grad)
        leaves64[name] = v.double().requires_grad_(True)
    L = leaves32
    rm, rv = torch.zeros(10), torch.ones(10)
    w3 = L["weight"].t()[:3]
    y = ops.batch_norm_relu(L["h"].view(-1, S, 10), L["bn_w"], L["bn_b"], rm, rv, training=True, dense_bias=L["db"],
                            coords=(L["xyz"].view(-1, S, 3), L["centre"], w3))
    gy = t(d["dy"])
    y.backward(gy.view(y.shape))
    G = leaves64
    y64 = f64_layer(G["h"], G["xyz"], G["centre"], G["weight"].t()[:3], G["db"], G["bn_w"], G["bn_b"], S)
    y64.backward(gy.double())
    assert float((y.double().view(-1, 10) - y64).norm()) <= 1e-4 * float(y64.norm())
    names = ["h", "weight", "bn_w", "bn_b"] + (["xyz", "centre"] if coord_grad else [])
    for name in names:
        got, want = L[name].grad, G[name].grad
        assert got is not None and got.dtype == torch.float32, name
        assert float((got.double() - want).norm()) <= 1e-4 * max(float(want.norm()), 1e-12), name
    # the dense bias's is 0 in exact arithmetic (batch norm takes out a shift): held to its terms, sum |dh|
    terms = G["h"].grad.abs().sum(0)
    assert bool(((L["db"].grad.double() - G["db"].grad).abs() <= 1e-5 * terms).all())
    if not coord_grad:
        assert L["xyz"].grad is None and L["centre"].grad is None
    assert bool((L["weight"].grad[:, 3:] == 0).all())  # W3's rows alone take the op's cotangent


def test_op_refuses_what_the_split_prologue_does_not_take():
    """corr with coords, a pool, another output dtype or non-f32 coordinates
    raise ValueError: the model forms its coordinate term itself where the
    split layer is pooled."""
    d = split_inputs(3, dtype="bfloat16", nan=False)
    h, coords, db = as_torch(d, "bfloat16")
    h4 = h.view(2, 6, 8, 12)
    c4 = (coords.xyz.view(2, 6, 8, 3), coords.centre.view(2, 6, 3), coords.w3)
    args = (torch.ones(12), torch.zeros(12), torch.zeros(12), torch.ones(12))
    ops.batch_norm_relu(h4, *args, training=True, dense_bias=db, coords=c4)
    for kw in (dict(pool="max"), dict(corr=torch.zeros(2, 6, 12, dtype=BF16)), dict(dtype=torch.float32)):
        with pytest.raises(ValueError):
            ops.batch_norm_relu(h4, *args, training=True, dense_bias=db, coords=c4, **kw)
    with pytest.raises(ValueError):
        ops.batch_norm_relu(h4, *args, training=True, coords=(c4[0].double(), c4[1], c4[2]))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_part_a_form_is_the_eager_formula(training):
    """The split layer ended by a pool (an MLP of one width) hands the batch
    norm ``h = T(h_xyz) + h_feat`` and the f32 bias: the forward equals the
    eager ``(T(h_xyz) + h_feat) + T(b)`` into the batch norm bit for bit,
    and the bias's cotangent is the f64 sum of the rounded dx rounded once
    (tests/test_torch_bn_layer.py's allowance for the dense biases: within
    2^-6 of its terms' sum of |dx| of the eager bf16 sum)."""
    from votenet_tpu_torch.models.pointnet2 import MLPStack

    rng = np.random.RandomState(7)
    B, M, S, Cf = 2, 6, 8, 5
    stack = MLPStack(3 + Cf, (12,), torch.Generator().manual_seed(2), dtype=BF16).train(training)
    xyz = torch.from_numpy(rng.uniform(-2, 2, (B, M, S, 3)).astype(np.float32))
    feat = torch.from_numpy(rng.randn(B, M, S, Cf).astype(np.float32)).to(BF16)
    center = torch.from_numpy(rng.uniform(-2, 2, (B, M, 3)).astype(np.float32))
    gp = torch.from_numpy(rng.randn(B, M, 12).astype(np.float32)).to(BF16)
    outs = []
    for fused in (True, False):
        stack.zero_grad()
        if fused:
            y = stack((xyz, feat), center=center, pool="max")
        else:
            w = stack.dense0.weight.t()
            h_xyz = xyz @ w[:3] - (center @ w[:3])[:, :, None, :]
            h = (h_xyz.to(BF16) + feat @ w[3:].to(BF16)) + stack.dense0.bias.to(BF16)
            y = torch.amax(stack.bn0(h, relu=True), dim=2)
        y.backward(gp)
        outs.append((y, stack.dense0.bias.grad.clone(), stack.dense0.weight.grad.clone()))
    (y1, b1, w1), (y0, b0, w0) = outs
    assert torch.equal(bits(y1), bits(y0))
    assert torch.equal(bits(w1[:, 3:]), bits(w0[:, 3:])) and torch.equal(bits(w1[:, :3]), bits(w0[:, :3]))
    # the bias's cotangent: the f64 sum of dx (rounded to bf16) against the eager bf16 sum
    assert b1.dtype == torch.float32 and bool(((b1 - b0).abs() <= 2 ** -6 * b0.abs().clamp(min=1e-3) + 1e-2).all())


@pytest.mark.parametrize("form", ["split-grouped", "split-project-first"])
def test_split_layer_calls_every_stage_with_the_split_prologue(monkeypatch, form):
    """The model's split first layer (MLPStack given (xyz, features)) calls
    each stage with ``coords`` and the dense bias in training (K1-K4) and
    eval (K2), and no other layer does."""
    from votenet_tpu_torch.models.pointnet2 import MLPStack

    calls = []
    for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply"):
        plain = getattr(bn, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            calls.append((_name, kw.get("coords") is not None, kw.get("dense_bias") is not None))
            return _plain(*a, **kw)

        monkeypatch.setattr(bn, f"{name}_plain", counted)
    rng = np.random.RandomState(8)
    B, N, M, S, Cf = 2, 30, 6, 8, 5
    stack = MLPStack(3 + Cf, (12, 16), torch.Generator().manual_seed(2), dtype=BF16)
    xyz = torch.from_numpy(rng.uniform(-2, 2, (B, N, 3)).astype(np.float32))
    feat = torch.from_numpy(rng.randn(B, N, Cf).astype(np.float32)).to(BF16)
    idx = torch.from_numpy(rng.randint(0, N, (B, M, S)).astype(np.int32))
    center = xyz[:, :M]
    if form == "split-grouped":
        stack.train()
        y = stack((ops.group_point(xyz, idx), ops.group_point(feat, idx)), center=center, pool="max")
        y.float().sum().backward()
        want = [(k, i == 0, True) for i in range(2) for k in ("bn_stats", "bn_apply")]
        want += [(k, i == 0, True) for i in (1, 0) for k in ("bn_bwd_reduce", "bn_bwd_apply")]
    else:
        with torch.no_grad():
            stack.eval()((xyz, feat), center=center, idx=idx, pool="max")
        want = [("bn_apply", True, True), ("bn_apply", False, True)]
    assert calls == want


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_split_layer_matches_jax_split_call(train):
    """MLPStack's split form against the JAX package's MLPStack in bf16
    (``CenteredDense._split_call`` + flax BatchNorm + relu + max over the
    slots), gather first: the output within BF16_ULPS bf16 ulps of scale,
    and in training every parameter's gradient (the first layer's W3 rows,
    summed in f64 by the op, among them) within GRAD_REL norm-wise, the
    first layer's bias (the zero sum of batch norm's shift) no larger than
    JAX's."""
    import jax
    import jax.numpy as jnp
    from votenet_tpu.models.pointnet2 import MLPStack as JaxMLP

    from tests.test_torch_model import randomize_bn
    from tests.test_torch_precision import GRAD_REL, as_port, close_bf16, compiled, jbf16, norm_gaps
    from votenet_tpu_torch.models import convert_flax_variables
    from votenet_tpu_torch.models.pointnet2 import MLPStack

    rng = np.random.RandomState(9)
    B, N, M, S, Cf, widths = 2, 40, 12, 8, 21, (32, 32, 48)
    xyz = rng.uniform(-3, 3, (B, N, 3)).astype(np.float32)
    feat = rng.randn(B, N, Cf).astype(np.float32)
    idx = rng.randint(0, N, (B, M, S)).astype(np.int32)
    center = xyz[np.arange(B)[:, None], rng.randint(0, N, (B, M))]
    gather = lambda a: a[np.arange(B)[:, None, None], idx]  # noqa: E731
    jin = (gather(xyz), jbf16(gather(feat)))
    jm = JaxMLP(widths, dtype=jnp.bfloat16)
    v = randomize_bn(jax.jit(lambda key: jm.init(key, jin, False, center=center))(jax.random.PRNGKey(3)))
    pm = MLPStack(3 + Cf, widths, torch.Generator().manual_seed(0), dtype=BF16)
    convert_flax_variables(v, pm)
    pin = (t(gather(xyz)), t(gather(feat)).to(BF16))
    w = rng.randn(B, M, S, widths[-1]).astype(np.float32) / np.sqrt(B * M * S * widths[-1])
    if not train:
        want = compiled(lambda v, jin: jnp.max(jm.apply(v, jin, False, center=center), axis=2), v, jin)
        with torch.no_grad():
            got = pm.eval()(pin, center=t(center), pool="max")
        close_bf16(got, want)
        return
    wp = w.max(axis=2)

    def loss(params):
        y, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jin, True, center=center,
                        mutable=["batch_stats"])
        return jnp.sum(jnp.max(y, axis=2).astype(jnp.float32) * wp)

    jgrads = compiled(jax.grad(loss), v["params"])
    pm.train()
    y = pm(pin, center=t(center), pool="max")
    (y.float() * t(wp)).sum().backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    want = as_port(pm, jax.tree_util.tree_map(np.asarray, jgrads))
    zero = {"dense0.bias", "dense1.bias", "dense2.bias"}
    gaps = norm_gaps({n: g for n, g in grads.items() if n not in zero}, want)
    assert not {n: g for n, g in gaps.items() if g > GRAD_REL}, gaps
    gaps_w3 = norm_gaps({"w3": grads["dense0.weight"][:, :3]}, {"w3": want["dense0.weight"][:, :3]})
    assert gaps_w3["w3"] <= GRAD_REL, gaps_w3
    for n in zero:
        assert float(grads[n].norm()) <= float(want[n].norm()), n
