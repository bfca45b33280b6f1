"""The batch-norm site with the layer around it (``ops.batch_norm_relu``'s
``dense_bias``, ``corr`` and ``pool``) on its plain stages, on the CPU.

What is held, and to what:

- The op against the flax layer run by JAX on the CPU, compiled with
  excess precision off: nn.Dense's bias add or ``CenteredDense``'s ``(h -
  corr) + b`` (``votenet_tpu/models/pointnet2.py:95-103``), ``nn.BatchNorm``
  + ``nn.relu`` (``:157-174``) and ``jnp.max`` over the slots (``:540-541``):
  the output and the cotangents of h, corr, the dense bias, the scale and
  the BN bias, f32 and bf16, train and eval, on balls padded as the ball
  query pads them (a ball's first hit repeated) and with channels whose
  every slot the ReLU zeroes, so that the max's ties are many. f32: 2e-6 of
  scale (the sums' order is the only difference, the tolerance of
  ``tests/test_torch_batchnorm.py``). bf16: the output within 2^-8 of
  scale (half a bf16 step at the scale's binade), each cotangent within
  2^-6 of its norm, the dense bias's in training (whose terms cancel:
  batch norm takes out a shift) within 2^-6 of its terms' sum of |dh|
  channel by channel (flax rounds the cotangent of each of x's three uses to
  bf16 before adding them, the dense bias's and corr's cotangents are bf16
  sums that the two frameworks round in other places, and statistics one
  f32 ulp apart flip a bf16 rounding, and with it which slots tie, here
  and there; measured on these inputs: the output 1.3e-4 of scale, the
  cotangents up to 8.1e-3 of their norm, the dense bias's in eval; f32:
  6.6e-7 of scale).
- The op bit for bit against the port's earlier eager composition, ``(h -
  corr[..., None, :]) + b`` → ``batch_norm_relu`` → ``torch.amax``, forward
  and every gradient, f32 and bf16, train and eval, NaN included, with the
  prologue's cotangents summed as the op sums them (:class:`F64Prologue`:
  in f64, rounded once to h's dtype; autograd's f32 or bf16 torch sums are
  roundings of the same terms in another order).
- K1's and K3's summation order (``csrc/batchnorm.cu``: in f64, a
  thread's rows, the row groups, then the two-level tree over the CTAs'
  partials in blocks of ``fan_in``, rounded once to f32) transcribed into
  numpy from the launch plan (:func:`kernel_sum_order`), against the f64
  sum; the card's kernels equal it bit for bit in
  ``tests/test_torch_cuda.py``. The plan at units of S rows.
- The model's MLP stacks against the same layers written out eagerly.
"""

import math

import numpy as np
import pytest
import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.ops import batchnorm as bn_op
from votenet_tpu_torch.ops.cuda import batchnorm as bn_cuda

EPS = 1e-5
MOMENTUM = 0.9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rel):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def norm_close(got, want, rel):
    got = np.asarray(got.detach().float(), np.float64)
    want = np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= rel * max(np.linalg.norm(want), 1e-30)


def site(seed, shape=(2, 6, 8, 12), prologue="centre", ties=True):
    """A site's inputs: h (B, M, S, C) with the ball query's padding (each
    ball keeps a random number of slots and repeats its first in the rest),
    channel 0 pushed below the BN bias's reach so that the ReLU zeroes every
    slot (a tie of all S) in half the balls, corr (B, M, C), the dense
    bias, a pooled
    cotangent, the BN parameters and running statistics."""
    rng = np.random.RandomState(seed)
    B, M, S, C = shape
    h = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    if ties:
        keep = rng.randint(1, S + 1, (B, M, 1, 1))
        h = np.where(np.arange(S)[None, None, :, None] >= keep, h[:, :, :1], h).astype(np.float32)
        low = rng.rand(B, M) < 0.5  # channel 0 of half the balls far below the rest: every slot under 0
        h[..., 0] = np.where(low[..., None], -6.0 - 0.01 * rng.rand(B, M, S), h[..., 0]).astype(np.float32)
    corr = (rng.randn(B, M, C) * 2).astype(np.float32) if prologue == "centre" else None
    db = rng.randn(C).astype(np.float32)
    gp = rng.randn(B, M, C).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.randn(C).astype(np.float32)}
    params["bias"][0] = -1.0  # with h's low balls of channel 0: y < 0 in every slot
    stats = {"mean": rng.randn(C).astype(np.float32), "var": rng.uniform(0.5, 2, C).astype(np.float32)}
    stats["mean"][0], stats["var"][0] = 1.0, 9.0
    return h, corr, db, gp, params, stats


def run_fused(h, corr, db, gp, params, stats, training, dtype, pool=True):
    """The op: (y, dh, dcorr, ddb, dscale, dbias, running mean, running var)."""
    hh = t(h).to(dtype).requires_grad_(True)
    cc = None if corr is None else t(corr).to(dtype).requires_grad_(True)
    dd = t(db).to(dtype).requires_grad_(True)
    w, b = t(params["scale"]).requires_grad_(True), t(params["bias"]).requires_grad_(True)
    rm, rv = t(stats["mean"]).clone(), t(stats["var"]).clone()
    y = ops.batch_norm_relu(hh, w, b, rm, rv, training=training, momentum=MOMENTUM, eps=EPS, dense_bias=dd, corr=cc,
                            pool="max" if pool else None)
    y.backward(t(gp).to(dtype) if pool else t(np.broadcast_to(gp[:, :, None], h.shape)).to(dtype))
    return y, hh.grad, None if cc is None else cc.grad, dd.grad, w.grad, b.grad, rm, rv


class F64Prologue(torch.autograd.Function):
    """``(h - corr[..., None, :]) + b`` (either term optional; each op in h's
    dtype, the bias cast to it) whose backward sums the prologue's
    cotangents as ``ops.batch_norm_relu`` does: corr's ``-sum(dh)`` over the
    slots and the bias's ``sum(dh)`` over every axis but the last, in f64,
    rounded once to h's dtype (the bias's then cast to its own dtype)."""

    @staticmethod
    def forward(ctx, h, corr, b):
        ctx.centre, ctx.b_dtype = corr is not None, None if b is None else b.dtype
        x = h if corr is None else h - corr[..., None, :]
        return x if b is None else x + b.to(h.dtype)

    @staticmethod
    def backward(ctx, dx):
        d = dx.double()
        d_corr = (-d).sum(-2).to(dx.dtype) if ctx.centre else None
        d_b = d.sum(tuple(range(d.dim() - 1))).to(dx.dtype).to(ctx.b_dtype) if ctx.b_dtype is not None else None
        return dx, d_corr, d_b


def run_eager(h, corr, db, gp, params, stats, training, dtype, pool=True):
    """The port's earlier composition: the prologue's torch ops (their
    cotangents summed in f64, :class:`F64Prologue`), the op without a
    prologue, ``torch.amax``."""
    hh = t(h).to(dtype).requires_grad_(True)
    cc = None if corr is None else t(corr).to(dtype).requires_grad_(True)
    dd = t(db).to(dtype).requires_grad_(True)
    w, b = t(params["scale"]).requires_grad_(True), t(params["bias"]).requires_grad_(True)
    rm, rv = t(stats["mean"]).clone(), t(stats["var"]).clone()
    x = F64Prologue.apply(hh, cc, dd)
    y = ops.batch_norm_relu(x, w, b, rm, rv, training=training, momentum=MOMENTUM, eps=EPS)
    if pool:
        y = torch.amax(y, dim=2)
    y.backward(t(gp).to(dtype) if pool else t(np.broadcast_to(gp[:, :, None], h.shape)).to(dtype))
    return y, hh.grad, None if cc is None else cc.grad, dd.grad, w.grad, b.grad, rm, rv


def flax_reference(h, corr, db, gp, params, stats, training, dtype):
    """flax: ``(h - corr[:, :, None]) + b`` (CenteredDense's association) or
    ``h + b`` (Dense), then BatchNorm, relu and jnp.max over axis 2, all in
    ``dtype``: (y, dh, dcorr, ddb, dscale, dbias, new batch_stats)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    dt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(use_running_average=not training, momentum=MOMENTUM, epsilon=EPS, dtype=dt)

    def f(p, hh, cc, dd):
        x = (hh if cc is None else hh - cc[:, :, None, :]) + dd
        y, mut = bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
        y = jnp.max(fnn.relu(y), axis=2)
        return jnp.sum(y.astype(jnp.float32) * gp), (y, mut["batch_stats"])

    args = (params, jnp.asarray(h).astype(dt), None if corr is None else jnp.asarray(corr).astype(dt),
            jnp.asarray(db).astype(dt))
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True))
    (_, (y, new)), (gpar, gh, gc, gd) = fn.lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)
    f32 = lambda a: None if a is None else np.asarray(a.astype(jnp.float32))  # noqa: E731
    return (f32(y), f32(gh), f32(gc), f32(gd), np.asarray(gpar["scale"]), np.asarray(gpar["bias"]),
            {k: np.asarray(v) for k, v in new.items()})


# ------------------------------------------------------------ against flax

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("prologue", ["centre", "bias"])
def test_fused_layer_matches_flax(dtype, mode, prologue):
    """The fused site (prologue, BN, ReLU, max over the slots) against
    flax's layers: the output, the running statistics after a step and the
    cotangents of h, corr, the dense bias, the scale and the BN bias."""
    h, corr, db, gp, params, stats = site(11 + len(mode) + len(prologue), prologue=prologue)
    tdt = DTYPES[dtype]
    training = mode == "train"
    y, dh, dc, dd, ds, dbias, rm, rv = run_fused(h, corr, db, gp, params, stats, training, tdt)
    # the inputs flax sees: rounded to bf16 in bf16 mode
    r = lambda a: None if a is None else t(a).to(tdt).float().numpy()  # noqa: E731
    fy, fdh, fdc, fdd, fds, fdb, fnew = flax_reference(r(h), r(corr), r(db), gp, params, stats, training, dtype)
    assert y.dtype == tdt and dh.dtype == tdt and dd.dtype == tdt and y.shape == gp.shape
    ties = (t(np.asarray(h)).to(tdt).float().numpy() == t(np.asarray(h)).to(tdt).float().numpy()[:, :, :1]).sum()
    assert ties > h.size // 8  # the padding's ties are many
    if dtype == "float32":
        for got, want in ((y, fy), (dh, fdh), (dc, fdc), (dd, fdd), (ds, fds), (dbias, fdb)):
            if want is not None:
                close(got, want, 2e-6)
    else:
        close(y, fy, 2 ** -8)
        for got, want in ((dh, fdh), (dc, fdc), (ds, fds), (dbias, fdb)) + (() if training else ((dd, fdd),)):
            if want is not None:
                norm_close(got, want, 2 ** -6)
        if training:  # batch norm takes out a shift: the dense bias's cotangent is a sum of terms that cancel
            terms = np.abs(fdh.astype(np.float64)).reshape(-1, fdh.shape[-1]).sum(0)
            assert np.all(np.abs(dd.float().numpy() - fdd) <= 2 ** -6 * terms)
    assert (dc is None) == (prologue == "bias")
    if training:
        close(rm, fnew["mean"], 2e-6)
        close(rv, fnew["var"], 2e-6)
    else:
        np.testing.assert_array_equal(rm.numpy(), stats["mean"])


def test_pool_splits_the_cotangent_among_ties():
    """The max's rule on a ball whose slots all tie (the ReLU's zeros, or
    one hit repeated): each of the k tied slots takes gp / k, the others 0;
    here before the ReLU's mask, through the plain stage's slot cotangent."""
    y = torch.tensor([[1.0, 2.0], [3.0, 2.0], [3.0, 0.5], [0.0, 2.0]])  # one unit of 4 slots, 2 channels
    gp = torch.tensor([[6.0, 9.0]])
    ymax, count = bn_op._max_pool(y, 4)
    assert ymax.tolist() == [[3.0, 2.0]] and count.tolist() == [[2, 3]]
    got = bn_op._slot_cotangent(y, gp, ymax, count)
    assert got.tolist() == [[0.0, 3.0], [3.0, 3.0], [3.0, 0.0], [0.0, 3.0]]


# ------------------------------------------- against the eager composition

def bits(a):
    if a is None:
        return None
    a = a.detach()
    return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("variant", ["centre-pool", "bias-pool", "centre", "bias"])
def test_fused_layer_is_the_eager_composition_bit_for_bit(dtype, mode, variant):
    """The op's forward and every gradient equal, bit for bit, the port's
    earlier eager composition on the same (CPU) device: the prologue's
    torch ops (their cotangents summed in f64 and rounded once, as the op
    sums them), the op without a prologue, torch.amax; one element of h a
    NaN (its ball's max is NaN, its tie count 0)."""
    prologue, pool = variant.split("-")[0], variant.endswith("pool")
    h, corr, db, gp, params, stats = site(5 + len(variant), prologue=prologue)
    h[1, 2, 3, 4] = np.nan
    tdt = DTYPES[dtype]
    got = run_fused(h, corr, db, gp, params, stats, mode == "train", tdt, pool)
    want = run_eager(h, corr, db, gp, params, stats, mode == "train", tdt, pool)
    assert bool(torch.isnan(got[0]).any())
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        nan = torch.isnan(w.detach())  # a NaN's bits follow torch's casts through f64 and f32, not the op
        assert torch.equal(torch.isnan(g.detach()), nan) and torch.equal(bits(g)[~nan], bits(w)[~nan])


def test_plain_stages_take_the_prologue_and_the_pool():
    """The stages' prologue is (h - corr[unit]) + b in h's dtype, rounded
    after each operation, and stage 2's pool is torch.amax with its counts."""
    rng = np.random.RandomState(2)
    h = t(rng.randn(24, 5).astype(np.float32)).bfloat16()
    corr = t(rng.randn(3, 5).astype(np.float32)).bfloat16()
    db = t(rng.randn(5).astype(np.float32)).bfloat16()
    x = bn_op.layer_rows_plain(h, corr, db)
    want = (h.view(3, 8, 5) - corr[:, None]).view(24, 5) + db
    assert x.dtype == torch.bfloat16 and torch.equal(bits(x), bits(want))
    mean, mul, bias = torch.zeros(5), torch.ones(5), torch.zeros(5)
    ymax, count = bn_op.bn_apply_plain(h, mean, mul, bias, torch.bfloat16, True, corr=corr, dense_bias=db, pool=8)
    y = torch.relu(want.float().to(torch.bfloat16)).view(3, 8, 5)
    assert torch.equal(ymax, torch.amax(y, dim=1)) and count.dtype == torch.int32
    assert torch.equal(count, (y == ymax[:, None]).sum(1).int())


# ------------------------------------------------ K1/K3's summation order

def kernel_sum_order(terms: np.ndarray, plan, S: int = 1) -> np.ndarray:
    """``csrc/batchnorm.cu``'s K1 and K3 sums of ``terms`` (R, C), exact in
    f64 (x, x * x; g, g * f32(x - mean)), in numpy, for a launch ``plan``
    (``bn_plan``'s W, CTAs, tiles, units a CTA, fan-in) in units of S rows,
    before the rounding to f32 (:func:`kernel_sums`). Every channel is added
    in the same order, each add one f64 rounding: a thread its rows from 0
    (its row group's units u0 + rg, + groups, ..., each unit's S rows in
    turn); the CTA's row groups in order from 0; the CTAs' partials in
    blocks of fan_in consecutive CTAs, each block from 0; the blocks' sums
    from 0 (one block: its sum is the result)."""
    W, ctas, _, per_cta, fan_in = plan
    terms = np.asarray(terms, np.float64)
    R, C = terms.shape
    groups = bn_cuda.BN_THREADS // W
    units = R // S
    threads = []
    for k in range(ctas):
        for rg in range(groups):
            u = np.arange(k * per_cta + rg, min((k + 1) * per_cta, units), groups)
            threads.append((u[:, None] * S + np.arange(S)[None]).ravel())
    width = max(len(r) for r in threads)
    idx = np.full((len(threads), width), R, dtype=np.int64)  # R: a zero row (adding +0 leaves a sum as it is)
    for i, rows in enumerate(threads):
        idx[i, :len(rows)] = rows
    padded = np.concatenate([terms, np.zeros((1, C))])
    acc = np.zeros((len(threads), C))
    for j in range(width):
        acc = acc + padded[idx[:, j]]
    acc = acc.reshape(ctas, groups, C)
    partials = np.zeros((ctas, C))
    for rg in range(groups):
        partials = partials + acc[:, rg]
    blocks = []
    for b0 in range(0, ctas, fan_in):
        s = np.zeros(C)
        for k in range(b0, min(ctas, b0 + fan_in)):
            s = s + partials[k]
        blocks.append(s)
    if len(blocks) == 1:
        return blocks[0]
    out = np.zeros(C)
    for s in blocks:
        out = out + s
    return out


def kernel_sums(terms: np.ndarray, plan, S: int = 1) -> np.ndarray:
    """The kernels' f32 sums: :func:`kernel_sum_order` rounded once to f32."""
    return kernel_sum_order(terms, plan, S).astype(np.float32)


def k1_terms(x):
    """K1's terms of f32 x, exact in f64: x and x * x."""
    x = np.asarray(x, np.float32).astype(np.float64)
    return x, x * x


def k3_terms(g, x, mean):
    """K3's terms, exact in f64: the f32 cotangent g and g * f32(x - mean)."""
    g = np.asarray(g, np.float32)
    d = (np.asarray(x, np.float32) - np.asarray(mean, np.float32)).astype(np.float32)
    return g.astype(np.float64), g.astype(np.float64) * d.astype(np.float64)


# (R, C, S, vec) at the model's kinds of site and around the plan's edges:
# one CTA, one block, two levels, ragged blocks, scalar lanes, units of 64
ORDER_CASES = [(7, 13, 1, False), (2048, 128, 1, True), (8192, 256, 1, True), (32768, 64, 64, True),
               (16384, 128, 64, True), (100003, 36, 1, True), (4096, 259, 1, False), (65536, 32, 16, True)]


@pytest.mark.parametrize("R,C,S,vec", ORDER_CASES)
def test_kernel_sum_order_against_f64(R, C, S, vec):
    """The transcribed order's f32 sums are the f64 sums' roundings to f32
    (within one f32 ulp of them: the two f64 sums differ in their last
    bits), for K1's terms (x and x * x) and K3's (a masked cotangent and its
    product with x - mean), far inside chip_smoke.py's BN_SUM_TOL of each
    channel's sum of |terms|."""
    import chip_smoke

    rng = np.random.RandomState(R + C)
    plan = bn_cuda.bn_plan(R, C, vec, 132, "reduce", S)
    x = (rng.randn(R, C) * 3 + 1).astype(np.float32)
    g = np.where(rng.rand(R, C) < 0.5, 0, rng.randn(R, C)).astype(np.float32)
    for terms in (*k1_terms(x), *k3_terms(g, x, np.float32(1.0))):
        got = kernel_sums(terms, plan, S)
        want = terms.sum(0)
        assert np.all(np.abs(got - want.astype(np.float32)) <= np.spacing(np.abs(want).astype(np.float32)))
        assert np.all(np.abs(got - want) <= chip_smoke.BN_SUM_TOL * np.abs(terms).sum(0))


def test_kernel_sum_order_is_not_the_flat_order():
    """The transcription follows the plan: at two levels its f64 sums differ
    in some bits from one sequential sum and from a sum over another plan's
    tree (so a test of the kernel against it can fail)."""
    R, C = 131072, 32
    rng = np.random.RandomState(0)
    x = k1_terms((rng.randn(R, C) * 3 + 1).astype(np.float32))[1]
    plan = bn_cuda.bn_plan(R, C, True, 132, "reduce")
    assert bn_cuda.bn_reduce_levels(plan[1], plan[4]) > 1
    got = kernel_sum_order(x, plan)
    flat = np.zeros(C)
    for r in x:
        flat = flat + r
    other = kernel_sum_order(x, bn_cuda.bn_plan(R, C, True, 114, "reduce"))
    assert not np.array_equal(got, flat) and not np.array_equal(got, other)


def epilogue_sums(dx: np.ndarray, plan, S: int = 1, centre: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/batchnorm.cu``'s K4 epilogue in numpy, f32 (``plan``: the
    ``"reduce_dx"`` launch plan in units of S rows). At a centred site
    (``centre``) corr's cotangent, each unit's -dx added from +0 in row order
    in f64 and rounded once, and the dense bias's, the units' sums negated
    and added as :func:`kernel_sum_order` adds rows (a thread's units in
    order, the row groups, the CTAs' two levels), rounded once; elsewhere
    the dense bias's alone, dx's rows added as :func:`kernel_sum_order` adds
    them. Returns (d_corr (R / S, C) or None, d_bias (C,))."""
    d = np.asarray(dx, np.float32).astype(np.float64)
    R, C = d.shape
    if not centre:
        return None, kernel_sum_order(d, plan, S).astype(np.float32)
    units = d.reshape(R // S, S, C)
    acc = np.zeros((R // S, C))
    for s in range(S):
        acc = acc + (-units[:, s])
    return acc.astype(np.float32), kernel_sum_order(-acc, plan, 1).astype(np.float32)


@pytest.mark.parametrize("R,C,S,vec", ORDER_CASES)
def test_epilogue_order_against_f64(R, C, S, vec):
    """The transcribed epilogue's f32 sums are within one f32 ulp of the f64
    sums of the same terms (corr's per unit, the dense bias's over the
    rows), on dx whose channels sum to ~0 (batch norm's training cotangent
    takes out its mean: the dense bias's case) and on plain random dx."""
    rng = np.random.RandomState(R + C + S)
    plan = bn_cuda.bn_plan(R, C, vec, 132, "reduce_dx", S)
    for dx in ((rng.randn(R, C) * 2).astype(np.float32),
               (lambda v: (v - v.mean(0)).astype(np.float32))(rng.randn(R, C) * 2)):
        d = dx.astype(np.float64)
        want_c, want_b = -d.reshape(R // S, S, C).sum(1), d.sum(0)
        for centre in (True, False):
            d_corr, d_bias = epilogue_sums(dx, plan, S, centre)
            assert (d_corr is None) != centre
            for got, want, terms in ((d_corr, want_c, np.abs(d).reshape(R // S, S, C).sum(1)),
                                     (d_bias, want_b, np.abs(d).sum(0))):
                if got is None:
                    continue
                allow = 2.0 ** -23 * np.abs(want) + 2.0 ** -40 * terms
                assert np.all(np.abs(got.astype(np.float64) - want) <= allow)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_prologue_cotangents_within_the_f64_gate(dtype, mode):
    """The plain stage's prologue cotangents (the op's, on the CPU): the dense
    bias's and corr's within one ulp of the dtype of torch's f64 sum of the
    op's own dx plus 2^-40 of the sum of |terms|; in training the dense
    bias's sum is ~0 (its terms cancel) and is held to that allowance, not to
    a relative tolerance; the bias's cotangent is f32 holding a value of h's
    dtype."""
    import chip_smoke

    h, corr, db, gp, params, stats = site(31, prologue="centre", ties=False)
    tdt = DTYPES[dtype]
    _, dh, dc, dd, _, _, _, _ = run_fused(h, corr, db, gp, params, stats, mode == "train", tdt, pool=False)
    assert dc.dtype == tdt
    d = dh.double().reshape(-1, h.shape[-1])
    ulps = chip_smoke.BN_F64_ULPS if dtype == "float32" else chip_smoke.BN_F64_ULPS_BF16
    wb, tb = d.sum(0), d.abs().sum(0)
    S = h.shape[2]
    wc, tc = (-d).view(-1, S, d.shape[-1]).sum(1), d.abs().view(-1, S, d.shape[-1]).sum(1)
    for got, want, terms in ((dd.double(), wb, tb), (dc.double().reshape(-1, h.shape[-1]), wc, tc)):
        assert bool(((got - want).abs() <= ulps * want.abs() + chip_smoke.BN_F64_FLOOR * terms).all())
    if mode == "train":  # the terms cancel: the sum is far below its terms
        assert float((wb.abs() / tb).max()) < 1e-3


def test_dense_bias_in_f32_is_the_cast_bias():
    """The op takes the layer's f32 bias and rounds it to h's dtype in the
    prologue: the same output as the bias cast to bf16 by the caller, and a
    cotangent in f32 that holds the same bf16 value."""
    h, corr, db, gp, params, stats = site(17, prologue="bias")
    outs = []
    for bias in (t(db), t(db).bfloat16()):
        bias = bias.requires_grad_(True)
        hh = t(h).bfloat16().requires_grad_(True)
        w, b = t(params["scale"]).requires_grad_(True), t(params["bias"]).requires_grad_(True)
        y = ops.batch_norm_relu(hh, w, b, t(stats["mean"]).clone(), t(stats["var"]).clone(), training=True,
                                dense_bias=bias, pool="max")
        y.backward(t(gp).bfloat16())
        outs.append((y, hh.grad, bias.grad))
    (y32, dh32, db32), (y16, dh16, db16) = outs
    assert db32.dtype == torch.float32 and db16.dtype == torch.bfloat16
    assert torch.equal(bits(y32), bits(y16)) and torch.equal(bits(dh32), bits(dh16))
    assert torch.equal(db32.bfloat16().float(), db32) and torch.equal(db32.bfloat16(), db16)


def test_channel_functions_are_the_torch_ops_they_hold():
    """``bn_channel_stats_plain`` and ``bn_channel_coefficients_plain`` equal,
    bit for bit on the CPU, the statements they were moved from (the op's
    forward and ``bn_input_coefficients``' caller before the move), over
    sums with var_raw < 0 and a NaN, with and without the update, and the
    eval end."""
    rng = np.random.RandomState(3)
    C, count, momentum, eps = 37, 4096, 0.9, 1e-5
    s = t((rng.randn(C) * count).astype(np.float32))
    sq = t((rng.rand(C) * count * 4).astype(np.float32))
    sq[:5] = s[:5] * s[:5] / count * 0.999  # E[x^2] - E[x]^2 < 0
    s[7] = float("nan")
    weight = t(rng.uniform(0.5, 1.5, C).astype(np.float32))
    rm0, rv0 = t(rng.randn(C).astype(np.float32)), t(rng.uniform(0.5, 2, C).astype(np.float32))
    for update in (True, False):
        rm, rv = rm0.clone(), rv0.clone()
        st = bn_op.bn_channel_stats_plain((s, sq), bn_cuda.BnChannels(count, weight, eps, momentum, rm, rv, update))
        mean = s / count  # the statements as the op ran them
        var_raw = sq / count - mean * mean
        var = torch.clamp(var_raw, min=0.0)
        wm, wv = rm0.clone(), rv0.clone()
        if update:
            wm.copy_(momentum * wm + (1 - momentum) * mean)
            wv.copy_(momentum * wv + (1 - momentum) * var)
        inv = torch.rsqrt(var + eps)
        mul = inv * weight
        for got, want in ((st[0], mean), (st[1], mul), (st[2], inv), (st[3], var_raw), (rm, wm), (rv, wv)):
            assert torch.equal(got.isnan(), want.isnan()) and torch.equal(bits(got)[~got.isnan()],
                                                                          bits(want)[~want.isnan()])
        assert bool((st[3] < 0).any())
        sum_g, sum_gx = t(rng.randn(C).astype(np.float32)), t(rng.randn(C).astype(np.float32))
        co = bn_op.bn_channel_coefficients_plain((sum_g, sum_gx), bn_cuda.BnCoefficients(st, weight, count, True))
        d_var = (sum_gx * weight) * (-0.5 * inv.pow(3))
        d_var = torch.where(var_raw < 0, 0.0, d_var)
        d_mean = -(mul * sum_g) - 2.0 * mean * d_var
        for got, want in ((co[0], d_mean / count), (co[1], 2.0 * (d_var / count)), (co[2], sum_gx * inv),
                          (co[3], sum_g)):
            assert torch.equal(got.isnan(), want.isnan()) and torch.equal(bits(got)[~got.isnan()],
                                                                          bits(want)[~want.isnan()])
    est = bn_op.bn_channel_stats_plain(None, bn_cuda.BnChannels(count, weight, eps, momentum, rm0, rv0, False))
    inv = torch.rsqrt(rv0 + eps)
    assert torch.equal(est[0], rm0) and torch.equal(bits(est[1]), bits(inv * weight)) and torch.equal(est[2], inv)


def same_bits(got, want) -> bool:
    """Equal dtypes and bits, NaNs at the same places (a NaN's payload
    aside); int32 counts equal."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(bits(got)[~nan], bits(want)[~nan])


def group_sums(C, count, seed):
    """f64 sums (2, C) of a data-parallel group's ``count`` rows: ordinary
    channels, channels whose E[x^2] - E[x]^2 rounds below 0, a NaN and a
    zero sum of squares (``tests/test_torch_cuda.py::random_channel_sums``'
    kinds)."""
    rng = np.random.RandomState(seed)
    mean = rng.randn(C) * 3
    s = mean * count
    sq = (rng.uniform(0.1, 4, C) + mean * mean) * count
    sq[:C // 4] = (s[:C // 4] / count) ** 2 * count * (1 - 1e-9)  # var_raw < 0
    s[C // 4], sq[C // 4 + 1] = np.nan, 0.0
    return t(np.stack([s, sq]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [0, 8], ids=["rows", "pool"])
def test_apply_stage_runs_the_group_statistics_end(dtype, pool):
    """Stage 2 given a data-parallel group's f64 sums (``group_sums``,
    ``channels``: the card's K2 runs the statistics' end so) equals, bit for
    bit, the statistics' end (``bn_channel_stats_plain``) followed by stage
    2 on its mean and mul (the composition it replaces): the output (the
    pool's maxima and counts), the statistics and the running statistics,
    with and without their update, on sums with var_raw < 0, a NaN and a
    zero, with the centred prologue."""
    rng = np.random.RandomState(6)
    R, C, S, count = 64, 24, 8, 4 * 64
    dt = DTYPES[dtype]
    h = t((rng.randn(R, C) * 2 + 1).astype(np.float32)).to(dt)
    pro = dict(corr=t(rng.randn(R // S, C).astype(np.float32)).to(dt), dense_bias=t(rng.randn(C).astype(np.float32)))
    weight, bias = t(rng.uniform(0.5, 1.5, C).astype(np.float32)), t(rng.randn(C).astype(np.float32))
    rm0, rv0 = t(rng.randn(C).astype(np.float32)), t(rng.uniform(0.5, 2, C).astype(np.float32))
    sums = group_sums(C, count, 7)
    for update in (True, False):
        chs = [bn_cuda.BnChannels(count, weight, EPS, MOMENTUM, rm0.clone(), rv0.clone(), update) for _ in range(2)]
        got, st = bn_op.bn_apply_plain(h, None, None, bias, dt, True, **pro, pool=pool, group_sums=sums,
                                       channels=chs[0])
        want_st = bn_op.bn_channel_stats_plain(sums, chs[1])
        want = bn_op.bn_apply_plain(h, want_st[0], want_st[1], bias, dt, True, **pro, pool=pool)
        assert bool((st[3] < 0).any()) and bool(st[0].isnan().any())
        for g, w in ((st, want_st), (chs[0].running_mean, chs[1].running_mean),
                     (chs[0].running_var, chs[1].running_var), *zip(got if pool else (got,), want if pool else (want,))):
            assert same_bits(g, w)
        assert torch.equal(chs[0].running_mean, rm0) != update


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooled", [False, True])
def test_eval_backward_stages_form_mul_from_the_running_statistics(dtype, pooled):
    """An eval backward's stages 3 and 4 given the running statistics
    (``eval_var``; stage 3's coefficients without st) equal, bit for bit,
    the composition they replace: the statistics' end from the running
    statistics (``bn_channel_stats_plain(None, ...)``), then stages 3 and 4
    on its mean and mul: the BN weight's and bias's cotangents, dx and the
    prologue's cotangents, at a pooled site too."""
    rng = np.random.RandomState(8)
    R, C, S = 96, 20, 8
    dt = DTYPES[dtype]
    h = t((rng.randn(R, C) * 2 + 1).astype(np.float32)).to(dt)
    pro = dict(corr=t(rng.randn(R // S, C).astype(np.float32)).to(dt), dense_bias=t(rng.randn(C).astype(np.float32)))
    weight, bias = t(rng.uniform(0.5, 1.5, C).astype(np.float32)), t(rng.randn(C).astype(np.float32))
    rm, rv = t(rng.randn(C).astype(np.float32)), t(rng.uniform(0.5, 2, C).astype(np.float32))
    if pooled:
        pro["pooled"] = bn_op.bn_apply_plain(h, rm, weight, bias, dt, True, **pro, pool=S, eval_var=rv, eps=EPS)
    dy = t(rng.randn(R // S if pooled else R, C).astype(np.float32)).to(dt)
    st = bn_op.bn_channel_stats_plain(None, bn_cuda.BnChannels(R, weight, EPS, MOMENTUM, rm, rv, False))
    want_co = bn_op.bn_bwd_reduce_plain(h, dy, st[0], st[1], bias, True, **pro,
                                        coefficients=bn_cuda.BnCoefficients(st, weight, R, False))
    want_dx = bn_op.bn_bwd_apply_plain(h, dy, st[0], st[1], bias, None, None, True, **pro, sums=True)
    got_co = bn_op.bn_bwd_reduce_plain(h, dy, rm, weight, bias, True, **pro, eval_var=rv, eps=EPS,
                                       coefficients=bn_cuda.BnCoefficients(None, weight, R, False))
    got_dx = bn_op.bn_bwd_apply_plain(h, dy, rm, weight, bias, None, None, True, **pro, sums=True, eval_var=rv,
                                      eps=EPS)
    assert same_bits(got_co[2:], want_co[2:])
    assert all(same_bits(g, w) for g, w in zip(got_dx, want_dx))
    assert bool((got_dx[0] != 0).any())


def test_launch_plan_kinds_match_the_compiled_launch_bounds():
    """Each kind of ``BN_CTAS_PER_SM`` is the CTAs an SM that
    csrc/batchnorm.cu compiles its kernels to (``__launch_bounds__``' second
    argument, the ``kCtas*`` constants named after the kinds), and every
    kernel's launch bounds name one of those constants."""
    import re
    from pathlib import Path

    src = (Path(bn_cuda.__file__).resolve().parents[2] / "csrc" / "batchnorm.cu").read_text()
    found = re.findall(r'constexpr int (kCtas\w+) = (\d+);\s*// "(\w+)"', src)
    assert {kind: int(n) for _, n, kind in found} == bn_cuda.BN_CTAS_PER_SM
    names = {name for name, _, _ in found}
    bounds = re.findall(r"__launch_bounds__\(kThreads, ([^)]*)\)", src)
    assert len(bounds) == 9  # K1, K2, the split K1-K4, K2's pool variant, K3, K4
    assert {"reduce_dy_split", "reduce_dx_split"} <= set(bn_cuda.CHUNKED_KINDS)
    used = [re.findall(r"kCtas\w+", b) for b in bounds]
    assert all(u and re.fullmatch(r"[\w ?:]+", b) for u, b in zip(used, bounds))  # constants and choices only
    assert set().union(*used) == names


@pytest.mark.parametrize("R,S", [(64 * 2048 * 8, 64), (64 * 256 * 8, 64), (16 * 8, 16), (3, 1), (640, 64)])
@pytest.mark.parametrize("C,vec", [(64, True), (128, True), (256, True), (13, False)])
@pytest.mark.parametrize("kind", list(bn_cuda.BN_CTAS_PER_SM))
def test_launch_plan_takes_whole_units(R, S, C, vec, kind):
    """In units of S rows: the CTAs cover the units once (the last ragged),
    each thread about BN_MIN_ROWS rows or more (half of that at least)
    where the plan is not at its cap of BN_CTAS_PER_SM a SM over all tiles;
    a reduction's fan-in is ceil(sqrt(CTAs)); rows that are not whole units
    raise."""
    W, ctas, tiles, per_cta, fan_in = bn_cuda.bn_plan(R, C, vec, 132, kind, S)
    units = R // S
    groups = bn_cuda.BN_THREADS // W
    min_units = -(-bn_cuda.BN_MIN_ROWS // S)
    assert (ctas - 1) * per_cta < units <= ctas * per_cta
    assert ctas * tiles <= max(tiles, bn_cuda.BN_CTAS_PER_SM[kind] * 132)
    if 1 < ctas < bn_cuda.BN_CTAS_PER_SM[kind] * 132 // tiles:
        assert 2 * per_cta >= groups * min_units
    assert fan_in == (math.isqrt(ctas - 1) + 1 if kind.startswith("reduce") else 0)
    if S > 1:
        with pytest.raises(ValueError):
            bn_cuda.bn_plan(R + 1, C, vec, 132, kind, S)


@pytest.mark.parametrize("name", ["rows_from_global", "centre_every_row", "single_roundings", "four_a_lane",
                                  "k3_eight_a_lane", "narrow_three_ctas", "k4_plan_b"])
def test_split_ablation_variants_apply_to_the_package(name):
    """Each of ``chip_smoke.py --split-ablation``'s variants edits this
    package's sources where it means to: every replacement's old text (the
    tried designs' patch hunks too, ``chip_smoke.SPLIT_WIDE_PATCH``) is in
    its file once when its turn comes; the patch adds the flag the variant
    sets."""
    from pathlib import Path

    import chip_smoke

    pkg = Path(bn_cuda.__file__).resolve().parents[2]
    what, changes = chip_smoke.split_ablation_edits()[name]
    files = {}
    for f, old, new in changes:
        text = files.setdefault(f, (pkg / f).read_text())
        assert text.count(old) == 1, (what, f, old[:80])
        files[f] = text.replace(old, new)
    assert all(files[f] != (pkg / f).read_text() for f in files)
    if name in ("k3_eight_a_lane", "k4_plan_b"):
        flag = "SPLIT_K3_WIDE" if name.startswith("k3") else "SPLIT_K4_WIDE"
        assert f"{flag} = True" in files["ops/cuda/batchnorm.py"]
        assert "split_rows_bulk" in files["csrc/batchnorm.cu"]


def cu_constant(name: str) -> int:
    """An integer constant of csrc/batchnorm.cu (``constexpr int name = ...;``)."""
    import re
    from pathlib import Path

    src = (Path(bn_cuda.__file__).resolve().parents[2] / "csrc" / "batchnorm.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def stage_rows() -> int:
    """csrc/batchnorm.cu's kStageRows: the rows a staging buffer of the split
    K1-K4 holds."""
    return cu_constant("kStageRows")


def split_window(S: int, groups: int) -> int:
    """A unit's rows a step of the split kernels' row loop: ``min(S,
    kStageRows // groups)`` (``split_rows``)."""
    return min(S, stage_rows() // groups)


def staged_row_order(plan, R: int, S: int, win: int):
    """The split kernels' row loop (``csrc/batchnorm.cu::split_rows``)
    transcribed: each CTA takes its units in chunks of
    one unit a row group (the chunk's g-th unit to row group g), each chunk
    in windows of ``win`` rows a unit (:func:`split_window`), all row groups'
    windows staged together. Returns {(CTA, row group): rows in the order it
    takes them} and the most rows one step stages."""
    W, ctas, _, per_cta, _ = plan
    groups = bn_cuda.BN_THREADS // W
    wins = -(-S // win)
    units = R // S
    order, most = {}, 0
    for k in range(ctas):
        u0, u1 = k * per_cta, min((k + 1) * per_cta, units)
        for step in range(-(-(u1 - u0) // groups) * wins):
            chunk, w = divmod(step, wins)
            r0, nr = w * win, min(win, S - w * win)
            staged = 0
            for rg in range(groups):
                u = u0 + chunk * groups + rg
                if u < u1:
                    order.setdefault((k, rg), []).append(np.arange(u * S + r0, u * S + r0 + nr))
                    staged += nr
            most = max(most, staged)
    return {key: np.concatenate(v) for key, v in order.items()}, most


@pytest.mark.parametrize("R,S", [(1024 * 64, 64), (9000 * 30, 30), (400 * 150, 150), (37 * 7, 7), (64 * 5, 1)])
@pytest.mark.parametrize("C,vec,width", [(128, True, 8), (128, True, 4), (64, True, 4), (36, True, 4),
                                         (13, False, 4)])
@pytest.mark.parametrize("kind", bn_cuda.CHUNKED_KINDS)
def test_split_plans_keep_units_whole_within_row_groups(R, S, C, vec, width, kind):
    """The split K1-K4's plans (``CHUNKED_KINDS``) give a CTA a multiple of
    its row groups' count of units, and their staged row loop takes each
    row once, each row group's units whole and in the order K1's and K3's
    sums assume (:func:`kernel_sum_order`: units u0 + rg, + groups, ...,
    each unit's S rows in turn), no step staging more rows than a buffer
    holds."""
    plan = bn_cuda.bn_plan(R, C, vec, 132, kind, S, width)
    W, ctas, tiles, per_cta, _ = plan
    groups = bn_cuda.BN_THREADS // W
    assert per_cta % groups == 0 and (ctas - 1) * per_cta < R // S <= ctas * per_cta
    order, most = staged_row_order(plan, R, S, split_window(S, groups))
    assert most <= stage_rows()
    for (k, rg), rows in order.items():
        units = np.arange(k * per_cta + rg, min((k + 1) * per_cta, R // S), groups)
        assert np.array_equal(rows, (units[:, None] * S + np.arange(S)[None]).ravel())
    assert np.array_equal(np.sort(np.concatenate(list(order.values()))), np.arange(R))


@pytest.mark.parametrize("R,C,S,width", [(2048 * 64, 128, 64, 8), (2048 * 64, 64, 64, 4), (9000 * 30, 128, 30, 8),
                                         (500 * 64, 36, 64, 4)])
def test_split_kernel_sum_order_against_f64(R, C, S, width):
    """K1's order from the split K1's plans (8 channels a lane in bf16,
    else 4) and K3's from the split K3's (4 channels a lane): the
    transcription's f32 sums are within one f32 ulp of the f64 sums of K1's
    terms (x, x * x) and K3's (a masked cotangent g and g * f32(x - mean));
    and at 8 channels a lane K1's order is another than the 4-channel
    plan's (its row groups and CTAs differ), which a test of the card
    against it can tell apart."""
    rng = np.random.RandomState(R + C)
    x = (rng.randn(R, C) * 3 + 1).astype(np.float32)
    g = np.where(rng.rand(R, C) < 0.5, 0, rng.randn(R, C)).astype(np.float32)
    k1_kind = "reduce_split_wide" if width == 8 else "reduce_split"
    for kind, lanes, all_terms in ((k1_kind, width, k1_terms(x)),
                                   ("reduce_dy_split", 4, k3_terms(g, x, np.float32(1.0)))):
        plan = bn_cuda.bn_plan(R, C, C % lanes == 0, 132, kind, S, lanes)
        for terms in all_terms:
            got = kernel_sums(terms, plan, S)
            want = terms.sum(0)
            assert np.all(np.abs(got - want.astype(np.float32)) <= np.spacing(np.abs(want).astype(np.float32)))
    if width == 8:
        plan = bn_cuda.bn_plan(R, C, True, 132, k1_kind, S, 8)
        narrow = bn_cuda.bn_plan(R, C, True, 132, "reduce_split", S, 4)
        assert narrow[0] != plan[0]
        sq = k1_terms(x)[1]
        assert not np.array_equal(kernel_sum_order(sq, plan, S), kernel_sum_order(sq, narrow, S))


def round_bf16_f64(v: np.ndarray) -> np.ndarray:
    """f64 values rounded once to bf16 (nearest, ties to even:
    ``__double2bfloat16``), as f32; for values of bf16's normal range, 0,
    infinities and NaN."""
    m, e = np.frexp(np.asarray(v, np.float64))
    with np.errstate(invalid="ignore"):
        return np.ldexp(np.rint(m * 256), e - 8).astype(np.float32)


def split_k4_sums(dx, xyz, centre, plan, S: int, dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
    """The split K4's epilogue (``csrc/batchnorm.cu::bn_bwd_apply_split_kernel``)
    in numpy for a launch ``plan`` (kind ``"reduce_dx_split"``) in units of
    S rows. Each row's xyz_r -
    centre_u is formed in f64 (one rounding), each term in f64 (the dense
    bias's dx_r, W3's (xyz_r - centre_u)[k] * dx_r, one f64 product), and
    the terms are added in K4s's order, which is :func:`kernel_sum_order`'s
    (a thread's rows in order, the row groups, the CTAs' two levels). The
    dense bias's sum is rounded once to ``dtype`` (held in f32), W3's to f32.
    Returns (d_bias (C,), d_w3 (3, C))."""
    d = np.asarray(dx, np.float32).astype(np.float64)
    diff = (np.asarray(xyz, np.float32).astype(np.float64).reshape(-1, S, 3)
            - np.asarray(centre, np.float32).astype(np.float64)[:, None]).reshape(-1, 3)
    bias = kernel_sum_order(d, plan, S)
    w3 = np.stack([kernel_sum_order(diff[:, k:k + 1] * d, plan, S) for k in range(3)]).astype(np.float32)
    return (bias.astype(np.float32) if dtype == "float32" else round_bf16_f64(bias)), w3


@pytest.mark.parametrize("R,C,S", [(2048 * 64, 128, 64), (2048 * 64, 64, 64), (9000 * 30, 128, 30),
                                   (500 * 64, 36, 64), (37 * 7, 128, 7), (37 * 7, 13, 7)])
def test_split_k4_sum_order_against_f64(R, C, S):
    """The split K4's dense-bias and W3 sums, transcribed over its plan
    (:func:`split_k4_sums`: 4 channels a lane, or 1), are within one f32 ulp of the f64 sums of the same terms (2^-23 of |sum|
    plus 2^-40 of the sum of |terms|: :func:`test_epilogue_order_against_f64`'s
    allowance), on dx whose channels sum to ~0 (batch norm's training
    cotangent takes out its mean: the dense bias's case) and on plain random
    dx, with coordinates around their units' centres; the bf16 rounding of
    the bias's sum within one bf16 ulp."""
    rng = np.random.RandomState(R + C + S)
    plan = bn_cuda.bn_plan(R, C, C % 4 == 0, 132, "reduce_dx_split", S)
    centre = rng.uniform(-3, 3, (R // S, 3)).astype(np.float32)
    xyz = (np.repeat(centre, S, 0) + rng.randn(R, 3) * 0.3).astype(np.float32)
    diff = (xyz.astype(np.float64).reshape(-1, S, 3) - centre.astype(np.float64)[:, None]).reshape(-1, 3)
    for dx in ((rng.randn(R, C) * 2).astype(np.float32),
               (lambda v: (v - v.mean(0)).astype(np.float32))(rng.randn(R, C) * 2)):
        d = dx.astype(np.float64)
        d_bias, d_w3 = split_k4_sums(dx, xyz, centre, plan, S)
        for got, want, terms in ((d_bias, d.sum(0), np.abs(d).sum(0)),
                                 (d_w3, diff.T @ d, np.abs(diff).T @ np.abs(d))):
            assert np.all(np.abs(got.astype(np.float64) - want) <= 2.0 ** -23 * np.abs(want) + 2.0 ** -40 * terms)
        b16, _ = split_k4_sums(dx, xyz, centre, plan, S, "bfloat16")
        assert np.all(np.abs(b16.astype(np.float64) - d.sum(0))
                      <= 2.0 ** -8 * np.abs(d.sum(0)) + 2.0 ** -40 * np.abs(d).sum(0))


# ------------------------------------------------------ the model's stacks

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_mlp_stack_is_its_layers_written_out(dtype, training):
    """``MLPStack(center=, pool="max")`` equals, bit for bit, its layers
    written out as the port ran them before the fusion (the product, the
    prologue's torch ops with their cotangents summed in f64 as the op sums
    them, batch norm + ReLU, torch.amax), forward and the parameters' and
    input's gradients, with and without the project-first gather
    (``idx``)."""
    from votenet_tpu_torch.models.pointnet2 import MLPStack

    dt = DTYPES[dtype]
    rng = np.random.RandomState(4)
    B, N, M, S, cin = 2, 20, 5, 8, 6
    stack = MLPStack(cin, (8, 12), torch.Generator().manual_seed(1), dtype=dt).train(training)
    pts = t(rng.randn(B, N, cin).astype(np.float32))
    center = t(rng.randn(B, M, 3).astype(np.float32))
    idx = t(rng.randint(0, N, (B, M, S)).astype(np.int32))
    gp = t(rng.randn(B, M, 12).astype(np.float32)).to(dt)
    for use_idx in (False, True):
        outs = []
        for fused in (True, False):
            stack.zero_grad()
            x = pts.clone().requires_grad_(True)
            if fused:
                y = stack(x, center=center, idx=idx, pool="max") if use_idx else \
                    stack(ops.group_point(x, idx), center=center, pool="max")
            else:
                w = stack.dense0.weight.t().to(dt)
                hh = ops.group_point(x.to(dt) @ w, idx) if use_idx else ops.group_point(x, idx).to(dt) @ w
                h1 = F64Prologue.apply(hh, center.to(dt) @ w[:3], stack.dense0.bias)
                h1 = stack.bn0(h1, relu=True)
                h2 = F64Prologue.apply(h1 @ stack.dense1.weight.t().to(dt), None, stack.dense1.bias)
                y = torch.amax(stack.bn1(h2, relu=True), dim=2)
            y.backward(gp)
            outs.append([y] + [p.grad.clone() for p in stack.parameters()] + [x.grad])
        for a, b in zip(*outs):
            assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))
