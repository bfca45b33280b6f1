"""Batch norm + ReLU as one op (``ops.batch_norm_relu``) on its plain stages,
on the CPU.

What is held, and to what:

- The op against flax ``nn.BatchNorm`` + ``nn.relu`` run by JAX on the CPU:
  outputs, the running statistics after a step and ``jax.grad``'s input and
  parameter cotangents, f32 and bf16, train, eval and frozen, odd C, a
  constant channel (the variance's clamp). f32: 2e-6 of scale, the sums'
  order being the only difference (the tolerance of
  ``tests/test_torch_train.py``'s batch-norm test). bf16: the outputs
  within 2^-8 of scale (half a bf16 step at the scale's binade: both round
  f32 values whose statistics differ in the last f32 bits; measured 0),
  the input's cotangent within 2^-7 (one bf16 step: flax rounds the
  cotangent of each of x's three uses to bf16 before adding them, the port
  adds in f32 and rounds once; 14% of the elements differ by one step),
  the statistics and the parameters' cotangents 2e-6 of scale.
- NaN and signed-zero inputs against the port's earlier eager batch norm +
  ``torch.relu`` (the ReLU's edge cases are torch's on the device: a NaN
  output passes its gradient, which flax's ReLU does not): outputs bit for
  bit, gradients with the same NaNs and 1e-6 of scale elsewhere.
- Stage 2 against a numpy transcription of the kernel's stated order, bit
  for bit; the backward's coefficients (numpy, f64) against autograd of
  the eager batch norm in f64, 1e-12 of scale, at a constant channel on
  either side of the clamp and on it.
- The op in f32 against an f64 run of the same formula: forward 1e-6 of
  scale, gradients 1e-5 norm-wise (measured on these inputs: see
  ``F64_TOL``), inside the port's f32 limits of 1e-4 and 5e-3.
- The synced path: two gloo ranks in spawned processes, each with half of
  the rows, against one process with all of them: 1e-5 of scale.
- The stages' launch plan, other devices' refusal, and the counts of stage
  calls a forward and a training step of the tiny model make
  (``chip_smoke.py``'s ``bn_launches`` from the layer list). The wrappers'
  refusal of CPU tensors is in ``tests/test_torch_import.py``.
"""

import numpy as np
import pytest
import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.ops import batchnorm as bn_op
from votenet_tpu_torch.ops.cuda import batchnorm as bn_cuda

EPS = 1e-5
MOMENTUM = 0.9


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rel):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def case(seed, shape, constant=None):
    """x (f32, scale 3, mean 1), a cotangent w, parameters and statistics."""
    rng = np.random.RandomState(seed)
    C = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    if constant is not None:
        x[..., 1] = constant
    w = rng.randn(*shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": rng.randn(C).astype(np.float32), "var": rng.uniform(0.5, 2, C).astype(np.float32)}
    return x, w, params, stats


def run_op(x, w, params, stats, training, update_stats=True, dtype=torch.float32, relu=True, group=None):
    """The op on CPU tensors: (y, dx, d_scale, d_bias, running_mean, running_var)."""
    weight = t(params["scale"]).requires_grad_(True)
    bias = t(params["bias"]).requires_grad_(True)
    rm, rv = t(stats["mean"]).clone(), t(stats["var"]).clone()
    xt = x.clone().requires_grad_(True) if isinstance(x, torch.Tensor) else t(x).to(dtype).requires_grad_(True)
    y = ops.batch_norm_relu(xt, weight, bias, rm, rv, training=training, momentum=MOMENTUM, eps=EPS, group=group,
                            update_stats=update_stats, dtype=dtype, relu=relu)
    (y.float() * t(w)).sum().backward()
    return y, xt.grad, weight.grad, bias.grad, rm, rv


def eager_bn_relu(x, weight, bias, rm, rv, training, dtype=torch.float32, relu=True, update_stats=True):
    """The port's earlier eager ``BatchNorm.forward`` + ``torch.relu``
    (autograd through every op), in f32 or, for an f64 input, in f64."""
    x = x if x.dtype == torch.float64 else x.float()
    if training:
        axes = tuple(range(x.dim() - 1))
        count = x.numel() // x.shape[-1]
        s, sq = x.sum(dim=axes), (x * x).sum(dim=axes)
        mean = s / count
        var = torch.clamp(sq / count - mean * mean, min=0.0)
        if update_stats:
            with torch.no_grad():
                rm.copy_(MOMENTUM * rm + (1 - MOMENTUM) * mean)
                rv.copy_(MOMENTUM * rv + (1 - MOMENTUM) * var)
    else:
        mean, var = rm, rv
    mul = torch.rsqrt(var + EPS) * weight
    y = ((x - mean) * mul + bias).to(dtype)
    return torch.relu(y) if relu else y


def flax_reference(x, w, params, stats, training, dtype):
    """flax ``BatchNorm`` + ``relu``: (y, gx, g_scale, g_bias, new batch_stats)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    bn = fnn.BatchNorm(use_running_average=not training, momentum=MOMENTUM, epsilon=EPS, dtype=dtype)

    def f(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        y = fnn.relu(y)
        return jnp.sum(y.astype(jnp.float32) * w), (y, mut["batch_stats"])

    xj = jnp.asarray(x).astype(dtype)
    fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    (_, (y, new)), (gp, gx) = fn.lower(params, xj).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, xj)
    return (np.asarray(y.astype(jnp.float32)), np.asarray(gx.astype(jnp.float32)), np.asarray(gp["scale"]),
            np.asarray(gp["bias"]), {k: np.asarray(v) for k, v in new.items()})


# ------------------------------------------------------------ against flax

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval", "frozen"])
@pytest.mark.parametrize("shape", [(2, 16, 8, 13), (3, 40, 16)], ids=["odd-C", "C16"])
def test_op_matches_flax(dtype, mode, shape):
    """Outputs, gradients and running statistics against flax; "frozen" is
    training that leaves the running statistics alone (remat's recompute),
    so its outputs and gradients are flax's training ones."""
    import jax.numpy as jnp

    x, w, params, stats = case(len(shape) + len(mode), shape)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    training = mode != "eval"
    y, gx, gs, gb, rm, rv = run_op(x, w, params, stats, training, update_stats=mode == "train", dtype=tdt)
    x_in = t(x).to(tdt).float().numpy()  # the input flax sees: rounded to bf16 in bf16 mode
    fy, fgx, fgs, fgb, fnew = flax_reference(x_in, w, params, stats, training, getattr(jnp, dtype))
    assert y.dtype == tdt and gx.dtype == tdt
    close(y, fy, 2e-6 if dtype == "float32" else 2 ** -8)
    close(gx, fgx, 2e-6 if dtype == "float32" else 2 ** -7)
    close(gs, fgs, 2e-6)
    close(gb, fgb, 2e-6)
    if mode == "train":
        close(rm, fnew["mean"], 2e-6)
        close(rv, fnew["var"], 2e-6)
    else:  # eval and frozen leave them where they were
        np.testing.assert_array_equal(rm.numpy(), stats["mean"])
        np.testing.assert_array_equal(rv.numpy(), stats["var"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_constant_channel_matches_flax(dtype):
    """A channel of one exactly representable value over 2^k rows: its sums
    are exact, E[x^2] - E[x]^2 is 0 (the clamp's boundary), x - mean is 0,
    so its output is the bias through the ReLU and its scale's gradient 0;
    the rest as flax."""
    import jax.numpy as jnp

    x, w, params, stats = case(7, (4, 32, 9), constant=0.5)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    y, gx, gs, gb, rm, rv = run_op(x, w, params, stats, True, dtype=tdt)
    fy, fgx, fgs, fgb, fnew = flax_reference(t(x).to(tdt).float().numpy(), w, params, stats, True, getattr(jnp, dtype))
    bias1 = float(torch.tensor(params["bias"][1]).to(tdt))
    np.testing.assert_array_equal(y[..., 1].detach().float().numpy(), max(bias1, 0.0))
    assert float(gs[1]) == 0.0
    close(y, fy, 2e-6 if dtype == "float32" else 2 ** -8)
    close(gx, fgx, 2e-6 if dtype == "float32" else 2 ** -7)
    close(gs, fgs, 2e-6)
    close(gb, fgb, 2e-6)
    close(rv, fnew["var"], 2e-6)


# ---------------------------------------------- the device's edge cases

@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nan_and_signed_zeros_as_eager(training, dtype):
    """NaN inputs (one element in eval; a whole channel's statistics in
    training) and outputs that are exactly +0 and -0 (x at the running mean,
    a negative scale, a -0 bias) against the earlier eager code on the
    CPU: outputs bit for bit (NaNs where it has them, zeros with their
    signs), gradients with the same NaNs and within 1e-6 of scale
    elsewhere. A NaN output passes its gradient (threshold_backward)."""
    x, w, params, stats = case(3, (2, 24, 8))
    params["scale"][2], params["bias"][2] = -1.0, -0.0
    params["bias"][3] = 0.0
    stats["mean"][2:4] = t(stats["mean"][2:4]).bfloat16().float().numpy()  # x can hold it in bf16 too
    x[0, :5, 2] = stats["mean"][2]  # eval: (x - mean) * mul + bias == -0
    x[1, :5, 3] = stats["mean"][3]  # eval: == +0
    x[1, 7, 5] = np.nan
    y, gx, gs, gb, rm, rv = run_op(x, w, params, stats, training, dtype=dtype)

    weight = t(params["scale"]).requires_grad_(True)
    bias = t(params["bias"]).requires_grad_(True)
    ref_rm, ref_rv = t(stats["mean"]).clone(), t(stats["var"]).clone()
    xt = t(x).to(dtype).requires_grad_(True)
    ry = eager_bn_relu(xt, weight, bias, ref_rm, ref_rv, training, dtype=dtype)
    (ry.float() * t(w)).sum().backward()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    nan = torch.isnan(ry)
    assert torch.equal(torch.isnan(y), nan) and nan.any()
    assert torch.equal(y[~nan].view(bits), ry[~nan].view(bits))
    if not training:
        assert torch.signbit(ry[0, :5, 2].float()).all() and not torch.signbit(ry[1, :5, 3].float()).any()
    for got, want in ((gx, xt.grad), (gs, weight.grad), (gb, bias.grad), (rm, ref_rm), (rv, ref_rv)):
        got, want = got.float(), want.float()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        close(got[ok], want[ok].numpy(), 1e-6)


# ---------------------------------------------------- the stated orders

def round_bf16(v):
    """float32 -> bf16 (nearest, ties to even; NaN kept a NaN) -> float32, numpy."""
    b = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16).astype(np.uint32)
    return np.where(np.isnan(v), v, r.view(np.float32)).astype(np.float32)


def k2_numpy(x, mean, mul, bias, bf16, relu):
    """csrc/batchnorm.cu's bn_apply_kernel: f32 (x - mean), * mul, + bias,
    each rounded once; the cast; the ReLU (a NaN stays)."""
    y = ((x.astype(np.float32) - mean) * mul) + bias
    y = round_bf16(y) if bf16 else y
    return np.where(np.isnan(y) | (y > 0), y, np.float32(0)) if relu else y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [True, False])
def test_apply_stage_is_the_kernels_order(dtype, relu):
    """bn_apply_plain equals the kernel's order transcribed into numpy, bit
    for bit, on values with no exact zero before the ReLU (whose sign
    follows the device's torch.relu)."""
    rng = np.random.RandomState(5)
    R, C = 301, 19
    x = (rng.randn(R, C) * 4 + 2).astype(np.float32)
    x[3, 4] = np.nan
    mean = rng.randn(C).astype(np.float32)
    mul = rng.uniform(-2, 2, C).astype(np.float32)
    bias = rng.randn(C).astype(np.float32)
    xin = t(x).to(dtype)
    got = bn_op.bn_apply_plain(xin, t(mean), t(mul), t(bias), dtype, relu).float().numpy()
    want = k2_numpy(xin.float().numpy(), mean, mul, bias, dtype == torch.bfloat16, relu)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 1
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok].view(np.uint32), want[ok].view(np.uint32))


@pytest.mark.parametrize("constant", [None, 0.3, 0.5], ids=["normal", "constant-0.3", "constant-0.5"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_backward_coefficients_match_eager_autograd(constant, training):
    """The backward as the op writes it (stage 3's sums, then
    ``bn_input_coefficients``' a and b, then stage 4's ``g * mul + a + b *
    x``), all in numpy f64, against autograd of the eager batch norm + ReLU
    in f64: x's, the scale's and the bias's cotangents within 1e-12 of
    scale. A constant channel of 0.3 leaves E[x^2] - E[x]^2 a rounding away
    from 0 on either side; 0.5 over 2^k rows hits it exactly."""
    x, w, params, stats = case(11, (8, 16, 6), constant=constant)
    x = x.astype(np.float64)
    weight = torch.tensor(params["scale"], dtype=torch.float64, requires_grad=True)
    bias = torch.tensor(params["bias"], dtype=torch.float64, requires_grad=True)
    rm, rv = torch.tensor(stats["mean"], dtype=torch.float64), torch.tensor(stats["var"], dtype=torch.float64)
    xt = torch.tensor(x, requires_grad=True)
    y = eager_bn_relu(xt, weight, bias, rm, rv, training, dtype=torch.float64, update_stats=False)
    (y * torch.tensor(w, dtype=torch.float64)).sum().backward()

    rows, g_out = x.reshape(-1, 6), w.astype(np.float64).reshape(-1, 6)
    n = rows.shape[0]
    if training:  # the eager code's own sums, so that the clamp sees its sign of E[x^2] - E[x]^2
        xd = xt.detach()
        mean = (xd.sum(dim=(0, 1)) / n).numpy()
        var_raw = ((xd * xd).sum(dim=(0, 1)) / n).numpy() - mean * mean
        var = np.maximum(var_raw, 0.0)
    else:
        mean, var = stats["mean"].astype(np.float64), stats["var"].astype(np.float64)
    inv = 1.0 / np.sqrt(var + EPS)
    mul = inv * params["scale"].astype(np.float64)
    g = np.where((rows - mean) * mul + params["bias"] <= 0, 0.0, g_out)  # stage 3
    sum_g, sum_gx = g.sum(0), (g * (rows - mean)).sum(0)
    dx = g * mul
    if training:
        a, b = bn_op.bn_input_coefficients(*(torch.tensor(v) for v in (
            sum_g, sum_gx, mean, mul, inv, params["scale"].astype(np.float64), var_raw)), count=n)
        dx = (dx + a.numpy()) + b.numpy() * rows  # stage 4
    close(dx.reshape(x.shape), xt.grad.numpy(), 1e-12)
    close(sum_gx * inv, weight.grad.numpy(), 1e-12)
    close(sum_g, bias.grad.numpy(), 1e-12)


# Measured with these inputs on the CPU (max over the cases): forward and
# running statistics 1.2e-7 of scale, gradients 1.8e-7 norm-wise. Held to:
F64_TOL = {"forward": 1e-6, "grad": 1e-5}


def f64_reference(x, w, params, stats, training):
    weight = torch.tensor(params["scale"], dtype=torch.float64, requires_grad=True)
    bias = torch.tensor(params["bias"], dtype=torch.float64, requires_grad=True)
    rm, rv = torch.tensor(stats["mean"], dtype=torch.float64), torch.tensor(stats["var"], dtype=torch.float64)
    xt = torch.tensor(x.astype(np.float64), requires_grad=True)
    y = eager_bn_relu(xt, weight, bias, rm, rv, training, dtype=torch.float64)
    (y * torch.tensor(w, dtype=torch.float64)).sum().backward()
    return y, xt.grad, weight.grad, bias.grad, rm, rv


def norm_gap(got, want):
    got, want = got.detach().double(), want.detach().double()
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 64, 16, 24), (2, 333, 7)], ids=["sa-like", "odd"])
def test_f32_op_against_f64(training, shape):
    """The op in f32 against the same formula in f64: forward within
    F64_TOL["forward"] of scale, running statistics too, gradients within
    F64_TOL["grad"] norm-wise."""
    x, w, params, stats = case(sum(shape), shape)
    y, gx, gs, gb, rm, rv = run_op(x, w, params, stats, training)
    ry, rgx, rgs, rgb, rrm, rrv = f64_reference(x, w, params, stats, training)
    close(y, ry.detach().numpy(), F64_TOL["forward"])
    close(rm, rrm.numpy(), F64_TOL["forward"])
    close(rv, rrv.numpy(), F64_TOL["forward"])
    for got, want in ((gx, rgx), (gs, rgs), (gb, rgb)):
        assert norm_gap(got, want) <= F64_TOL["grad"]


# ------------------------------------------------------------ synced BN

def _synced_rank(rank, world, x, w, params, stats):
    """One rank's half of the rows through the op over the world group."""
    import torch.distributed as dist

    half = x.shape[0] // world
    mine = slice(rank * half, (rank + 1) * half)
    y, gx, gs, gb, rm, rv = run_op(x[mine], w[mine], params, stats, True, group=dist.group.WORLD)
    return {k: v.detach().numpy() for k, v in dict(y=y, gx=gx, gs=gs, gb=gb, rm=rm, rv=rv).items()}


def test_synced_two_ranks_match_one_process():
    """Two gloo ranks, each with half of the batch, against one process with
    all of it: each rank's outputs and input cotangents are its rows' of the
    one process, the running statistics the same on both ranks, and the
    parameter cotangents (each rank's own) sum to the one process's; 1e-5
    of scale (the sums are added in another grouping)."""
    from votenet_tpu_torch.parallel.launch import run_ranks

    x, w, params, stats = case(21, (4, 20, 11))
    ranks = run_ranks(_synced_rank, 2, args=(x, w, params, stats), timeout=240)
    y, gx, gs, gb, rm, rv = run_op(x, w, params, stats, True)
    close(np.concatenate([r["y"] for r in ranks]), y.detach().numpy(), 1e-5)
    close(np.concatenate([r["gx"] for r in ranks]), gx.numpy(), 1e-5)
    close(ranks[0]["gs"] + ranks[1]["gs"], gs.numpy(), 1e-5)
    close(ranks[0]["gb"] + ranks[1]["gb"], gb.numpy(), 1e-5)
    for r in ranks:
        close(r["rm"], rm.numpy(), 1e-5)
        close(r["rv"], rv.numpy(), 1e-5)
    np.testing.assert_array_equal(ranks[0]["rm"], ranks[1]["rm"])


# ------------------------------------------------- plan, refusals, counts

@pytest.mark.parametrize("R", [1, 7, 2048, 131072, 1048576, 8388608])
@pytest.mark.parametrize("C,vec", [(16, True), (64, True), (256, True), (13, False), (259, False), (1024, True)])
@pytest.mark.parametrize("kind", list(bn_cuda.BN_CTAS_PER_SM))
def test_launch_plan_covers_every_row_and_channel(R, C, vec, kind):
    """The CTAs cover the rows once (the last one ragged), the tiles the
    lanes, a CTA holds at most BN_THREADS lanes, the CTAs stay within
    BN_CTAS_PER_SM a SM over all tiles, a reduction's two levels cover its
    CTAs (blocks of fan_in, then the blocks; each at most ~sqrt(CTAs) + 1
    partials a channel), and its workspace ((ctas + blocks) x C x 2 f64
    partial sums) below 4 MB at the model's widths."""
    W, ctas, tiles, rows, fan_in = bn_cuda.bn_plan(R, C, vec, 132, kind)
    lanes = C // 4 if vec else C
    assert 1 <= W <= bn_cuda.BN_THREADS and tiles * W >= lanes > (tiles - 1) * W
    assert (ctas - 1) * rows < R <= ctas * rows
    assert ctas * tiles <= max(tiles, bn_cuda.BN_CTAS_PER_SM[kind] * 132)
    if not kind.startswith("reduce"):
        assert fan_in == 0
        return
    blocks = bn_cuda.bn_reduce_levels(ctas, fan_in)
    assert (blocks - 1) * fan_in < ctas <= blocks * fan_in
    assert fan_in * fan_in >= ctas and max(fan_in, blocks) <= np.sqrt(ctas) + 1
    assert C > 259 or (ctas + blocks) * C * 2 * 8 <= 4 << 20


def test_other_devices_raise():
    x = torch.zeros(2, 3, 4, device="meta")
    v = torch.zeros(4, device="meta")
    with pytest.raises(NotImplementedError):
        ops.batch_norm_relu(x, v, v, v, v, training=False)


def counted_stages(monkeypatch):
    """Substitute counting wrappers for the plain stages; returns the counts,
    keyed as ``chip_smoke.bn_counters``: each stage's calls over full rows,
    K2's pool variant's and K3's and K4's at a pooled site, the calls that
    took the centred, the split or the bias prologue (and each stage's with
    the split one), stage 4's calls that summed the
    dense bias's cotangent and stage 2's that ran the statistics' end from a
    data-parallel group's sums."""
    import chip_smoke

    counts = dict.fromkeys(chip_smoke.BN_COUNTS, 0)
    for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply"):
        plain = getattr(bn_op, f"{name}_plain")

        def counted(*a, _plain=plain, _name=name, **kw):
            counts[_name + ("_pool" if kw.get("pool") else "_pooled" if kw.get("pooled") is not None else "")] += 1
            if kw.get("sums") and kw.get("dense_bias") is not None:
                counts["bn_bwd_apply_sums"] += 1
            if kw.get("group_sums") is not None:
                counts["bn_apply_group"] += 1
            if kw.get("coords") is not None:  # the split prologue (mixed precision's, bf16_hilo's first layer)
                counts["bn_prologue_split"] += 1
                counts["bn_split_" + _name[3:]] += 1
            elif kw.get("corr") is not None:
                counts["bn_prologue_centre"] += 1
            elif kw.get("dense_bias") is not None:
                counts["bn_prologue_bias"] += 1
            return _plain(*a, **kw)

        monkeypatch.setattr(bn_op, f"{name}_plain", counted)
    return counts


@pytest.mark.parametrize("what", ["eval-samlp-off", "eval-samlp-on", "eval-mixed-samlp-on", "train", "train-remat",
                                  "eval-mixed-samlp-off", "eval-bf16", "train-mixed", "train-bf16", "train-packed",
                                  "train-group"])
def test_stage_calls_follow_the_layer_list(monkeypatch, what):
    """The tiny model's forward and training step call each stage as often
    as chip_smoke.py's bn_launches counts from the layer list: one apply a
    batch-norm site in eval (none where samlp fuses the layer), the pool
    variant at each SA layer's last width; stats and apply a site, and
    under remat again for sa1-sa4, and both backward stages once a site
    (pooled at the pools) in a step, under a data-parallel group (a
    one-rank gloo group here) too, where each apply runs the statistics'
    end from the group's sums and no other stage runs; every call with its
    site's prologue (the centred one at an SA layer's first width but mixed
    precision's and bf16_hilo's split ones, the dense bias elsewhere)."""
    import torch.distributed as dist

    import chip_smoke
    from votenet_tpu_torch.config import tiny_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config(samlp="on" if "samlp-on" in what else "off", mixed_precision="mixed" in what,
                      remat="remat" in what, compute_dtype="bfloat16" if "bf16" in what else "float32",
                      gather_packing="bf16_hilo" if "packed" in what else "none")
    scenes = synthetic_scenes(0, cfg, 2)
    counts = counted_stages(monkeypatch)
    if what.startswith("eval"):
        with torch.no_grad():
            VoteNet(cfg)(torch.from_numpy(np.stack([s["points"] for s in scenes])))
        want = chip_smoke.bn_launches(cfg, train=False, samlp=cfg.samlp == "on")
    elif what == "train-group":
        from votenet_tpu_torch.parallel.launch import free_port, init_process_group

        state = create_train_state(cfg, 10, device="cpu")
        init_process_group("gloo", 1, 0, free_port(), 120)
        try:
            make_train_step(cfg, group=dist.group.WORLD)(state, next(batch_scenes(iter(scenes), 2, cfg.max_gt_boxes)))
        finally:
            dist.destroy_process_group()
        want = chip_smoke.bn_launches(cfg, train=True, group=True)
        assert want["bn_apply_group"] == want["bn_stats"] > 0
    else:
        state = create_train_state(cfg, 10, device="cpu")
        make_train_step(cfg)(state, next(batch_scenes(iter(scenes), 2, cfg.max_gt_boxes)))
        want = chip_smoke.bn_launches(cfg, train=True)
    assert counts == want
    assert want["bn_apply"] > 0 and want["bn_prologue_bias"] > 0
    assert want["bn_apply_pool"] == {"eval-samlp-on": 0, "eval-mixed-samlp-on": 3, "train-remat": 9}.get(what, 5)
    if "mixed" not in what and "packed" not in what and what != "eval-samlp-on":
        assert want["bn_prologue_centre"] > 0
