"""Parity of the port's training path with the JAX package, on the CPU.

``tiny_config()`` widths, inputs from numpy seeds, JAX on the CPU through its
XLA twins (and the Pallas scatter kernel in interpret mode); the port runs the
plain versions of its kernels. What is held, and to what:

- The scatter-add (the group_point backward): the port's plain version is
  bit-identical to a sequential ``np.add.at`` (``index_add_`` on the CPU adds
  in index order). Against the JAX package's ``scatter_add_mxu`` and
  ``scatter_add_pallas`` it agrees to rtol 1e-6, atol 1e-5, the JAX tests'
  own tolerance: their one-hot products sum in another order.
- group_point's backward, training batch norm, the loss and the train-mode
  SA layers: each against its JAX twin to 1e-6 - 1e-5 of scale (f32 sums in
  another order), the SA layers' parameter gradients norm-wise.
- The optimizer: the schedule exactly; clip and Adam to 1e-6 relative.
- One whole training step from the same parameters: losses and batch-norm
  statistics to 1e-4 of scale, gradients norm-wise per leaf
  (``check_grads``), updated parameters (``check_update``), with the
  positive and negative masks and the proposal assignments equal, so that
  no tolerance hides a flip. The JAX f32 step is the noisier side there
  (see ``check_grads``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from votenet_tpu.config import tiny_config
from votenet_tpu.data.dataflow import batch_scenes
from votenet_tpu.data.synthetic import synthetic_scenes
from votenet_tpu_torch.models import convert_flax_opt_state, convert_flax_variables, flax_param_path, votenet_loss
from votenet_tpu_torch.models.pointnet2 import BatchNorm
from votenet_tpu_torch.ops import group_point, scatter_add
from votenet_tpu_torch.ops.cuda.scatter import scatter_add_plain
from votenet_tpu_torch.train import (
    Trainer,
    clip_by_average_norm_,
    create_train_state,
    forward_backward,
    make_lr_schedule,
    make_train_step,
)

# At tiny widths a random model's proposals sit far from the GT centres; the
# looser thresholds give the step positives (3 of 32 proposals on the batch
# of seed 0 at flax's PRNGKey(0) init), so that every loss term and its
# gradient is live.
STEP_CFG = dict(positive_thres=1.0, negative_thres=1.5)
STEP_SEED = 0


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, float(np.abs(want).max())))


def scatter_case(seed, B, K, N, C):
    rng = np.random.RandomState(seed)
    g = rng.randn(B, K, C).astype(np.float32)
    idx = rng.randint(0, N, size=(B, K)).astype(np.int32)
    return g, idx


def add_at(g, idx, N):
    out = np.zeros((g.shape[0], N, g.shape[2]), np.float32)
    for b in range(g.shape[0]):
        np.add.at(out[b], idx[b], g[b])
    return out


# ------------------------------------------------------------- scatter-add

@pytest.mark.parametrize(
    "B,K,N,C",
    [(2, 1024 * 64, 2048, 128), (2, 256 * 64, 512, 256), (1, 777, 100, 131), (3, 64, 5, 1)],
    ids=["sa2", "sa4", "ragged", "narrow"],
)
def test_scatter_plain_is_sequential_add_at(B, K, N, C):
    g, idx = scatter_case(B * K + C, B, K, N, C)
    np.testing.assert_array_equal(scatter_add_plain(t(g), t(idx), N).numpy(), add_at(g, idx, N))


@pytest.mark.parametrize("B,M,S,N,C", [(2, 32, 8, 64, 35), (1, 16, 8, 40, 128)])
def test_scatter_plain_matches_jax(B, M, S, N, C):
    from votenet_tpu.ops.grouping import scatter_add_mxu
    from votenet_tpu.ops.pallas.scatter import scatter_add_pallas

    g, idx = scatter_case(7 + C, B, M * S, N, C)
    g4, idx3 = g.reshape(B, M, S, C), idx.reshape(B, M, S)
    got = scatter_add(t(g4), t(idx3), N).numpy()
    for want in (scatter_add_mxu(jnp.asarray(g4), jnp.asarray(idx3), N),
                 scatter_add_pallas(jnp.asarray(g4), jnp.asarray(idx3), N, passes=3, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("skip", [0, 3])
def test_group_point_backward_matches_jax(skip):
    """The backward against jax.grad of the JAX package's custom-VJP gather,
    with and without the skipped coordinate prefix (zeros there)."""
    from votenet_tpu.ops.grouping import _group_point_tpu

    rng = np.random.RandomState(11 + skip)
    B, N, C, M, S = 2, 50, 19, 12, 8
    pts = rng.randn(B, N, C).astype(np.float32)
    idx = rng.randint(0, N, size=(B, M, S)).astype(np.int32)
    w = rng.randn(B, M, S, C).astype(np.float32)  # the cotangent
    want = jax.grad(lambda p: jnp.sum(_group_point_tpu(N, skip, p, jnp.asarray(idx)) * w))(jnp.asarray(pts))
    p = t(pts).requires_grad_(True)
    out = group_point(p, t(idx), grad_skip_prefix=skip)
    np.testing.assert_array_equal(out.detach().numpy(), pts[np.arange(B)[:, None, None], idx])
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    if skip:
        assert not p.grad[..., :skip].any()


def test_scatter_add_rejects_other_devices():
    with pytest.raises(NotImplementedError):
        scatter_add(torch.zeros(1, 4, 2, device="meta"), torch.zeros(1, 4, dtype=torch.int32, device="meta"), 3)


# ------------------------------------------------------------ batch norm

@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (2, 32, 12)])
def test_training_batch_norm_matches_flax(shape):
    """Output, gradients and the updated running statistics against
    ``flax.linen.BatchNorm(use_running_average=False, momentum=0.9)``, with
    random scale, bias and statistics; 2e-6 of scale (f32 reductions in
    another order)."""
    import flax.linen as fnn

    rng = np.random.RandomState(len(shape))
    C = shape[-1]
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32), "bias": rng.randn(C).astype(np.float32)}
    stats = {"mean": rng.randn(C).astype(np.float32), "var": rng.uniform(0.5, 2, C).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)

    def f(p, xx):
        y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y, new_stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(params, x)

    mod = BatchNorm(C)
    with torch.no_grad():
        mod.weight.copy_(t(params["scale"]))
        mod.bias.copy_(t(params["bias"]))
        mod.running_mean.copy_(t(stats["mean"]))
        mod.running_var.copy_(t(stats["var"]))
    mod.train()
    xt = t(x).requires_grad_(True)
    out = mod(xt)
    (out * t(w)).sum().backward()
    close(out, y, 2e-6)
    close(xt.grad, gx, 2e-6)
    close(mod.weight.grad, gp["scale"], 2e-6)
    close(mod.bias.grad, gp["bias"], 2e-6)
    close(mod.running_mean, new_stats["mean"], 2e-6)
    close(mod.running_var, new_stats["var"], 2e-6)


# ------------------------------------------------------------- SA layers

@pytest.mark.parametrize("layer", ["sa2", "proposal"])
def test_train_mode_sa_layer_matches_jax(layer):
    """A train-mode SA layer, gather first, against the JAX module with
    ``train=True``: outputs, updated batch statistics, and the gradients of
    a random projection of the output with respect to the inputs (sa2:
    features only, its coordinates detached; proposal: the votes too) to
    1e-5 of scale (f32 sums in another order, through batch norm's fast
    variance), and with respect to the parameters norm-wise per leaf
    (``check_grads``: dense biases ahead of batch norm hold noise)."""
    from votenet_tpu.models.pointnet2 import PointNetSAModule as JaxSA

    from votenet_tpu_torch.models.pointnet2 import PointNetSAModule

    cfg = tiny_config()
    rng = np.random.RandomState(50)
    points = next(batch_scenes(iter(synthetic_scenes(4, cfg, 2)), 2, cfg.max_gt_boxes))["points"]
    if layer == "sa2":
        xyz = points[:, : cfg.sa_npoints[0]]
        feats = rng.randn(2, xyz.shape[1], cfg.sa_mlps[0][-1]).astype(np.float32)
        kw = dict(npoint=cfg.sa_npoints[1], radius=cfg.sa_radii[1], nsample=cfg.sa_nsamples[1], mlp=cfg.sa_mlps[1])
        coord_grad, sample, mlp2 = False, None, None
    else:
        seeds = points[:, : cfg.sa_npoints[1]]
        xyz = (seeds + rng.normal(0, 0.1, seeds.shape)).astype(np.float32)
        feats = rng.randn(2, xyz.shape[1], cfg.fp_mlps[1][-1]).astype(np.float32)
        mlp2 = tuple(cfg.proposal_mlp2_hidden) + (cfg.num_proposal_channels,)
        kw = dict(npoint=cfg.proposal_num, radius=cfg.proposal_radius, nsample=cfg.proposal_nsample,
                  mlp=cfg.proposal_mlp, mlp2=mlp2)
        coord_grad, sample = True, seeds
    jm = JaxSA(coord_grad=coord_grad, **kw)
    variables = jm.init(jax.random.PRNGKey(7), xyz, feats, False, sample_xyz=sample)
    w = rng.randn(2, kw["npoint"], (mlp2 or kw["mlp"])[-1]).astype(np.float32)

    def f(params, x, p):
        (nx, nf, idx), mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x, p, True,
                                      sample_xyz=sample, mutable=["batch_stats"])
        return jnp.sum(nf * w), (nf, idx, mut["batch_stats"])

    (_, (jf, jidx, jstats)), (gp, gx, gf) = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        variables["params"], xyz, feats)

    pm = PointNetSAModule(kw["npoint"], kw["radius"], kw["nsample"], feats.shape[-1], kw["mlp"],
                          torch.Generator().manual_seed(0), mlp2=mlp2, coord_grad=coord_grad)
    convert_flax_variables(variables, pm)
    pm.train()
    tx, tf = t(xyz).requires_grad_(True), t(feats).requires_grad_(True)
    _, pf, pidx = pm(tx, tf, sample_xyz=None if sample is None else t(sample))
    (pf * t(w)).sum().backward()
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jidx))
    close(pf, jf, 1e-5)
    close(tf.grad, gf, 1e-5)
    close(tx.grad, gx, 1e-5)  # sa2: only the centres' gather reaches xyz
    check_grads(pm, gp)
    for name, buf in pm.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        close(buf, jax_leaf(jstats, "/".join(mod.split(".") + ["mean" if leaf == "running_mean" else "var"])), 1e-5)


# ------------------------------------------------------------------ loss

def loss_inputs(seed):
    """A tiny batch and end points placed so that positives, negatives and
    the in-between band all occur: proposals near, between and far from GT
    centres, votes near the seeds, random head outputs."""
    cfg = tiny_config()
    batch = next(batch_scenes(iter(synthetic_scenes(seed, cfg, 2)), 2, cfg.max_gt_boxes))
    rng = np.random.RandomState(seed)
    B, P = 2, cfg.proposal_num
    seeds = batch["points"][:, :32]
    centres = batch["bboxes_xyz"][np.arange(B)[:, None], rng.randint(0, 3, size=(B, P))]
    offset = rng.randn(B, P, 3) * np.array([0.1, 0.5, 1.5])[rng.randint(0, 3, size=(B, P, 1))]
    end_points = {
        "seeds_xyz": seeds,
        "votes_xyz": (seeds + rng.randn(*seeds.shape) * 0.3).astype(np.float32),
        "proposals_xyz": (centres + offset).astype(np.float32),
        "proposals_output": rng.randn(B, P, cfg.num_proposal_channels).astype(np.float32),
    }
    return cfg, batch, end_points


@pytest.mark.parametrize("pad_semantics", ["reference", "masked"])
@pytest.mark.parametrize("seed", [0, 3])
def test_loss_matches_jax(pad_semantics, seed):
    """Every field of VoteNetLossOutput, and the gradients of the total with
    respect to the differentiable end points, against the JAX loss on the
    same end points; 1e-6 of scale (f32 sums in another order)."""
    from votenet_tpu.models.losses import votenet_loss as jax_loss
    from votenet_tpu.train.loop import GT_KEYS

    cfg, batch, ep = loss_inputs(seed)
    gt = {k: batch[k] for k in GT_KEYS}
    diff = ("votes_xyz", "proposals_xyz", "proposals_output")

    def jf(d):
        out = jax_loss({**ep, **d}, gt, cfg, pad_semantics)
        return out.total, out

    (_, want), jgrads = jax.value_and_grad(jf, has_aux=True)({k: ep[k] for k in diff})
    tep = {k: t(v).requires_grad_(k in diff) for k, v in ep.items()}
    got = votenet_loss(tep, {k: t(v) for k, v in gt.items()}, cfg, pad_semantics)
    assert 0 < int(got.num_positive) and 0 < int(got.num_negative)
    for field in want._fields:
        close(getattr(got, field), getattr(want, field), 1e-6)
    got.total.backward()
    for k in diff:
        close(tep[k].grad, jgrads[k], 1e-6)


# -------------------------------------------------------------- optimizer

def test_lr_schedule_matches_optax_exactly():
    from votenet_tpu.train.optimizer import make_lr_schedule as jax_schedule

    ours = make_lr_schedule(1e-3, ((80, 1e-4), (120, 1e-5)), 512)
    theirs = jax_schedule(1e-3, ((80, 1e-4), (120, 1e-5)), 512)
    for step in (0, 1, 40959, 40960, 40961, 41472, 61439, 61440, 100000):
        assert np.float32(ours(step)) == np.float32(theirs(step)), step
    assert ours(41472) == pytest.approx(1e-4, rel=1e-6)


def test_clip_and_adam_match_optax():
    """Three steps of clip + Adam at the scheduled rate (crossing a
    boundary) against the JAX package's optax chain, on leaves whose
    gradients the clip scales and leaves it does not; 1e-6 relative (Adam's
    arithmetic in another order)."""
    from votenet_tpu.train.optimizer import make_optimizer as jax_optimizer

    cfg = tiny_config(lr_schedule=((1, 1e-4), (2, 1e-5)))
    rng = np.random.RandomState(5)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * sc).astype(np.float32) for (k, s), sc in zip(shapes.items(), (10.0, 1e-3, 0.3))}
             for _ in range(3)]
    tx = jax_optimizer(cfg, steps_per_epoch=1)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    sched = make_lr_schedule(cfg.base_lr, cfg.lr_schedule, 1)
    opt = torch.optim.Adam(tp.values(), lr=cfg.base_lr, betas=(0.9, 0.999), eps=1e-8)
    for step, g in enumerate(grads):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = t(g[k]).clone()
        clip_by_average_norm_(tp.values(), cfg.grad_clip_avg_norm)
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_clip_by_average_norm_semantics():
    g = torch.from_numpy(np.random.RandomState(0).randn(4, 5).astype(np.float32) * 10)
    p = torch.nn.Parameter(torch.zeros(4, 5))
    p.grad = g.clone()
    clip_by_average_norm_([p], 0.5)
    scale = min(1.0, 0.5 * g.numel() / float(torch.linalg.vector_norm(g)))
    torch.testing.assert_close(p.grad, g * scale, rtol=1e-6, atol=0)
    small = torch.nn.Parameter(torch.zeros(10))
    small.grad = torch.full((10,), 1e-4)
    clip_by_average_norm_([small], 0.5)
    assert torch.equal(small.grad, torch.full((10,), 1e-4))


# -------------------------------------------------- one whole training step

def jax_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)


def port_leaf_np(model, name, value):
    """A port parameter (or gradient) in the flax leaf's layout."""
    v = value.detach().cpu().numpy()
    return v.T if flax_param_path(name, model).endswith("kernel") else v


def check_grads(model, jgrads, rel=5e-3):
    """Norm-wise per leaf: ||port - jax|| < rel * max(||jax||, 1e-2 *
    sqrt(size)), the SP gradient test's model. The JAX step's own f32 error is
    the larger: against an f64 run of the port, its tiny-width end points are
    off by ~2e-4 at scale 5-7, the port's f32 ones by ~2e-5 (batch norm's
    fast variance, E[x^2] - E[x]^2, cancels on channels whose mean dwarfs
    their spread), and a near-tied max-pool gradient can take another slot.
    Live leaves measured: <= 4e-4. The floor covers leaves whose gradient is
    mathematically ~0 (a dense bias followed by batch norm, norms ~1e-4):
    there both sides hold noise (measured <= 2.5e-3 of the floor)."""
    bad = []
    for name, p in model.named_parameters():
        a = port_leaf_np(model, name, p.grad).astype(np.float64)
        b = jax_leaf(jgrads, flax_param_path(name, model)).astype(np.float64)
        floor = 1e-2 * np.sqrt(b.size)
        if np.linalg.norm(a - b) >= rel * max(np.linalg.norm(b), floor):
            bad.append((name, float(np.linalg.norm(b)), float(np.linalg.norm(a - b))))
    assert not bad, bad


def check_update(model, old, grads, new_jax_params, jgrads, lr, tight):
    """Updated parameters. Adam divides by sqrt(v): an element whose
    gradient is noise (|g| within 100x of the leaf's port-vs-JAX gradient
    gap) may step either way, by up to lr, so there only the bound 2 lr
    holds; every other element must step as JAX's does, to ``tight * lr``
    plus two ulps of the parameter (the rounding of ``param + update``)."""
    for name, p in model.named_parameters():
        path = flax_param_path(name, model)
        got = port_leaf_np(model, name, p)
        want = jax_leaf(new_jax_params, path)
        g_jax = jax_leaf(jgrads, path)
        gap = float(np.abs(port_leaf_np(model, name, grads[name]) - g_jax).max())
        live = np.abs(g_jax) > 100 * gap + 1e-30
        err = np.abs(got - want)
        ulps = 2 * np.spacing(np.abs(want))
        assert float(np.max(err - ulps)) <= 2 * lr * (1 + 1e-5), name
        if live.any():
            excess = (err - ulps)[live]
            assert float(excess.max()) <= tight * lr, (name, float(excess.max()) / lr, int(live.sum()))


def jax_step_and_grads(cfg, state, batch, pad_semantics):
    from votenet_tpu.models.losses import votenet_loss as jax_loss
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet
    from votenet_tpu.train.loop import GT_KEYS
    from votenet_tpu.train.loop import make_train_step as jax_make_train_step

    model = JaxVoteNet(cfg)

    @jax.jit
    def grads_and_end_points(params, batch_stats, b):
        def loss_fn(p):
            ep, _ = model.apply({"params": p, "batch_stats": batch_stats}, b["points"], train=True,
                                mutable=["batch_stats"])
            return jax_loss(ep, {k: b[k] for k in GT_KEYS}, cfg, pad_semantics).total, ep

        return jax.grad(loss_fn, has_aux=True)(params)

    jgrads, ep = grads_and_end_points(state.params, state.batch_stats, batch)
    new_state, metrics = jax.jit(jax_make_train_step(model, cfg, pad_semantics))(state, batch)
    return jax.tree_util.tree_map(np.asarray, (jgrads, ep, new_state.params, new_state.batch_stats, metrics))


def assignment_masks(ep, batch, cfg):
    """Positive/negative masks and the proposal and vote assignments of a
    set of end points, computed in numpy (f64) from the end points alone."""
    p = np.asarray(ep["proposals_xyz"], np.float64)
    gt = batch["bboxes_xyz"].astype(np.float64)
    d = np.linalg.norm(p[:, :, None] - gt[:, None], axis=-1)
    s = np.asarray(ep["seeds_xyz"], np.float64)
    dv = np.linalg.norm(np.abs(s[:, :, None] - gt[:, None]), axis=-1)
    return {
        "positive": d.min(-1) < cfg.positive_thres,
        "negative": d.min(-1) > cfg.negative_thres,
        "assignment": d.argmin(-1),
        "dual": d.argmin(1),
        "votes": dv.argmin(-1),
    }


@pytest.fixture(scope="module")
def tiny_step():
    from votenet_tpu.train.state import create_train_state as jax_create

    cfg = tiny_config(**STEP_CFG)
    batch = next(batch_scenes(iter(synthetic_scenes(STEP_SEED, cfg, 2)), 2, cfg.max_gt_boxes))
    jstate = jax_create(jax.random.PRNGKey(0), cfg, 10)
    jgrads, jep, jparams, jstats, jmetrics = jax_step_and_grads(cfg, jstate, batch, "reference")

    state = create_train_state(cfg, 10)
    convert_flax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats}, state.model)
    old = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    # the raw gradients and the end points of the step's starting state (the
    # step itself leaves clipped gradients in .grad)
    probe = copy.deepcopy(state.model)
    forward_backward(probe, batch, cfg)
    grads = {k: v.grad.detach().clone() for k, v in probe.named_parameters()}
    probe = copy.deepcopy(state.model).train()
    with torch.no_grad():
        pep = probe(t(batch["points"]))
    metrics = make_train_step(cfg)(state, batch)
    return dict(cfg=cfg, batch=batch, state=state, old=old, grads=grads, pep=pep, metrics=metrics,
                jgrads=jgrads, jep=jep, jparams=jparams, jstats=jstats, jmetrics=jmetrics)


def test_train_step_losses_match_jax(tiny_step):
    """1e-4 of scale: the JAX f32 step's own error (see check_grads; measured
    3.5e-5 on a total of 1.29)."""
    metrics, jmetrics = tiny_step["metrics"], tiny_step["jmetrics"]
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        close(metrics[k], jmetrics[k], 1e-4)


def test_train_step_assignments_equal(tiny_step):
    cfg, batch, pep, jep = tiny_step["cfg"], tiny_step["batch"], tiny_step["pep"], tiny_step["jep"]
    ours = assignment_masks({k: v.numpy() for k, v in pep.items()}, batch, cfg)
    theirs = assignment_masks(jep, batch, cfg)
    assert ours["positive"].sum() > 0 and ours["negative"].sum() > 0
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(pep["seeds_xyz"].numpy(), jep["seeds_xyz"])


def test_train_step_gradients_match_jax(tiny_step):
    state = tiny_step["state"]
    probe = copy.deepcopy(state.model)
    for name, p in probe.named_parameters():
        p.grad = tiny_step["grads"][name]
    check_grads(probe, tiny_step["jgrads"])


def test_train_step_updates_match_jax(tiny_step):
    """Parameters after one Adam step from zero moments (lr 1e-3), and the
    running statistics to 1e-4 of scale (as the losses)."""
    cfg, state = tiny_step["cfg"], tiny_step["state"]
    assert state.step == 1
    check_update(state.model, tiny_step["old"], tiny_step["grads"], tiny_step["jparams"],
                 tiny_step["jgrads"], lr=cfg.base_lr, tight=1e-3)
    for name, buf in state.model.named_buffers():
        mod, leaf = name.rsplit(".", 1)
        want = jax_leaf(tiny_step["jstats"], "/".join(mod.split(".") + ["mean" if leaf == "running_mean" else "var"]))
        close(buf, want, 1e-4)


def test_train_step_summaries_have_the_jax_names(tiny_step):
    from votenet_tpu.train.loop import param_summary_scalars as jax_summaries

    cfg, batch = tiny_step["cfg"], tiny_step["batch"]
    metrics = make_train_step(cfg, with_summaries=True)(copy.deepcopy(tiny_step["state"]), batch)
    want = jax_summaries(tiny_step["jparams"], tiny_step["jgrads"])
    assert {k for k in metrics if "/" in k} == set(want)
    assert float(metrics["g_norm/global"]) > 0


def test_trainer_epoch_on_cpu_launches_no_kernel():
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    cfg = tiny_config()
    batches = list(batch_scenes(iter(synthetic_scenes(2, cfg, 6)), 2, cfg.max_gt_boxes))
    before = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches, scatter_add_cuda.launches)
    state = create_train_state(cfg, len(batches), torch.Generator().manual_seed(1))
    w0 = state.model.sa2.mlp.dense1.weight.detach().clone()
    trainer = Trainer(cfg, state)
    avg = trainer.train_epoch(batches, metrics_every=2)
    assert state.step == 3 and trainer.epoch == 1
    assert set(avg) == {"total_cost", "vote_reg_loss", "obj_cls_loss", "box_loss", "sem_cls_loss",
                        "obj_accuracy", "sem_accuracy"}
    assert all(np.isfinite(v) for v in avg.values())
    assert not torch.equal(w0, state.model.sa2.mlp.dense1.weight)
    after = (farthest_point_sample_cuda.launches, query_ball_point_cuda.launches, scatter_add_cuda.launches)
    assert after == before == (0, 0, 0)


# ------------------------------------------------- carrying the opt state

def test_convert_opt_state_roundtrip():
    """A JAX state after one step carried into the port: moments equal leaf
    by leaf (kernels transposed), step equal to optax's count."""
    from votenet_tpu.train.state import create_train_state as jax_create

    cfg = tiny_config(**STEP_CFG)
    batch = next(batch_scenes(iter(synthetic_scenes(STEP_SEED, cfg, 2)), 2, cfg.max_gt_boxes))
    jstate = jax_create(jax.random.PRNGKey(0), cfg, 10)
    from votenet_tpu.models.votenet import VoteNet as JaxVoteNet
    from votenet_tpu.train.loop import make_train_step as jax_make_train_step

    jstate, _ = jax.jit(jax_make_train_step(JaxVoteNet(cfg), cfg))(jstate, batch)
    from flax.serialization import to_state_dict

    tree = jax.tree_util.tree_map(np.asarray, to_state_dict(jstate))
    state = create_train_state(cfg, 10)
    convert_flax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]}, state.model)
    assert convert_flax_opt_state(tree["opt_state"], state.model, state.optimizer) == 1
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        path = flax_param_path(name, state.model)
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            want = jax_leaf(tree["opt_state"]["1"][slot], path)
            np.testing.assert_array_equal(port_leaf_np(state.model, name, st[key]), want)
        assert float(st["step"]) == 1.0


def test_convert_opt_state_rejects_bad_trees():
    cfg = tiny_config()
    state = create_train_state(cfg, 10)
    zeros = {}
    for name, p in state.model.named_parameters():
        node = zeros
        path = flax_param_path(name, state.model).split("/")
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.zeros(port_leaf_np(state.model, name, p).shape, np.float32)
    good = {"0": {}, "1": {"count": np.int32(5), "mu": zeros, "nu": copy.deepcopy(zeros)}, "2": {"count": np.int32(5)}}
    assert convert_flax_opt_state(good, state.model, state.optimizer) == 5
    bad_count = copy.deepcopy(good)
    bad_count["2"]["count"] = np.int32(6)
    with pytest.raises(ValueError, match="count"):
        convert_flax_opt_state(bad_count, state.model, state.optimizer)
    bad_leaf = copy.deepcopy(good)
    bad_leaf["1"]["mu"]["sa1"]["mlp"]["dense0"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="cannot convert"):
        convert_flax_opt_state(bad_leaf, state.model, state.optimizer)
    missing = copy.deepcopy(good)
    del missing["1"]["nu"]["voting"]
    with pytest.raises(ValueError, match="no mu/nu"):
        convert_flax_opt_state(missing, state.model, state.optimizer)
