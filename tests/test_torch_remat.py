"""remat (``Config.remat``) in the port, on the CPU.

The JAX model wraps sa1-sa4 in ``nn.remat`` (``votenet_tpu/models/
votenet.py:114,127``); the port runs them under
``torch.utils.checkpoint`` in training and recomputes each layer's forward
in the backward with batch norm's running-statistics update off. Held here,
on the tiny VoteNet's one training step of ``tests/test_torch_train.py``
(the same batch, weights and tolerances):

- the remat step is bit-equal to the plain step: losses, every raw
  gradient, every running statistic and every updated parameter;
- it matches JAX's ``remat=True`` step within the plain step's tolerances
  (losses and running statistics 1e-4 of scale, gradients 5e-3 norm-wise,
  updates as ``check_update``), so the statistics moved once;
- it saves fewer bytes for the backward (the grouped activations of
  sa1-sa4 are not kept), draws from no generator, and at 2 point-sharded
  ranks gives the plain sharded step's gradients bit for bit.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    STEP_CFG,
    STEP_SEED,
    check_grads,
    check_update,
    close,
    jax_leaf,
    jax_step_and_grads,
    t,
)
from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.dataflow import batch_scenes
from votenet_tpu_torch.data.synthetic import synthetic_scenes
from votenet_tpu_torch.models import VoteNet, convert_flax_variables
from votenet_tpu_torch.parallel.launch import run_ranks
from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step


def stats_path(name):
    mod, leaf = name.rsplit(".", 1)
    return "/".join(mod.split(".") + ["mean" if leaf == "running_mean" else "var"])


@pytest.fixture(scope="module")
def steps():
    """One step of the tiny VoteNet with and without remat from the same
    converted weights, JAX's remat step from the same, and each side's raw
    gradients."""
    from votenet_tpu.train.state import create_train_state as jax_create

    cfg = tiny_config(**STEP_CFG)
    batch = next(batch_scenes(iter(synthetic_scenes(STEP_SEED, cfg, 2)), 2, cfg.max_gt_boxes))
    jstate = jax_create(jax.random.PRNGKey(0), cfg, 10)
    jgrads, _, jparams, jstats, jmetrics = jax_step_and_grads(cfg.replace(remat=True), jstate, batch, "reference")
    out = dict(cfg=cfg, batch=batch, jgrads=jgrads, jparams=jparams, jstats=jstats, jmetrics=jmetrics)
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state = create_train_state(c, 10, device="cpu")
        convert_flax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats}, state.model)
        probe = copy.deepcopy(state.model)
        forward_backward(probe, batch, c)
        out[remat] = dict(
            state=state, old={k: v.detach().clone() for k, v in state.model.named_parameters()},
            grads={k: v.grad.detach().clone() for k, v in probe.named_parameters()},
            metrics=make_train_step(c)(state, batch),
        )
    return out


def test_remat_step_is_bit_equal_to_the_plain_step(steps):
    plain, remat = steps[False], steps[True]
    assert set(plain["metrics"]) == set(remat["metrics"])
    for k in plain["metrics"]:
        assert float(remat["metrics"][k]) == float(plain["metrics"][k]), k
    for k, g in plain["grads"].items():
        assert torch.equal(remat["grads"][k], g), k
    a, b = remat["state"].model, plain["state"].model
    for (name, x), (_, y) in zip(a.named_buffers(), b.named_buffers()):
        assert torch.equal(x, y), name
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name


def test_remat_step_matches_jax_remat(steps):
    cfg, remat = steps["cfg"], steps[True]
    for k in remat["metrics"]:
        close(remat["metrics"][k], steps["jmetrics"][k], 1e-4)
    probe = copy.deepcopy(remat["state"].model)
    for name, p in probe.named_parameters():
        p.grad = remat["grads"][name]
    check_grads(probe, steps["jgrads"])
    check_update(remat["state"].model, remat["old"], remat["grads"], steps["jparams"], steps["jgrads"],
                 lr=cfg.base_lr, tight=1e-3)


def test_running_statistics_moved_once(steps):
    """After one remat step every running statistic equals JAX's remat
    step's (flax's ``nn.remat`` updates them once), and sits where one
    update from the start puts it: a second update, in the recompute,
    would move sa1-sa4's by momentum * (1 - momentum) of the gap again."""
    model = steps[True]["state"].model
    for name, buf in model.named_buffers():
        close(buf, jax_leaf(steps["jstats"], stats_path(name)), 1e-4)
    fresh = VoteNet(steps["cfg"])
    moved = [name for name, buf in model.named_buffers()
             if name.startswith("sa") and not torch.equal(buf, dict(fresh.named_buffers())[name])]
    assert len(moved) > 0


def saved_bytes(model, batch, cfg):
    """Bytes of the tensors autograd keeps for the backward of one
    train-mode forward and loss (storage counted once)."""
    seen = {}

    def pack(x):
        seen[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        forward_backward(model, batch, cfg)
    return sum(seen.values())


def test_remat_keeps_fewer_bytes_and_draws_no_random_numbers(steps):
    """remat is a memory knob: it keeps each SA layer's inputs, not its
    grouped activations (a count of bytes on the CPU, not a device
    measurement). The recompute draws from no generator (FPS and the ball
    query are deterministic): the global generator's state is untouched."""
    cfg, batch = steps["cfg"], steps["batch"]
    plain = VoteNet(cfg).train()
    remat = VoteNet(cfg.replace(remat=True)).train()
    remat.load_state_dict(plain.state_dict())
    rng = torch.get_rng_state()
    kept = saved_bytes(remat, batch, cfg.replace(remat=True))
    assert torch.equal(torch.get_rng_state(), rng)
    assert kept < 0.8 * saved_bytes(plain, batch, cfg)


def sp_remat_rank(rank, world):
    """A rank's raw gradients of the tiny VoteNet's loss with sa1
    point-sharded over 2 ranks, with and without remat, from one seed."""
    from votenet_tpu_torch.parallel import make_mesh

    cfg = tiny_config(**STEP_CFG)
    batch = next(batch_scenes(iter(synthetic_scenes(STEP_SEED, cfg, 2)), 2, cfg.max_gt_boxes))
    mesh = make_mesh(("data", "points"), (1, 2))
    out = {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = VoteNet(c, torch.Generator().manual_seed(3), sp_mesh=mesh, sp_min_points=256).train()
        assert model.sa1.sp and not model.sa2.sp
        local = dict(batch, points=model.local_points(t(batch["points"])))
        losses = forward_backward(model, local, c)
        out[remat] = {"total": float(losses.total), **{k: p.grad.numpy() for k, p in model.named_parameters()},
                      **{k: b.numpy() for k, b in model.named_buffers()}}
    return out


def test_remat_with_point_sharding_matches_the_plain_sharded_step():
    """Every rank recomputes its layers in the same order, so the
    recompute's collectives pair up; each rank's gradients and statistics
    equal its plain step's bit for bit."""
    for r in run_ranks(sp_remat_rank, 2, timeout=300):
        assert r[True].keys() == r[False].keys()
        for k, v in r[False].items():
            np.testing.assert_array_equal(r[True][k], v, err_msg=k)
