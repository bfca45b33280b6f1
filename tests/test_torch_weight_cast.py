"""The bf16 weight copies (``models/bf16_copies.py``) and the cast op they
use (``ops.cast_bf16_multi``: ``csrc/cast.cu`` on the card, its plain
version here), on the CPU at tiny widths.

What is held, and to what:

- The plain cast against ``.to()`` bit for bit, f32 -> bf16 on ties (both
  ways to even), f32 and bf16 subnormals, the overflow to inf, +-inf, +-0
  and NaNs, and bf16 -> f32 into strided (transposed) destinations and zero
  fills; the table's checks. The card's kernel is held to the card's own
  cast in ``tests/test_torch_cuda.py``.
- The copies' versions: a copy is the cast of its parameter after the
  optimizer's step, ``load_state_dict``, a move of the parameters'
  storage (``.to()``) and an in-place edit under ``no_grad``, and is not
  cast again while nothing changed (a serving forward after the first makes
  no cast; a training step two: the refresh and the gradients' return).
- What the copies must not change, bit for bit: the forward, every
  gradient (a doubly used weight's included: the centred first layer's ``x
  @ w`` and ``center @ w[:3]``), running statistic and Adam moment of bf16
  training steps, under remat and over ``Trainer(steps_per_dispatch=4)``,
  against the same model casting at every call; ``state_dict``'s keys and a
  saved checkpoint's bytes.
"""

import numpy as np
import pytest
import torch

from votenet_tpu_torch import ops
from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch.data.dataflow import batch_scenes
from votenet_tpu_torch.data.synthetic import synthetic_scenes
from votenet_tpu_torch.models import VoteNet
from votenet_tpu_torch.models import bf16_copies
from votenet_tpu_torch.models.pointnet2 import MLPStack
from votenet_tpu_torch.ops.cuda import cast as cast_mod

BF16 = torch.bfloat16


def bits(t):
    return t.detach().view(torch.int16 if t.dtype == BF16 else torch.int32)


def special_values():
    """f32 values at bf16's rounding edges (see the module docstring)."""
    vals = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 1.0 + 2.0 ** -8 + 2.0 ** -20,
                         2.0 ** -130, -(2.0 ** -140), 2.0 ** -149, 1e-40, 2.0 ** -126, 3.3895314e38, 3.4028235e38,
                         float("inf"), float("-inf"), 0.0, -0.0, 65504.0, 1.00390625, 1.01171875, float("nan")])
    return vals


def without_copies(model):
    """The model's bf16 layers casting at every call, as before the copies."""
    for m in model.modules():
        if hasattr(m, "_bf16_copies"):
            m._bf16_copies = None
    return model


@pytest.fixture
def cast_calls(monkeypatch):
    """Counts the calls of ``ops.cast_bf16_multi`` (one launch each on the
    card)."""
    calls = []
    real = ops.cast_bf16_multi

    def counted(pairs):
        calls.append(len(pairs))
        return real(pairs)

    monkeypatch.setattr(ops, "cast_bf16_multi", counted)
    return calls


# ------------------------------------------------------------ the cast op

def test_plain_cast_is_torch_to_on_special_values():
    """f32 -> bf16 as ``.to(torch.bfloat16)`` on every special value and on
    random values of every binade; the results round to nearest even (a tie
    goes to the even neighbour) and keep the sign of zeros and infinities."""
    rng = np.random.RandomState(0)
    rand = torch.from_numpy((rng.randn(4, 33) * 10.0 ** rng.randint(-40, 38, (4, 33))).astype(np.float32))
    srcs = [special_values(), rand, rand.t()]  # a transposed (strided) source too
    dsts = [torch.empty(s.shape, dtype=BF16) for s in srcs]
    cast_mod.cast_bf16_multi_plain(list(zip(srcs, dsts)))
    for s, d in zip(srcs, dsts):
        assert torch.equal(bits(d), bits(s.to(BF16)))
    got = dsts[0].float()
    assert got[0] == 1.0 and got[1] == 1.0 + 2.0 ** -6 and got[2] == -1.0  # ties to even
    assert got[3] == 1.0 + 2.0 ** -7  # above the tie: up
    assert torch.isinf(got[10]) and torch.isinf(got[11]) and got[12] == -float("inf")
    assert bits(dsts[0])[14] == bits(torch.tensor(-0.0, dtype=BF16)) and torch.isnan(got[-1])


def test_plain_cast_back_into_strided_destinations_and_zero_fills():
    """bf16 -> f32 is exact (``.float()``), written through a transposed
    destination's strides; a pair without a source writes zeros."""
    src = torch.from_numpy(np.random.RandomState(1).randn(5, 7).astype(np.float32)).to(BF16)
    out = torch.full((7, 5), 9.0).t()  # (5, 7) with strides (1, 5)
    zero = torch.full((6, 4), 3.0)[:, 1:3]
    ops.cast_bf16_multi([(src, out), (None, zero)])
    assert torch.equal(bits(out), bits(src.float())) and torch.equal(zero, torch.zeros(6, 2))


def test_cast_table_is_checked():
    """One direction a call, matching shapes, f32 and bf16 only."""
    a, b = torch.zeros(3, 4), torch.zeros(3, 4, dtype=BF16)
    with pytest.raises(ValueError):
        ops.cast_bf16_multi([(a, b), (b, a)])  # two directions
    with pytest.raises(ValueError):
        ops.cast_bf16_multi([(a, torch.zeros(4, 3, dtype=BF16))])
    with pytest.raises(ValueError):
        ops.cast_bf16_multi([(a.double(), b)])


def test_cast_kernel_wrapper_raises_without_a_card(monkeypatch):
    """Given CPU tensors the kernel's wrapper raises: it neither computes the
    plain version nor builds the library."""

    def no_build():
        raise AssertionError("the wrapper tried to build or load the kernels")

    monkeypatch.setattr(cast_mod, "library", no_build)
    before = cast_mod.cast_bf16_multi_cuda.launches
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        cast_mod.cast_bf16_multi_cuda([(torch.zeros(2, 3), torch.zeros(2, 3, dtype=BF16))])
    assert cast_mod.cast_bf16_multi_cuda.launches == before


def test_cast_entry_layout_is_the_kernels():
    """The ctypes record is csrc/cast.cu's CastEntry: two pointers and six
    32-bit ints, 40 bytes; a table of CAST_MAX_ENTRIES fits the 4 KB a
    kernel parameter may take."""
    import ctypes
    import re
    from pathlib import Path

    assert ctypes.sizeof(cast_mod.CastEntry) == 40
    src = (Path(cast_mod.__file__).resolve().parents[2] / "csrc" / "cast.cu").read_text()
    assert int(re.search(r"constexpr int kMaxEntries = (\d+);", src).group(1)) == cast_mod.CAST_MAX_ENTRIES
    assert cast_mod.CAST_MAX_ENTRIES * ctypes.sizeof(cast_mod.CastEntry) <= 4096


# --------------------------------------------------------- the copies' versions

def tiny_bf16(**kw):
    cfg = tiny_config(compute_dtype="bfloat16", **kw)
    batch = next(batch_scenes(iter(synthetic_scenes(2, cfg, 2)), 2, cfg.max_gt_boxes))
    return cfg, batch


def copies_are_casts(model):
    for e in model.bf16_copies.entries.values():
        want = bf16_copies.source_view(e.layer, e.kind).detach().to(BF16)
        assert e.copy is not None and torch.equal(bits(e.copy), bits(want.contiguous())), (e.kind, e.layer)


def test_copies_follow_the_parameters(cast_calls):
    """Every copy is its parameter's cast after each kind of change, each
    refresh one cast call for every stale copy, and a forward with nothing
    changed makes none."""
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg, batch = tiny_bf16()
    state = create_train_state(cfg, 10, device="cpu")
    model = state.model
    pts = torch.as_tensor(batch["points"])
    with torch.no_grad():
        model.eval()(pts)
    assert len(cast_calls) == 1 and cast_calls[0] == len(model.bf16_copies.entries)
    copies_are_casts(model)
    with torch.no_grad():
        model(pts)
    assert len(cast_calls) == 1  # nothing changed: no cast
    make_train_step(cfg)(state, batch)  # the optimizer's step moves every parameter
    with torch.no_grad():
        model.eval()(pts)
    copies_are_casts(model)
    n = len(cast_calls)
    other = VoteNet(cfg, torch.Generator().manual_seed(5))
    model.load_state_dict(other.state_dict())
    with torch.no_grad():
        model(pts)
    copies_are_casts(model)
    assert len(cast_calls) == n + 1
    model.to(torch.float64).to(torch.float32)  # new storage for every parameter
    with torch.no_grad():
        model(pts)
    copies_are_casts(model)
    with torch.no_grad():  # one parameter edited in place: one copy stale, one cast of it
        model.sa2.mlp.dense1.weight.mul_(1.5)
        model(pts)
    assert cast_calls[-1] == 1
    copies_are_casts(model)


def test_training_step_casts_twice(cast_calls):
    """A bf16 training step: one refresh at its forward's first use (after
    the previous step's update) and one cast of every copy's gradient."""
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg, batch = tiny_bf16()
    state = create_train_state(cfg, 10, device="cpu")
    step = make_train_step(cfg)
    step(state, batch)
    before = len(cast_calls)
    step(state, batch)
    assert len(cast_calls) - before == 2


def test_state_dict_and_checkpoint_do_not_see_the_copies(tmp_path):
    """The copies are neither parameters nor buffers: a bf16 model's
    state_dict has the f32 model's keys and tensors, and a checkpoint saved
    after a step with the copies is the bytes of one saved after the same
    step without them."""
    from votenet_tpu_torch.train import create_train_state, make_train_step
    from votenet_tpu_torch.utils.checkpoint import checkpoint_path, save_checkpoint

    cfg, batch = tiny_bf16()
    f32 = VoteNet(tiny_config(), torch.Generator().manual_seed(3)).state_dict()
    bf = VoteNet(cfg, torch.Generator().manual_seed(3)).state_dict()
    assert list(bf) == list(f32) and all(torch.equal(bf[k], f32[k]) for k in f32)
    files = []
    for copies in (True, False):
        state = create_train_state(cfg, 10, torch.Generator().manual_seed(3), device="cpu")
        if not copies:
            without_copies(state.model)
        make_train_step(cfg)(state, batch)
        d = tmp_path / str(copies)
        save_checkpoint(str(d), state, 1)
        files.append(open(checkpoint_path(str(d), 1), "rb").read())
    assert files[0] == files[1]


def state_bits(state):
    model = state.model
    out = [p.detach().clone() for p in model.parameters()] + [b.clone() for b in model.buffers()]
    for p in model.parameters():
        out += [v.clone() for v in state.optimizer.state[p].values() if torch.is_tensor(v)]
    return out


@pytest.mark.parametrize("what", ["step", "remat", "dispatch-4"])
def test_bf16_training_is_bit_equal_with_and_without_the_copies(what):
    """Two bf16 training steps (remat: the backbone recomputed in the
    backward; dispatch-4: four steps of ``Trainer(steps_per_dispatch=4)``)
    with the copies and casting at every call: the losses, every gradient,
    parameter, running statistic and Adam moment equal bit for bit."""
    from votenet_tpu_torch.train import Trainer, create_train_state, forward_backward, make_train_step

    cfg, batch = tiny_bf16(**({"remat": True} if what == "remat" else {}))
    runs = []
    for copies in (True, False):
        state = create_train_state(cfg, 10, torch.Generator().manual_seed(4), device="cpu")
        if not copies:
            without_copies(state.model)
        if what == "dispatch-4":
            Trainer(cfg, state, steps_per_dispatch=4).train_epoch([batch] * 4, metrics_every=4)
            runs.append(state_bits(state))
            continue
        step = make_train_step(cfg)
        step(state, batch)
        losses = forward_backward(state.model, batch, cfg)
        runs.append(list(losses) + [p.grad.clone() for p in state.model.parameters()] + state_bits(state))
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(bits(a) if a.is_floating_point() else a,
                                                  bits(b) if b.is_floating_point() else b)


@pytest.mark.parametrize("use_idx", [False, True], ids=["grouped", "project-first"])
def test_doubly_used_weight_gradient_is_autograds(use_idx, cast_calls):
    """The centred first layer uses its bf16 weight twice (``x @ w`` and
    ``center @ w[:3]``): with the copy, the two bf16 cotangents are added in
    bf16 before the one cast back, as autograd added them before
    ``ToCopyBackward``: every gradient bit-equal to the layers written out
    with ``layer.weight.t().to(bf16)``; and the backward's casts are one
    call."""
    from tests.test_torch_bn_layer import F64Prologue

    rng = np.random.RandomState(6)
    B, N, M, S, cin = 2, 20, 5, 8, 6
    stack = MLPStack(cin, (8, 12), torch.Generator().manual_seed(1), dtype=BF16).train()
    pts = torch.from_numpy(rng.randn(B, N, cin).astype(np.float32))
    center = torch.from_numpy(rng.randn(B, M, 3).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, N, (B, M, S)).astype(np.int32))
    gp = torch.from_numpy(rng.randn(B, M, 12).astype(np.float32)).to(BF16)
    outs = []
    for copies in (True, False):
        stack.zero_grad()
        x = pts.clone().requires_grad_(True)
        if copies:
            y = stack(x, center=center, idx=idx, pool="max") if use_idx else \
                stack(ops.group_point(x, idx), center=center, pool="max")
        else:
            w = stack.dense0.weight.t().to(BF16)
            hh = ops.group_point(x.to(BF16) @ w, idx) if use_idx else ops.group_point(x, idx).to(BF16) @ w
            h1 = stack.bn0(F64Prologue.apply(hh, center.to(BF16) @ w[:3], stack.dense0.bias), relu=True)
            h2 = F64Prologue.apply(h1 @ stack.dense1.weight.t().to(BF16), None, stack.dense1.bias)
            y = torch.amax(stack.bn1(h2, relu=True), dim=2)
        n = len(cast_calls)
        y.backward(gp)
        if copies:
            assert len(cast_calls) - n == 1  # every copy's gradient in one cast
        outs.append([y] + [p.grad.clone() for p in stack.parameters()] + [x.grad])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_a_copy_of_the_model_makes_its_own_copies():
    """deepcopy (and pickle) of a model whose copies are in a live autograd
    graph: the new model's copies are made anew from its own parameters."""
    import copy

    cfg, batch = tiny_bf16()
    model = VoteNet(cfg).train()
    model(torch.as_tensor(batch["points"]))  # a graph holds the copies' node
    twin = copy.deepcopy(model)
    assert twin.bf16_copies is not model.bf16_copies
    assert all(e.copy is None for e in twin.bf16_copies.entries.values())
    assert all(e.layer._bf16_copies is twin.bf16_copies for e in twin.bf16_copies.entries.values())
    with torch.no_grad():
        twin.eval()(torch.as_tensor(batch["points"]))
    copies_are_casts(twin)
