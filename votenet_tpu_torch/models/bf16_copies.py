"""bf16 copies of the dense layers' f32 weights, one per parameter version.

flax's ``nn.Dense(dtype=bfloat16)`` casts its f32 kernel and bias to bf16
at every call (``promote_dtype``, ``votenet_tpu/models/pointnet2.py:95-99``),
and XLA fuses that convert into the dot on the TPU. Eagerly each cast is a
launch of its own, a forward over, and its gradient's cast back to f32 one
more a leaf. Here a bf16 layer's parameter is cast once while it keeps its
version: :class:`Bf16Copies` holds a bf16 copy of each registered
parameter view (a weight as the layer stores it, (out, in), whose
transpose ``dense_product`` multiplies by; the split first layer's feature
rows ``W[3:]`` of the transposed kernel, contiguous (in - 3, out); a bias
that ``dense`` casts) and refreshes every copy whose parameter's
``_version``, storage or device has changed, all of them in one
``ops.cast_bf16_multi`` launch at the first use after the change. A bf16
serving or eval forward after the first thus makes no weight cast, and a
training step one (the optimizer moves every parameter).

Gradients: under grad mode the copies reach the layers through one
autograd node over all of them (:class:`_Copies`), whose backward, run once
all the copies' bf16 gradients are in, casts them into f32 gradients of the
parameters' shapes in one ``ops.cast_bf16_multi`` launch; autograd then
accumulates those as it accumulated ``ToCopyBackward``'s. bf16 -> f32 is
exact, and a copy used twice in a forward (the centred first layer's ``x @
w`` and ``center @ w[:3]``) has its two bf16 gradients added in bf16 by
autograd before the node, as they were added before ``ToCopyBackward``: the
gradients are the per-leaf casts' bits. The node is kept while no copy is
refreshed, so remat's recompute and a second forward before the optimizer
step reuse it.

The copies are neither parameters nor buffers: ``state_dict``, checkpoints
and the conversion from flax do not see them. A module registers its
layers (:func:`register`) and :func:`attach` gives every registered layer
under a module one shared :class:`Bf16Copies` (``layer._bf16_copies``);
``VoteNet`` attaches last, so a model's copies refresh together.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from votenet_tpu_torch import ops

KINDS = ("weight", "feat", "bias")


def register(layer: nn.Linear, *kinds: str) -> None:
    """Mark ``layer``'s views to be kept in bf16: "weight" (the (out, in)
    weight), "feat" (the feature rows ``W[3:]`` of the transposed kernel,
    the split first layer's), "bias"."""
    unknown = set(kinds) - set(KINDS)
    if unknown:
        raise ValueError(f"bf16 copies: unknown kinds {sorted(unknown)}")
    layer._bf16_kinds = tuple(dict.fromkeys(getattr(layer, "_bf16_kinds", ()) + kinds))


def attach(module: nn.Module) -> Optional["Bf16Copies"]:
    """One :class:`Bf16Copies` for every registered layer under ``module``
    (the layers' earlier groups are dropped); None where there is none."""
    layers = [m for m in module.modules() if isinstance(m, nn.Linear) and getattr(m, "_bf16_kinds", ())]
    if not layers:
        return None
    group = Bf16Copies()
    for layer in layers:
        for kind in layer._bf16_kinds:
            group.add(layer, kind)
        layer._bf16_copies = group
    return group


def bf16_view(layer: nn.Linear, kind: str, dtype: torch.dtype) -> torch.Tensor:
    """``layer``'s view ``kind`` in ``dtype``: the kept bf16 copy where the
    layer has one and ``dtype`` is bf16, else the cast (a no-op in the
    parameter's own dtype). "weight" is (out, in), "feat" (in - 3, out),
    "bias" (out,)."""
    copies = getattr(layer, "_bf16_copies", None)
    if copies is not None and dtype == torch.bfloat16 and kind in layer._bf16_kinds:
        return copies.get(layer, kind)
    return source_view(layer, kind).to(dtype)


def source_view(layer: nn.Linear, kind: str) -> torch.Tensor:
    """The f32 view of the parameter that the copy ``kind`` holds."""
    if kind == "feat":
        return layer.weight.t()[3:]
    return layer.bias if kind == "bias" else layer.weight


class _Entry:
    __slots__ = ("layer", "kind", "pos", "copy", "seen")

    def __init__(self, layer: nn.Linear, kind: str, pos: int):
        self.layer, self.kind, self.pos = layer, kind, pos
        self.copy: Optional[torch.Tensor] = None
        self.seen = None  # (version, data pointer, device) of the parameter when the copy was made

    @property
    def param(self) -> nn.Parameter:
        return self.layer.bias if self.kind == "bias" else self.layer.weight

    def mark(self):
        p = self.param
        return p._version, p.data_ptr(), p.device


class Bf16Copies:
    """The bf16 copies of a model's registered dense-layer views, refreshed
    by version (see the module docstring)."""

    def __init__(self):
        self.entries: dict = {}  # (layer, kind) -> _Entry, in registration order
        self._live: Optional[list] = None  # the autograd node's outputs, in the order of `entries`

    def add(self, layer: nn.Linear, kind: str) -> None:
        self.entries.setdefault((layer, kind), _Entry(layer, kind, len(self.entries)))
        self._live = None

    def __getstate__(self):  # a copy of the model (deepcopy, pickle) makes its copies anew
        return {"entries": {k: _Entry(e.layer, e.kind, e.pos) for k, e in self.entries.items()}, "_live": None}

    def stale(self) -> list:
        return [e for e in self.entries.values() if e.copy is None or e.seen != e.mark()]

    def refresh(self) -> int:
        """Cast every stale copy from its parameter, in one
        ``ops.cast_bf16_multi`` call; returns how many were stale."""
        stale = self.stale()
        if not stale:
            return 0
        pairs = []
        with torch.inference_mode(False), torch.no_grad():
            for e in stale:
                src = source_view(e.layer, e.kind).detach()
                if e.copy is None or e.copy.shape != src.shape or e.copy.device != src.device:
                    e.copy = torch.empty(src.shape, dtype=torch.bfloat16, device=src.device)
                pairs.append((src, e.copy))
            ops.cast_bf16_multi(pairs)
            for e in stale:
                e.seen = e.mark()
                torch.autograd.graph.increment_version(e.copy)  # a graph that saved the old bits now raises
        self._live = None
        return len(stale)

    def get(self, layer: nn.Linear, kind: str) -> torch.Tensor:
        """The bf16 copy of ``layer``'s view ``kind``, refreshed (with every
        other stale copy) if its parameter changed; under grad mode, where
        the parameter takes a gradient, the autograd node's output for
        it."""
        e = self.entries[(layer, kind)]
        if e.copy is None or e.seen != e.mark():
            self.refresh()
        if not (torch.is_grad_enabled() and e.param.requires_grad):
            return e.copy
        if self._live is None:
            entries = list(self.entries.values())
            self._live = list(_Copies.apply(entries, *dict.fromkeys(x.param for x in entries)))
        return self._live[e.pos]


def _grad_views(e: _Entry, grad: torch.Tensor, out: torch.Tensor) -> list:
    """The cast pairs that write the entry's bf16 gradient into the f32
    gradient ``out`` of its parameter (a "feat" copy's: the coordinate
    columns 0, W[3:]'s transposed)."""
    if e.kind == "feat":
        return [(None, out[:, :3]), (grad, out.t()[3:])]
    return [(grad, out)]


class _Copies(torch.autograd.Function):
    """The copies as outputs of one node of the parameters (the copies'
    aliases; the parameters in the order of their first entry)."""

    @staticmethod
    def forward(ctx, entries, *params):
        ctx.entries = entries
        ctx.index = {id(p): i for i, p in enumerate(params)}
        ctx.set_materialize_grads(False)
        return tuple(e.copy.detach() for e in entries)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        out: list = [None] * len(ctx.index)
        pairs, extra = [], []
        for e, g in zip(ctx.entries, grads):
            i = ctx.index[id(e.param)]
            if g is None or not ctx.needs_input_grad[1 + i]:
                continue
            if out[i] is not None:  # a second copy of one parameter in the graph (no path of the model)
                extra.append((i, e, g))
                continue
            out[i] = torch.empty(e.param.shape, dtype=torch.float32, device=g.device)
            pairs += _grad_views(e, g, out[i])
        if pairs:
            ops.cast_bf16_multi(pairs)  # every copy's gradient in one launch
        for i, e, g in extra:
            t = torch.empty_like(out[i])
            ops.cast_bf16_multi(_grad_views(e, g, t))
            out[i] = out[i] + t
        return (None, *out)
