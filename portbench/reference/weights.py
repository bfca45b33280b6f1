"""The weights both sides get: a trained checkpoint read by the benchmark's
own reader, or weights drawn from the seed on the device.

Names and layouts are the port's ``state_dict`` (``<path>.weight`` (out,
in) for a dense kernel, ``.weight``/``.bias`` for a batch norm's scale and
shift, ``.running_mean``/``.running_var`` for its statistics), which the
reference reads as well (:func:`votenet_ref.param_names`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from portbench.reference.msgpack_reader import read_flax_msgpack
from portbench.reference.votenet_ref import param_names

_LEAVES = {("params", "kernel"): "weight", ("params", "bias"): "bias", ("params", "scale"): "weight",
           ("batch_stats", "mean"): "running_mean", ("batch_stats", "var"): "running_var"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def checkpoint_weights(path: str, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """A flax checkpoint's ``params`` and ``batch_stats`` as the port's
    state_dict on ``device``; raises ValueError where a leaf is missing,
    left over or of another shape than the configuration's model."""
    tree = read_flax_msgpack(path)
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for p, leaf in _flatten(tree[collection]):
            arr = np.asarray(leaf, dtype=np.float32)
            out[".".join(p[:-1] + (_LEAVES[(collection, p[-1])],))] = torch.from_numpy(
                np.array(arr.T if p[-1] == "kernel" else arr, order="C"))
    params, buffers = param_names(cfg)
    want = dict(params + buffers)
    if set(want) != set(out):
        raise ValueError(f"checkpoint leaves differ from the model: missing {sorted(set(want) - set(out))}, "
                         f"left over {sorted(set(out) - set(want))}")
    for k, shape in want.items():
        if tuple(out[k].shape) != tuple(shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(out[k].shape)}, model {shape}")
    return {k: v.to(device) for k, v in out.items()}


def seeded_weights(seed: int, cfg: dict, device) -> Dict[str, torch.Tensor]:
    """He-normal dense kernels (a normal cut at two standard deviations,
    variance 2 / fan_in), zero biases, unit batch-norm scales, running
    statistics 0 and 1: every kernel drawn in one call on ``device`` from a
    generator seeded with ``seed``."""
    params, buffers = param_names(cfg)
    kernels = [(n, s) for n, s in params if n.endswith(".weight") and len(s) == 2]
    total = sum(math.prod(s) for _, s in kernels)
    g = torch.Generator(device=device).manual_seed(seed)
    z = torch.clamp(torch.randn(total, generator=g, device=device), -2.0, 2.0)
    out: Dict[str, torch.Tensor] = {}
    pos = 0
    for n, (cout, cin) in kernels:
        out[n] = (z[pos:pos + cout * cin].view(cout, cin) * (math.sqrt(2.0 / cin) / 0.8796256610342398)).clone()
        pos += cout * cin
    for n, s in params:
        if n not in out:  # biases 0; a batch norm's weight (scale) 1
            out[n] = torch.zeros(s, device=device) if n.endswith(".bias") else torch.ones(s, device=device)
    for n, s in buffers:
        out[n] = torch.zeros(s, device=device) if n.endswith("running_mean") else torch.ones(s, device=device)
    return out
