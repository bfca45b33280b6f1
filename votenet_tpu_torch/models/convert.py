"""Convert the JAX package's flax variables into a state_dict of the port.

The flax tree ``{"params": ..., "batch_stats": ...}`` (nested dicts of numpy
arrays, e.g. from ``flax.serialization.msgpack_restore`` of a checkpoint)
maps leaf by leaf:

========================================  ====================================
flax path                                 port state_dict key
========================================  ====================================
``params/<path>/kernel`` (in, out)        ``<path>.weight`` (out, in), transposed
``params/<path>/bias``                    ``<path>.bias``
``params/<path>/scale`` (batch norm)      ``<path>.weight``
``batch_stats/<path>/mean``               ``<path>.running_mean``
``batch_stats/<path>/var``                ``<path>.running_var``
========================================  ====================================

with ``/`` becoming ``.`` in ``<path>`` (``sa1/mlp/dense0``,
``voting/voting0_bn``, ``proposal/mlp2/dense2``, ...). Any other top-level
collection (``opt_state``, ``step``) is ignored.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def convert_flax_variables(
    variables: Mapping[str, Any], model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` -> port state_dict (f32 CPU tensors).

    Raises ValueError on a leaf it cannot map. With ``model``, also raises if
    the result leaves any of the model's parameters or buffers unset or has a
    key or shape the model does not, then loads it with ``strict=True``.
    """
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            name = _LEAVES.get((collection, path[-1]))
            if name is None:
                raise ValueError(f"cannot convert flax leaf {collection}/{'/'.join(path)}")
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                arr = arr.T
            key = ".".join(path[:-1] + (name,))
            if key in state:
                raise ValueError(f"two flax leaves map to {key}")
            state[key] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    if model is not None:
        want = model.state_dict()
        missing = sorted(set(want) - set(state))
        extra = sorted(set(state) - set(want))
        if missing or extra:
            raise ValueError(f"flax tree does not match the model: missing {missing}, left over {extra}")
        for k, v in state.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: flax shape {tuple(v.shape)} != model shape {tuple(want[k].shape)}")
        model.load_state_dict(state, strict=True)
    return state
