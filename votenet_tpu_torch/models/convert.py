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
collection (``opt_state``, ``step``) is ignored by
:func:`convert_flax_variables`; :func:`convert_flax_opt_state` carries
optax's Adam moments into a ``torch.optim.Adam`` by the same leaf map.
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


def flax_param_path(name: str, model: nn.Module) -> str:
    """The flax path of a port parameter: ``sa1.mlp.dense0.weight`` ->
    ``sa1/mlp/dense0/kernel``, ``voting.voting0_bn.weight`` ->
    ``voting/voting0_bn/scale``."""
    mod_name, leaf = name.rsplit(".", 1)
    if leaf == "weight":
        leaf = "kernel" if isinstance(model.get_submodule(mod_name), nn.Linear) else "scale"
    return "/".join(mod_name.split(".") + [leaf])


def convert_flax_opt_state(
    opt_state: Mapping[str, Any], model: nn.Module, optimizer: torch.optim.Optimizer
) -> int:
    """Load the JAX optimizer's state into ``optimizer`` (a
    ``torch.optim.Adam`` over ``model.parameters()`` as
    ``train.optimizer.make_optimizer`` builds it); returns the step count.

    ``opt_state`` is the flax-serialized state of the JAX package's
    ``optax.chain(clip_by_average_norm, scale_by_adam, scale_by_learning_rate)``
    (as in a checkpoint's ``opt_state``): ``"0"`` empty, ``"1"`` ``{count,
    mu, nu}``, ``"2"`` ``{count}``. ``mu`` becomes Adam's ``exp_avg``, ``nu``
    its ``exp_avg_sq`` and ``count`` its ``step``, leaf by leaf as the
    parameters map (kernels transposed). Raises ValueError on a leaf it
    cannot map, on a parameter left without moments, or on an Adam count
    that differs from the schedule's.
    """
    adam = opt_state["1"]
    count = int(np.asarray(adam["count"]))
    sched_count = int(np.asarray(opt_state["2"]["count"]))
    if count != sched_count:
        raise ValueError(f"Adam count {count} != schedule count {sched_count}")
    names = {flax_param_path(n, model): p for n, p in model.named_parameters()}
    moments: Dict[str, Dict[str, torch.Tensor]] = {}
    for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for path, leaf in _flatten(adam[slot]):
            flax_path = "/".join(path)
            if path[-1] not in ("kernel", "bias", "scale") or flax_path not in names:
                raise ValueError(f"cannot convert flax leaf opt_state/1/{slot}/{flax_path}")
            arr = np.asarray(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            p = names[flax_path]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{flax_path}: {slot} shape {tuple(arr.shape)} != parameter shape {tuple(p.shape)}")
            moments.setdefault(flax_path, {})[key] = torch.from_numpy(np.array(arr, order="C")).to(p.device)
    missing = sorted(n for n in names if len(moments.get(n, {})) != 2)
    if missing:
        raise ValueError(f"opt_state has no mu/nu for {missing}")
    for flax_path, m in moments.items():
        optimizer.state[names[flax_path]] = {"step": torch.tensor(float(count), dtype=torch.float32), **m}
    return count
