"""Pieces the drivers share: the weights a cell names, the scenes, the
observations the per-layer readers take, the reference's side of the
comparison, and freeing the program before the reference runs."""

from __future__ import annotations

import gc
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import ROOT, Cell
from portbench.reference import head_ref, votenet_ref
from portbench.reference.weights import checkpoint_weights, seeded_weights
from portbench.yardstick.bounds import unit_bounds
from portbench.yardstick.flops import flops_by_dtype
from portbench.yardstick.scenes import substream


def weights(cell: Cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The traffic's ``weights``: ``"seeded"`` (drawn from the run's seed) or
    a checkpoint's path relative to the checkout's root."""
    w = cell.traffic["weights"]
    if w == "seeded":
        return seeded_weights(substream(seed, "weights"), cell.model, device)
    return checkpoint_weights(str(ROOT / w), cell.model, device)


def load_into(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> None:
    """The benchmark's weights into the program's model, every key."""
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)


def observations(cell: Cell, kind: str, batch: int, train: bool) -> dict:
    """The per-layer readers' inputs known before the run: the kind of unit
    (a forward or a step), its scenes, FLOPs a unit by dtype, and the least
    ms a unit of each kernel family."""
    f = flops_by_dtype(cell.model, cell.layer_dtypes, train)
    return {"kind": kind, "unit_scenes": batch, "flops_per_unit": {k: v * batch for k, v in f.items()},
            "bounds_per_unit": unit_bounds(cell.model, cell.layer_dtypes, batch, train)}


def settle() -> None:
    """Before the window: collect set-up's garbage and move what is left out
    of the collector's sight, so that a full collection inside the window
    does not scan the set-up's objects (the interpreter's and torch's
    modules among them)."""
    gc.collect()
    gc.freeze()


def free_memory() -> None:
    """Return the memory of the program's state, which the driver has let
    go of, before the reference runs (the program's peak was read first)."""
    gc.collect()
    torch.cuda.empty_cache()


def reference_detections(params: Dict[str, torch.Tensor], points: torch.Tensor, cell: Cell, block: int,
                         tf32: bool = False) -> Dict[str, np.ndarray]:
    """The reference's every proposal (corners, class, score) and keep mask
    for ``points``, run in blocks of ``block`` scenes."""
    prec = votenet_ref.Precision(cell.layer_dtypes)
    parts: List[Dict[str, torch.Tensor]] = []
    for s in range(0, points.shape[0], block):
        ep = votenet_ref.eval_forward(params, points[s:s + block], cell.model, prec, tf32=tf32)
        parts.append(head_ref.predict(ep, cell.model))
    return {k: torch.cat([p[k] for p in parts]).cpu().numpy() for k in ("bboxes", "class", "score", "keep")}


def sample(seed: int, tag: str, n: int, k: int) -> List[int]:
    """``k`` of ``range(n)``, drawn from the run's seed, in order."""
    rng = np.random.default_rng(substream(seed, tag))
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())
