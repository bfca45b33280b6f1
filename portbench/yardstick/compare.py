"""The numbers that decide ``correct``: the program's outputs against the
plain reference's, each held to a limit of ``portbench/limits/<cell>.json``.

Detections (eval and serving). Each of the program's detections (class,
eight corners, score) is matched to the reference's proposal of the same
class in the same scene whose corners and score lie nearest (the largest
absolute difference of the 24 coordinates, in metres, and of the score);
that difference is the detection's gap. Two numbers:

- ``det_gap_p90``: the 90th percentile of the gaps over the sample. It
  reads the precision of the whole forward and head; a few proposals whose
  ball query flips on a vote at its radius's edge (votes are computed, so
  rounding moves them) lie above it.
- ``det_off_share``: the share of the reference's kept boxes that the
  program gets wrong: a detection whose gap is above ``tau`` or whose match
  the reference's NMS does not keep, and a kept box of the reference that no
  detection matches within ``tau``, over the reference's kept boxes.

Training (the first three steps from the same weights on the same batches):

- ``loss_gap``: the relative gap of the first step's loss;
- ``loss_gap_all_steps``: the largest relative gap of the three steps'
  losses;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  step's clipped gradient (the program's from Adam's first moment after one
  step), over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``change_gap``: the same of the parameters' change after three steps,
  leaving out the leaves whose reference gradient norm is under a thousandth
  of the median leaf's (a dense bias ahead of batch norm: its gradient is
  rounding, and Adam moves it by rounding alone).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench.reference.head_ref import CLASSES

CLASS_INDEX = {c: i for i, c in enumerate(CLASSES)}
ZERO_GRAD_SHARE = 1e-3

Detection = Tuple[str, np.ndarray, float]


def detection_numbers(program: Sequence[List[Detection]], ref: Dict[str, np.ndarray], tau: float) -> Dict:
    """``program[s]``: scene s's detections; ``ref``: the reference's
    ``bboxes`` (S, P, 8, 3), ``class`` (S, P), ``score`` (S, P), ``keep``
    (S, P) as numpy arrays."""
    gaps: List[float] = []
    off = 0
    kept_total = int(ref["keep"].sum())
    for s, dets in enumerate(program):
        boxes = ref["bboxes"][s].reshape(-1, 24)
        matched = np.zeros(boxes.shape[0], dtype=bool)
        for name, corners, score in dets:
            d = np.maximum(np.abs(boxes - np.asarray(corners, np.float64).reshape(1, 24)).max(axis=1),
                           np.abs(ref["score"][s] - float(score)))
            d = np.where(ref["class"][s] == CLASS_INDEX[name], d, np.inf)
            j = int(np.argmin(d))
            gaps.append(float(d[j]))
            if d[j] <= tau and ref["keep"][s, j]:
                matched[j] = True
            else:
                off += 1
        off += int((ref["keep"][s] & ~matched).sum())
    p90 = float(np.percentile(gaps, 90)) if gaps else 0.0
    return {"det_gap_p90": p90, "det_off_share": off / max(1, kept_total), "det_gap_max": max(gaps, default=0.0),
            "detections": len(gaps), "ref_kept": kept_total}


def reference_detections(ref: Dict[str, np.ndarray]) -> List[List[Detection]]:
    """The reference's kept boxes as detection lists (the control's
    outputs, in the program's format)."""
    out = []
    for s in range(ref["keep"].shape[0]):
        out.append([(CLASSES[int(ref["class"][s, j])], ref["bboxes"][s, j], float(ref["score"][s, j]))
                    for j in np.flatnonzero(ref["keep"][s])])
    return out


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> List[float]:
    med = statistics.median(ref[k] for k in leaves)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def training_numbers(prog: Dict, ref: Dict) -> Dict:
    """``prog``/``ref``: ``losses`` (3 floats), ``grad`` ({leaf: norm of the
    first clipped gradient}), ``change`` ({leaf: norm of the change after
    the steps}). The worst-leaf and later-step numbers are given beside the
    steady ones (the first step's loss, the median leaf)."""
    rel = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    med = statistics.median(ref["grad"].values())
    moving = [k for k, v in ref["grad"].items() if v >= ZERO_GRAD_SHARE * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": rel[0], "loss_gap_all_steps": max(rel), "grad_gap": max(grad),
            "grad_gap_median": statistics.median(grad), "change_gap": max(change),
            "change_gap_median": statistics.median(change), "leaves_left_out": len(ref["grad"]) - len(moving)}


def judge(numbers: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """(every number at or under its limit, {name: {value, limit}}) for the
    numbers the limits file names."""
    checks = {k: {"value": numbers[k], "limit": v["limit"]} for k, v in limits["checks"].items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
