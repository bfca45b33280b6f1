"""Evaluation passes of Group-Free 3D: ``Evaluator.predictions_for_scenes``
over a ``DeviceSceneCache``, back to back, as ``run_train``'s eval callback
runs them, with ``models.groupfree.GroupFree3D`` in VoteNet's place through
the same ``make_packed_predict_fn``.

Traffic keys: as ``eval.py``'s (``batch``, ``scenes``, ``pipeline_depth``,
``weights``: "seeded" alone, ``sample_batches``, ``trace_passes``), and
``candidate_share`` and ``calibration_scenes`` (:func:`weights`). The
scenes are ``yardstick/scenes.py``'s with a fourth channel, the height above
the floor as Group-Free 3D's SUN RGB-D loader computes it. The unit of the
per-layer numbers is one forward of ``batch`` scenes. The traced stretch
runs twice, first recorded by the program's own span recorder without the
profiler (``recorded_spans``), then under the profiler (``program_spans``:
the device ms each span launched; ``kernel_s``: the attention kernel's
device seconds).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.drivers import common
from portbench.harness import Cell, Spans, peak_bytes, sync
from portbench.reference import groupfree_ref
from portbench.reference.groupfree_weights import calibrate_objectness, seeded_weights
from portbench.yardstick import gf_bounds, gf_flops
from portbench.yardstick.compare import CLASS_INDEX, detection_numbers, judge, reference_detections as as_detections
from portbench.yardstick.scenes import make_scenes, substream
from portbench.yardstick.stats import rate

ATTENTION_KERNEL = "attention_f32_kernel"
FLOOR_PERCENTILE = 0.99  # the loader's np.percentile(point_cloud[:, 2], 0.99): the 0.99th percentile


def program_config(cell: Cell):
    """The program's ``GroupFreeConfig`` holding every value of the
    configuration's file (the backbone's and head's in ``base``, the
    decoder's beside it); raises where the program would run another."""
    from votenet_tpu_torch.models.groupfree import groupfree_config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    gcfg = groupfree_config()
    own = {f.name for f in dataclasses.fields(gcfg)} - {"base"}
    base_keys = {f.name for f in dataclasses.fields(gcfg.base)}
    unknown = set(cell.model) - own - base_keys
    if unknown:
        raise ValueError(f"the program has no setting {sorted(unknown)}")
    gcfg = gcfg.replace(base=gcfg.base.replace(**{k: tup(v) for k, v in cell.model.items() if k in base_keys}),
                        **{k: v for k, v in cell.model.items() if k in own})
    for k, v in cell.model.items():
        got = getattr(gcfg if k in own else gcfg.base, k)
        if got != tup(v):
            raise ValueError(f"the program's {k} is {got!r}, the configuration states {v!r}")
    return gcfg


def scenes(seed: int, count: int, cfg: dict, device) -> torch.Tensor:
    """(count, N, 4) points: ``make_scenes``' coordinates and each point's
    height, its y (the axis the boxes turn about) less the scene's
    ``FLOOR_PERCENTILE``-th percentile of y (linear between ranks, as
    numpy's)."""
    xyz = make_scenes(seed, count, cfg, device)["points"]
    y = torch.sort(xyz[..., 1], dim=1).values
    pos = FLOOR_PERCENTILE / 100.0 * (y.shape[1] - 1)
    lo = int(np.floor(pos))
    frac = pos - lo
    floor = y[:, lo] + (y[:, min(lo + 1, y.shape[1] - 1)] - y[:, lo]) * frac
    return torch.cat([xyz, (xyz[..., 1] - floor[:, None])[..., None]], dim=-1).contiguous()


def weights(cell: Cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights (``reference/groupfree_weights.py``), each head's
    objectness bias then set so that the traffic's ``candidate_share`` of the
    proposals of ``calibration_scenes`` scenes drawn from the seed are NMS
    candidates (the plain reference's forward decides it). With the bias at
    0, the seeded objectness is all or nothing: 0 to 100% of the proposals
    by the seed, so that a forward's detections, and the host's decode of
    them, range from none to 16k."""
    tr = cell.traffic
    if tr["weights"] != "seeded":
        raise ValueError("Group-Free 3D runs on seeded weights: no checkpoint of it is in the repository")
    sd = seeded_weights(substream(seed, "weights"), cell.model, device)
    calibrate_objectness(sd, cell.model, scenes(substream(seed, "calibration"), tr["calibration_scenes"], cell.model,
                                                device), tr["candidate_share"])
    return sd


def observations(cell: Cell, batch: int) -> dict:
    """The per-layer readers' inputs known before the run: a unit is one
    forward of ``batch`` scenes."""
    f = gf_flops.flops_by_dtype(cell.model, cell.layer_dtypes)
    return {"kind": "eval", "unit_scenes": batch, "flops_per_unit": {k: v * batch for k, v in f.items()},
            "bounds_per_unit": gf_bounds.unit_bounds(cell.model, batch),
            "attention_bound_ms": gf_bounds.attention_bound_ms(cell.model, batch)}


def reference_detections(params: Dict[str, torch.Tensor], points: torch.Tensor, cell: Cell, block: int,
                         tf32: bool = False) -> Dict[str, np.ndarray]:
    """The reference's every proposal (corners, class, score) and keep mask
    for ``points``, run in blocks of ``block`` scenes."""
    parts: List[Dict[str, torch.Tensor]] = []
    for s in range(0, points.shape[0], block):
        parts.append(groupfree_ref.predict(params, points[s:s + block], cell.model, tf32=tf32))
    return {k: torch.cat([p[k] for p in parts]).cpu().numpy() for k in ("bboxes", "class", "score", "keep")}


def comparison(program, ref: Dict[str, np.ndarray], tau: float) -> Dict:
    """``detection_numbers`` and ``det_gap_p50``, the median of the same
    gaps (each detection's largest corner or score difference to the
    nearest reference proposal of its class). The median holds the bulk of
    the detections to a tighter gap than tau, which rounding grown through
    six post-norm layers and the flips it brings (a near tie of the top-k,
    an argmax, an NMS candidate: one moves a scene's boxes by centimetres,
    as the reference in float32 against float64 shows) keep wide."""
    gaps = []
    for s, dets in enumerate(program):
        boxes = ref["bboxes"][s].reshape(-1, 24)
        for name, corners, score in dets:
            d = np.maximum(np.abs(boxes - np.asarray(corners, np.float64).reshape(1, 24)).max(axis=1),
                           np.abs(ref["score"][s] - float(score)))
            gaps.append(float(np.where(ref["class"][s] == CLASS_INDEX[name], d, np.inf).min()))
    return dict(detection_numbers(program, ref, tau), det_gap_p50=float(np.percentile(gaps, 50)) if gaps else 0.0)


def traced(spans: Spans, run) -> dict:
    """``harness.traced``'s reduction of a profiled run of ``run()``, after a
    run of it recorded by the program's span recorder alone; adds
    ``recorded_spans``, ``program_spans`` and ``kernel_s``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.yardstick.spans import profiler_launches, program_spans
    from portbench.yardstick.trace import STRETCH, profiler_events, reduce_events
    from votenet_tpu_torch.utils import profiling

    cuda = torch.cuda.is_available()
    sync_all = torch.cuda.synchronize if cuda else (lambda: None)
    sync_all()
    with profiling.record() as rec:
        run()
        sync_all()
    spans.active = True
    try:
        with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
            with torch.profiler.record_function(STRETCH):
                run()
                sync_all()
    finally:
        spans.active = False
    device, host = profiler_events(prof)
    out = reduce_events(device, host)
    window = [(a, b) for n, a, b in host if n == STRETCH]
    t0, t1 = window[0] if window else (0.0, 0.0)
    attention = sum(min(b, t1) - max(a, t0) for n, a, b in device if ATTENTION_KERNEL in n and b > t0 and a < t1)
    out.update(recorded_spans=list(rec.spans), program_spans=program_spans(host, profiler_launches(prof)),
               kernel_s={"attention": attention * 1e-6})
    return out


def run(cell: Cell, args, t_start: float, device, control=None) -> dict:
    from votenet_tpu_torch.eval.evaluator import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models.groupfree import GroupFree3D

    tr = cell.traffic
    B, S = tr["batch"], tr["scenes"]
    gcfg = program_config(cell)
    sd = weights(cell, args.seed, device)
    model = GroupFree3D(gcfg).to(device)
    common.load_into(model, sd)
    points = scenes(args.seed, S, cell.model, device)
    host = points.cpu().numpy()
    cache = DeviceSceneCache(((i, host[i]) for i in range(S)), B, device=device)
    predict = make_packed_predict_fn(model, gcfg.base)
    if control is not None:
        predict = control(predict)
    spans = Spans()
    host_ms = []

    def timed(pts):
        with spans("entry_call"):
            t = time.perf_counter()
            out = predict(pts)
            host_ms.append((time.perf_counter() - t) * 1e3)
        return out

    ev = Evaluator(gcfg.base, {}, batch_size=B, pipeline_depth=tr["pipeline_depth"])
    ev.predictions_for_scenes(timed, cache)  # every shape of the window, and the kernels' first load
    sync(device)
    host_ms.clear()
    setup_s = time.time() - t_start

    common.settle()
    t0 = time.perf_counter()
    passes = 0
    while True:
        preds = ev.predictions_for_scenes(timed, cache)
        passes += 1
        if time.perf_counter() - t0 >= args.seconds:
            break
    window_s = time.perf_counter() - t0
    obs = observations(cell, B)
    obs.update(host_ms=list(host_ms), units=passes * (S // B), window_s=window_s, peak_bytes=peak_bytes(device))
    if args.trace:
        def stretch():
            for _ in range(tr["trace_passes"]):
                with spans("eval_pass"):
                    ev.predictions_for_scenes(timed, cache)

        trace = traced(spans, stretch)
        obs["recorded_spans"] = trace.pop("recorded_spans")
        obs["trace"] = dict(trace, units=tr["trace_passes"] * (S // B))

    picked = common.sample(args.seed, "eval_sample", S // B, tr["sample_batches"])
    ids = [b * B + i for b in picked for i in range(B)]
    program = [preds[i] for i in ids]
    del model, cache, predict, ev, timed, preds
    common.free_memory()
    ref = reference_detections(sd, points[ids], cell, block=B)
    obs.update(e2e={"eval_scenes_per_s": rate(passes * S, window_s), "setup_s": setup_s},
               attempted=passes * S, failed=0, numbers=comparison(program, ref, cell.limits["tau"]))
    return obs


def control_detections(cell: Cell, seed: int, device) -> dict:
    """The control on as many scenes as a run checks: the reference with
    TF32 matmuls (the attention's products too) against the reference in
    float32 (``python3 portbench/control_groupfree.py``)."""
    tr = cell.traffic
    B, n = tr["batch"], tr["scenes"]
    points = scenes(seed, n, cell.model, device)
    ids = list(range(min(tr["sample_batches"] * B, n)))
    sd = weights(cell, seed, device)
    ref = reference_detections(sd, points[ids], cell, block=B)
    low = reference_detections(sd, points[ids], cell, block=B, tf32=True)
    return comparison(as_detections(low), ref, cell.limits["tau"])


def witness_detections(cell: Cell, seed: int, device) -> dict:
    """The witness that sound runs' gaps are float32 rounding: the reference
    in float32 against the reference in float64 (weights and points cast
    whole) on as many scenes as a run checks; and the planted fault of one
    scene's detections moved by 5 cm, each scene in turn, against the
    reference in float32: ``fault_scenes_passed`` of ``fault_scenes``
    pass the limits (``python3 portbench/control_groupfree.py
    --witness-seeds``)."""
    tr = cell.traffic
    B, n = tr["batch"], tr["scenes"]
    points = scenes(seed, n, cell.model, device)[:min(tr["sample_batches"] * B, n)]
    sd = weights(cell, seed, device)
    ref = reference_detections(sd, points, cell, block=B)
    wide = reference_detections({k: v.double() for k, v in sd.items()}, points.double(), cell, block=B)
    mine = as_detections(ref)
    passed = sum(judge(comparison([[(c, np.asarray(x) + 0.05, v) for c, x, v in d] if i == s else d
                                   for i, d in enumerate(mine)], ref, cell.limits["tau"]), cell.limits)[0]
                 for s in range(len(mine)))
    return dict(comparison(mine, wide, cell.limits["tau"]), fault_scenes_passed=passed, fault_scenes=len(mine))
