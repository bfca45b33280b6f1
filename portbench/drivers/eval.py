"""Evaluation passes: ``Evaluator.predictions_for_scenes`` over a
``DeviceSceneCache``, back to back, as ``run_train``'s eval callback runs
them.

Traffic keys: ``batch`` (scenes a forward), ``scenes`` (the cache), ``weights``,
``sample_batches`` (batches of the window's last pass the reference
checks), ``trace_passes`` (passes under the profiler). The unit of the
per-layer numbers is one forward of ``batch`` scenes.
"""

from __future__ import annotations

import time

from portbench.drivers import common
from portbench.harness import Cell, Spans, peak_bytes, program_config, sync, traced
from portbench.yardstick.compare import detection_numbers
from portbench.yardstick.scenes import make_scenes
from portbench.yardstick.stats import rate


def run(cell: Cell, args, t_start: float, device, control=None) -> dict:
    from votenet_tpu_torch.eval.evaluator import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models.votenet import VoteNet

    tr = cell.traffic
    B, S = tr["batch"], tr["scenes"]
    cfg = program_config(cell)
    sd = common.weights(cell, args.seed, device)
    model = VoteNet(cfg).to(device)
    common.load_into(model, sd)
    points = make_scenes(args.seed, S, cell.model, device)["points"]
    host = points.cpu().numpy()
    cache = DeviceSceneCache(((i, host[i]) for i in range(S)), B, device=device)
    predict = make_packed_predict_fn(model, cfg)
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

    ev = Evaluator(cfg, {}, batch_size=B, pipeline_depth=tr["pipeline_depth"])
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
    obs = common.observations(cell, "eval", B, train=False)
    obs.update(host_ms=list(host_ms), units=passes * (S // B), window_s=window_s,
               peak_bytes=peak_bytes(device))
    if args.trace:
        def stretch():
            for _ in range(tr["trace_passes"]):
                with spans("eval_pass"):
                    ev.predictions_for_scenes(timed, cache)

        obs["trace"] = dict(traced(spans, stretch), units=tr["trace_passes"] * (S // B))

    picked = common.sample(args.seed, "eval_sample", S // B, tr["sample_batches"])
    ids = [b * B + i for b in picked for i in range(B)]
    program = [preds[i] for i in ids]
    del model, cache, predict, ev, timed, preds
    common.free_memory()
    ref = common.reference_detections(sd, points[ids], cell, block=B)
    obs.update(e2e={"eval_scenes_per_s": rate(passes * S, window_s), "setup_s": setup_s},
               attempted=passes * S, failed=0, numbers=detection_numbers(program, ref, cell.limits["tau"]))
    return obs
