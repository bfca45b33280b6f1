#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each checked; any failure exits non-zero without the final line:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
   No CUDA device is a failure.
2. Build the kernels of ``votenet_tpu_torch/csrc`` and time the build.
3. Each kernel against its plain PyTorch version on the card, at the five
   shapes of a full-width forward (sa1-sa4 and the proposal layer), at B=1
   and B=8, plus the ball query's r^2 boundary case. Integer outputs must be
   equal; CUDA-event times of both are printed.
4. Serve: a full-width ``VoteNetPredictor`` with seeded random weights
   (the objectness bias shifted so that about half the proposals reach NMS)
   answers 3 batch requests at B=8 and 3 ``detect()`` calls at B=1 on
   synthetic scenes. Outputs must be finite and of the expected shapes, and
   each forward must launch each kernel exactly 5 times.
5. One B=1 scene through the GPU and the port's CPU path with the same
   weights: seeds_xyz equal, votes and proposals_output within tolerance,
   and the CPU NMS of the GPU's boxes equal to the GPU's keep mask.

Output: a JSON line of the kernels, the ``nvidia-smi`` line of the card, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

import numpy as np

SEED = 0
# Float tolerance, GPU against CPU: matmuls in another summation order
# (cuBLAS against the CPU BLAS, both f32) drift by ~1e-6 of a tensor's
# scale per layer over ~15 layers; allowed: 1e-4 of the reference's scale.
REL_TOL = 1e-4


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` between CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scale_err(got, want) -> tuple[float, float]:
    """(max abs difference, tolerance REL_TOL * max(1, max |want|))."""
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    return float((got - want).abs().max()), REL_TOL * max(1.0, float(want.abs().max()))


def layer_inputs(points, cfg):
    """The clouds each FPS and ball query of a forward sees, at its shapes.

    Backbone clouds come from chained FPS (the real sa1-sa4 centres); the
    votes are the seeds moved by seeded normal noise (sigma 0.1 m), since
    the real ones depend on the weights.
    """
    import torch

    from votenet_tpu_torch import ops

    clouds = [points]
    for npoint in cfg.sa_npoints:
        fps_idx = ops.farthest_point_sample(npoint, clouds[-1])
        clouds.append(ops.gather_point(clouds[-1], fps_idx))
    seeds = clouds[2]
    g = torch.Generator(device=points.device).manual_seed(SEED)
    votes = seeds + 0.1 * torch.randn(seeds.shape, generator=g, device=points.device)
    fps_cases = [(f"sa{i + 1}", cfg.sa_npoints[i], clouds[i]) for i in range(4)]
    fps_cases.append(("proposal", cfg.proposal_num, seeds))
    prop_q = ops.gather_point(votes, ops.farthest_point_sample(cfg.proposal_num, seeds))
    bq_cases = [
        (f"sa{i + 1}", cfg.sa_radii[i], cfg.sa_nsamples[i], clouds[i], clouds[i + 1])
        for i in range(4)
    ]
    bq_cases.append(("proposal", cfg.proposal_radius, cfg.proposal_nsample, votes, prop_q))
    return fps_cases, bq_cases


def phase_kernels(cfg, scenes, report):
    """Kernel against plain at every main-path shape, B=1 and B=8."""
    import torch

    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    print("phase 3: kernel vs plain on the card (CUDA events, warm L2)")
    print(f"  {'kernel':<10} {'layer':<9} {'B':>2} {'shape':<26} {'equal':<6} {'kernel_us':>10} {'plain_us':>11}")
    for B in (1, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        fps_cases, bq_cases = layer_inputs(points, cfg)
        for layer, npoint, xyz in fps_cases:
            got = farthest_point_sample_cuda(npoint, xyz)
            want = farthest_point_sample_plain(npoint, xyz)
            equal = torch.equal(got, want)
            err = int((got - want).abs().max())
            k_ms = cuda_ms(lambda: farthest_point_sample_cuda(npoint, xyz), 10)
            p_ms = cuda_ms(lambda: farthest_point_sample_plain(npoint, xyz), 1)
            report("fps", layer, B, f"{xyz.shape[1]}->{npoint}", equal, err, k_ms, p_ms)
        for layer, radius, nsample, xyz, q in bq_cases:
            got = query_ball_point_cuda(radius, nsample, xyz, q)
            want = query_ball_point_plain(radius, nsample, xyz, q)
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            k_ms = cuda_ms(lambda: query_ball_point_cuda(radius, nsample, xyz, q), 20)
            p_ms = cuda_ms(lambda: query_ball_point_plain(radius, nsample, xyz, q), 2)
            err = max(int((got[i] - want[i]).abs().max()) for i in range(2))
            report("ballquery", layer, B, f"N={xyz.shape[1]} M={q.shape[1]} r={radius}", equal, err, k_ms, p_ms)

    # r^2 boundary: d2 = 0.039999996 < float32(0.2)*float32(0.2) = 0.040000003
    p = torch.tensor([[[0.19999999, 5e-05, 0.0], [1.0, 1.0, 1.0]]], device="cuda")
    q = torch.zeros((1, 1, 3), device="cuda")
    got = query_ball_point_cuda(0.2, 4, p, q)
    want = query_ball_point_plain(0.2, 4, p, q)
    ok = int(got[1][0, 0]) == 1 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"  r^2 boundary point (0.19999999, 5e-05, 0), r=0.2: kernel cnt={int(got[1][0, 0])} "
          f"plain cnt={int(want[1][0, 0])} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ball query r^2 boundary case")


def calibrate_head(predictor, scenes):
    """Shift the random head's objectness bias so that about half of the
    proposals pass the NMS gate: with raw random weights the gate may pass
    none, and the NMS and detection checks would test nothing."""
    import torch

    batch = torch.from_numpy(np.stack([s["points"] for s in scenes[:8]])).cuda()
    with torch.inference_mode():
        obj = predictor.model(batch)["obj_scores"]
        margin = float((obj[..., 1] - obj[..., 0]).median())
    with torch.no_grad():
        predictor.model.proposal.mlp2.dense2.bias[1] -= margin


def phase_serve(cfg, scenes, predictor):
    """3 batch requests at B=8 and 3 detect() calls at B=1, counting launches."""
    import torch

    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda

    batch = np.stack([s["points"] for s in scenes[:8]])
    P, NC = cfg.proposal_num, cfg.num_class
    predictor(batch)  # warm-up: cuBLAS handles, allocator
    predictor.detect(scenes[0]["points"])
    torch.cuda.synchronize()

    def counts():
        return farthest_point_sample_cuda.launches, query_ball_point_cuda.launches

    def check_five(before):
        after = counts()
        if (after[0] - before[0], after[1] - before[1]) != (5, 5):
            raise AssertionError(f"a forward launched (fps, ballquery) {after[0] - before[0]}, "
                                 f"{after[1] - before[1]} times, not 5 each")

    farthest_point_sample_cuda.launches = 0
    query_ball_point_cuda.launches = 0
    batch_s, single_s = [], []
    for _ in range(3):
        before = counts()
        t0 = time.perf_counter()
        out = {k: v.cpu() for k, v in predictor(batch).items()}
        batch_s.append(time.perf_counter() - t0)
        check_five(before)
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"bboxes": (8, P, 8, 3), "class_scores": (8, P, NC), "keep": (8, P), "objectness": (8, P, 2)}
        if shapes != want:
            raise AssertionError(f"output shapes {shapes} != {want}")
        for k in ("bboxes", "class_scores", "objectness"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k}")
    n_kept = []
    for i in range(3):
        before = counts()
        t0 = time.perf_counter()
        dets = predictor.detect(scenes[i]["points"])
        single_s.append(time.perf_counter() - t0)
        check_five(before)
        n_kept.append(len(dets))
        for name, corners, score in dets:
            if corners.shape != (8, 3) or not np.isfinite(corners).all() or not np.isfinite(score):
                raise AssertionError(f"bad detection {name} {corners.shape} {score}")
    launches = dict(zip(("fps", "ballquery"), counts()))
    print(f"phase 4: served 3 x B=8 and 3 x B=1: launches {launches} over 6 forwards, 5 + 5 each")
    print(f"  B=8 request seconds {batch_s}; scenes/s {[8 / s for s in batch_s]}")
    print(f"  B=1 detect() seconds {single_s}; detections {n_kept}")
    return launches


def phase_cpu_parity(cfg, scenes, predictor):
    """One B=1 scene on the GPU and on the port's CPU path, same weights."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.models import VoteNet, predict_boxes

    cpu_model = VoteNet(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in predictor.model.state_dict().items()})
    pts = torch.from_numpy(scenes[0]["points"][None])
    with torch.inference_mode():
        ge = predictor.model(pts.cuda())
        gp = predict_boxes(ge, cfg)
        ce = cpu_model(pts)
        ge = {k: v.cpu() for k, v in ge.items()}
        # the proposal layer on the GPU's own votes: a vote a few ulps off
        # can move a point across the r=0.3 ball boundary between devices
        _, prop_same_votes, _ = cpu_model.proposal(
            ge["votes_xyz"], ge["votes_points"], sample_xyz=ge["seeds_xyz"]
        )
        keep_cpu = ops.nms3d(
            gp["bboxes"].cpu(), gp["nms_scores"].cpu(), gp["objectness"].cpu(), cfg.nms_iou
        )
        fi = ops.farthest_point_sample(cfg.proposal_num, ce["seeds_xyz"])
        idx_g, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ge["votes_xyz"], ops.gather_point(ge["votes_xyz"], fi))
        idx_c, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ce["votes_xyz"], ops.gather_point(ce["votes_xyz"], fi))
    flips = int((idx_g != idx_c).sum())
    checks = {"seeds_xyz equal": torch.equal(ge["seeds_xyz"], ce["seeds_xyz"])}
    for k in ("seeds_points", "votes_xyz", "votes_points"):
        err, tol = scale_err(ge[k], ce[k])
        checks[f"{k} err {err:.3g} <= {tol:.3g}"] = err <= tol
    err, tol = scale_err(ge["proposals_output"], prop_same_votes)
    checks[f"proposals_output (same votes) err {err:.3g} <= {tol:.3g}"] = err <= tol
    err, tol = scale_err(ge["proposals_output"], ce["proposals_output"])
    # end to end only where no vote crossed a ball boundary between devices
    checks[f"proposals_output (end to end, {flips} proposal slot flips) err {err:.3g} <= {tol:.3g}"] = (
        flips > 0 or err <= tol
    )
    n_cand = int((ge["obj_scores"][..., 1] > ge["obj_scores"][..., 0]).sum())
    n_kept = int(gp["keep"].sum())
    checks[f"NMS has work: {n_cand} candidates, {n_kept} kept"] = 0 < n_kept <= n_cand
    checks["keep: CPU NMS of the GPU boxes == GPU keep"] = torch.equal(keep_cpu, gp["keep"].cpu())
    print("phase 5: GPU vs the port's CPU path, one B=1 scene")
    for name, ok in checks.items():
        print(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError("GPU vs CPU parity")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU to run on", file=sys.stderr)
        return 1
    try:
        from votenet_tpu.config import default_config
        from votenet_tpu.data.synthetic import synthetic_scenes
        from votenet_tpu_torch.ops.cuda import build, library_path
        from votenet_tpu_torch.predictor import VoteNetPredictor
    except ImportError as e:
        print(f"chip_smoke: run from the root of the repository ({e})", file=sys.stderr)
        return 1

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: card [{card}], torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    build()
    print(f"phase 2: built {library_path().name} in {time.perf_counter() - t0:.2f} s")

    cfg = default_config()
    scenes = synthetic_scenes(SEED, cfg, 8)
    failed = []
    stats = {k: {"err": 0, "ms": 0.0, "plain_ms": 0.0} for k in ("fps", "ballquery")}

    def report(kernel, layer, B, shape, equal, err, k_ms, p_ms):
        st = stats[kernel]
        st["err"] = max(st["err"], err)
        if B == 8:  # per-forward sums at the serving batch
            st["ms"] += k_ms
            st["plain_ms"] += p_ms
        print(f"  {kernel:<10} {layer:<9} {B:>2} {shape:<26} {str(equal):<6} {k_ms * 1e3:>10.1f} {p_ms * 1e3:>11.1f}")
        if not equal:
            failed.append(f"{kernel} {layer} B={B} differs from its plain version")

    def run(name, fn):
        try:
            return fn()
        except Exception:  # a failed phase is reported; the others still run
            traceback.print_exc()
            failed.append(name)
            return None

    run("kernels", lambda: phase_kernels(cfg, scenes, report))
    predictor = run("predictor", lambda: VoteNetPredictor(
        cfg, device="cuda", batch_size=8, generator=torch.Generator().manual_seed(SEED)))
    launches = None
    if predictor is not None:
        run("calibrate head", lambda: calibrate_head(predictor, scenes))
        launches = run("serve", lambda: phase_serve(cfg, scenes, predictor))
        run("cpu parity", lambda: phase_cpu_parity(cfg, scenes, predictor))

    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": "fps", "route": "cuda", "source": "votenet_tpu_torch/csrc/fps.cu",
            "replaces": "votenet_tpu/ops/pallas/fps.py:47",
            "also_replaces": "votenet_tpu/ops/pallas/fps.py:79",
            "launches": launches["fps"], "max_abs_err": stats["fps"]["err"], "tolerance": 0,
            "ms": stats["fps"]["ms"], "plain_ms": stats["fps"]["plain_ms"],
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
        {
            "name": "ballquery", "route": "cuda", "source": "votenet_tpu_torch/csrc/ballquery.cu",
            "replaces": "votenet_tpu/ops/pallas/ballquery.py:71",
            "launches": launches["ballquery"], "max_abs_err": stats["ballquery"]["err"], "tolerance": 0,
            "ms": stats["ballquery"]["ms"], "plain_ms": stats["ballquery"]["plain_ms"],
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
