#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving, training and evaluation
paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # also: torch.profiler over 3 training steps and one eval pass, each mode
    python3 chip_smoke.py --kernel-times  # phases 1-3, 9 and 16-18's kernels alone (no final line)

``--kernel-times`` also runs from a copy of this file placed at the root of
another checkout of the port (an earlier commit's archive), so that both
commits' kernels are timed by the same code in one call: phase 3 then skips
the ball query's route rows where that checkout has one route, and phases
16-18 where it lacks the variant.

Phases, each checked; any failure exits non-zero without the final line:

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
   No CUDA device is a failure.
2. Build the kernels of ``votenet_tpu_torch/csrc`` and time the build.
3. FPS and the ball query against their plain PyTorch versions on the card,
   at the five shapes of a full-width forward (sa1-sa4 and the proposal
   layer), at B=1 and B=8, plus the ball query's r^2 boundary case. Integer
   outputs must be equal; CUDA-event times of both are printed, beside each
   call's bound (see BOUNDS below), for FPS the CTAs a row is split over and
   for the ball query the route (``seg``: segments a row's points are cut
   into, 1 for the unsplit route); then FPS's time a step at every cluster
   size at sa1's and sa2's shapes (B=8), the evidence for ops/cuda/fps.py's
   cluster-size rule, and the ball query forced through the other route at
   every B=8 shape and at sa1 B=1 (bit-equal too), the evidence for
   ops/cuda/ballquery.py's route rule.
4. Serve: a full-width ``VoteNetPredictor`` with seeded random weights
   (the objectness bias shifted so that about half the proposals reach NMS)
   answers 3 batch requests at B=8 and 3 ``detect()`` calls at B=1 on
   synthetic scenes. Outputs must be finite and of the expected shapes, and
   each forward must launch each kernel exactly 5 times.
5. One B=1 scene through the GPU and the port's CPU path with the same
   weights: seeds_xyz equal, votes and proposals_output within tolerance,
   and the CPU NMS of the GPU's boxes equal to the GPU's keep mask.
6. The scatter-add kernel (the group_point backward) at the four scatters
   of a full-width training step (sa2, sa3, sa4, proposal; ball-query
   indices of synthetic scenes), B=2 and B=8: bit-equal to the plain
   version run on the CPU, within tolerance of the plain version on the
   card, CUDA-event times of both, of one ``index_add_`` call (the library
   yardstick) and the bytes bound.
7. Train: a full-width ``create_train_state`` with seeded weights;
   ``Trainer.train_epoch`` takes 3 steps at B=8 on one batch of synthetic
   scenes (after one warm-up step). Each step must launch FPS 5 times, the
   ball query 5 times and the scatter 4 times; losses must be finite and
   the parameters must move. Prints ms per step and scenes/s.
8. One B=2 forward and backward on the GPU and on the port's CPU path from
   the same weights: losses and per-leaf gradients (norm-wise) within
   tolerance; proposal-slot flips between the two devices' votes counted.
9. The fused SA MLP + max-pool kernel (``samlp``) against its plain version
   on the card, at the five calls of a full-width forward (sa1-sa4 and the
   proposal layer), B=1 and B=8, on arguments captured from one forward of
   the trained checkpoint (``.scratch/r4_heldout``, read by
   ``read_flax_msgpack``): within SAMLP_TOL of the output's scale, and at
   B=1 also of the plain version on the CPU; CUDA-event times of both; the
   bound is the 3xTF32 tensor-core figure, the f32 CUDA-core one beside it.
10. Evaluation: the trained checkpoint, 16 synthetic scenes in a
   ``DeviceSceneCache``, ``Evaluator(batch_size=8)`` over
   ``make_packed_predict_fn`` with ``samlp`` "off", then "on". Each forward
   must launch FPS 5, the ball query 5 and samlp 5 (on) or 0 (off) times.
   Per-class AP and mAP@0.25/0.5 of both; on and off must give the same
   detections (floats within REL_TOL of scale) and mAP within 1e-3. Two
   scenes on the GPU and on the port's CPU path: equal detections, or the
   proposal-slot flips between the devices' votes counted. Eval scenes/s
   of three timed passes per mode.
11. Training through the entry point: the port's ``mini_fixture`` writes a
   miniature SUN RGB-D (16 training scenes 5051-5066, 8 validation scenes
   1-8, 24000 points a scene, seed 0) into a temporary directory;
   ``run_train.main`` at ``--preset=full --batch_size=8 --samlp=on
   --eval_every_k_epochs=2`` trains 2 epochs from a cold cache (reading,
   augmentation, the prefetch thread) with the eval at epoch 2 (8 scenes at
   B=64: one forward), then again with ``--max_epoch=3``, which must resume
   from epoch 2. Checked: checkpoints 2 and 3 kept, stat.json's last record
   epoch 3, a finite mAP0.25 at epoch 2, 6 steps and exactly 5 FPS, 5 ball
   query and 4 scatter launches a step plus 5 FPS, 5 ball query and 5
   samlp launches an eval forward. Printed: each epoch's ``epoch_time``,
   ms a step inside ``fit`` beside phase 7's bare steps and the time
   ``train_epoch`` waited on its input pipeline; the eval callback's wall
   time and peak device memory; each ``save_checkpoint``'s ms and bytes.
12. The committed JAX checkpoint on the card: ``Trainer.resume`` of a
   full-width ``create_train_state`` must return 81, with step 41472 on the
   state and on every parameter's Adam state and the schedule's rate; one
   B=8 step, ``save_checkpoint`` at 82, and the file read back: step and
   both optimizer counts 41473, every parameter, moment and statistic
   bit-equal to the card's state copied to the host.
13. The scatter kernel's fast_bf16 variant (each update rounded to bf16,
   summed in f32: ``scatter_precision="fast_bf16"``) at phase 6's shapes:
   bit-equal to its plain version on the CPU, within SCATTER_TOL of the
   card's ``index_add_`` of the rounded updates, different from the exact
   variant; CUDA-event times, one ``index_add_`` call on the rounded
   updates, the bytes bound (the exact variant's).
14. bf16 (``compute_dtype="bfloat16"``, run_eval's throughput preset) and
   mixed precision on the trained checkpoint: serving as phase 4 (beside
   f32 serving of the same weights), the 16-scene eval at B=8 with samlp
   off and on (mAP beside phase 10's f32), every forward launching FPS 5,
   the ball query 5 and samlp 0 (bf16: the kernel runs f32 layers only) or
   2 (mixed, on: sa1 and the proposal layer); one scene on the card against
   the port's CPU path within PRECISION_LIMITS (which the card's f32
   forward must fail), and whether cuBLAS's
   reduced-precision bf16 reduction moves the forward.
15. Training in ``throughput_config()`` with bf16 and with mixed precision:
   3 full-width B=8 steps as phase 7 (bf16: 4 fast_bf16 scatters a step;
   mixed: sa2-sa4's bf16 cotangents take the exact variant, 3, and the f32
   proposal layer the fast one), ms a step beside phase 7's; then phase 11
   at ``--preset=throughput``: 24 fast scatters and no exact one.
16. samlp's bf16-operand variant (``precision="bf16"``) at phase 9's five
   calls, B=1 and B=8: within SAMLP_BF16_TOL of its plain version on the
   card and, at B=1, on the CPU, with the 3xTF32 kernel's output outside it;
   device us beside the 3xTF32 kernel's; the bound is 2 operations a
   multiply-add at bf16's tensor-core peak. Then phase 10 under
   ``set_samlp_precision("bf16")`` (reset to "f32" after): each samlp-on
   forward launches the bf16 variant 5 times and the 3xTF32 kernel never;
   mAP beside phase 10's.
17. The ball query's emit variant (``query_ball_point_emit_xyz``, the
   grouped coordinates too) at the prototype's two shapes and the five
   main-path shapes, B=1 and 8, through both routes: idx, cnt and gxyz
   bit-equal to the ball query + ``group_point`` and to the CPU plain
   version; device us beside the ball query + gather's, the gather alone as
   the library column.
18. The noscalar FPS variant (``fps_rowwise_noscalar``) at the prototype's
   shapes (1, 2 and 8 x 20480 -> 2048) and the five main-path shapes at
   B=8: indices bit-equal to the production kernel's and the plain
   version's; device us beside the production kernel's at the rule's
   cluster size, and both at every cluster size at sa1's shape.

Output: a JSON line of the kernels, the ``nvidia-smi`` line of the card, and
last ``{"ok": true, "device": {...}}``. In the kernels' line ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over the B=8 shapes
of a forward (FPS, ball query, samlp) or of a training step (scatter);
``launches`` is the training path's count, ``launches_fit`` phase 11's
(phase 15's for the fast variant), ``launches_paths`` phases 14-16's; the
variants' ``launches`` are their phase's (16's eval, 17's and 18's checks)
and ``production_ms`` the production kernel's sum beside them.
Kernel times are device times:
``cuda_ms`` queues its timed calls behind a sleep kernel, so the wrappers'
host time between launches does not count (a call whose kernel is shorter
than its Python would otherwise be timed by the host).

BOUNDS: the least time the card could take for a call's work, the larger of
its bytes (each input read once, each output written once) over 3.35 TB/s
and its operations over the peak of the units that do them (H100 SXM,
NVIDIA's data sheet), counted from this run's inputs: FPS 10 f32 operations
a point and step (3 subtract, 3 multiply, 2 add, min, compare); the ball
query 9 a tested (query, point) pair, up to the point where the query's
nsample-th hit ends its early exit (all N where the ball holds fewer); the
scatter one add per valid index and column; these at 67 TFLOP/s (f32
outside the tensor cores). samlp: its matmuls run on the tensor cores in
3xTF32, 3 x 2 operations per multiply-add at 495 TFLOP/s (TF32); beside it
(``bound_f32_ms``) the f32 CUDA-core figure of an f32 kernel, 2 per
multiply-add plus 3 per element of each affine + ReLU and 1 per pooled
element at 67 TFLOP/s; its bf16 variant 2 per multiply-add at 989 TFLOP/s
(bf16). The emit variant: the ball query's, plus 12 bytes written a slot.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

SEED = 0
# Float tolerance, GPU against CPU: matmuls in another summation order
# (cuBLAS against the CPU BLAS, both f32) drift by ~1e-6 of a tensor's
# scale per layer over ~15 layers; allowed: 1e-4 of the reference's scale.
REL_TOL = 1e-4
# The scatter kernel against the plain version on the card: index_add_ adds
# with atomics in a run-dependent order, the kernel in ascending k; two f32
# orders of the same ~10-1000 terms per row differ by a few ulps of the
# row's partial sums. Allowed: 1e-5 of the output's scale. (Against the
# plain version on the CPU, which adds in ascending k, it must be equal.)
SCATTER_TOL = 1e-5
# Gradients GPU against CPU, norm-wise per leaf: ||gpu - cpu|| below
# GRAD_TOL * max(||cpu||, 1e-2 * sqrt(size)). The forward drifts by ~1e-6 of
# scale per layer (as above), batch norm's fast variance cancels on channels
# whose mean dwarfs their spread, and a near-tied max-pool slot can take the
# gradient on one device and not the other; the floor covers leaves whose
# gradient is mathematically ~0 (a dense bias followed by batch norm).
GRAD_TOL = 5e-3
SCATTER_WIDTHS = {"sa2": 128, "sa3": 256, "sa4": 256, "proposal": 259}
# The samlp kernel against its plain version: the affine steps round alike,
# the matmuls sum in another order (the kernel in ascending k with one
# rounding per multiply-add, cuBLAS or the CPU BLAS in blocks), ~1e-7-1e-6
# of the output's scale over 128-256 terms. Allowed: 1e-5 of that scale.
SAMLP_TOL = 1e-5
# samlp's bf16-operand variant against its plain version (phase 16): the
# products of bf16 operands are exact and only their sums' order differs,
# but an activation one f32 ulp apart can round to the neighbouring bf16
# value before the next layer, 2^-8 of it; on the CPU that moved the chain
# up to 6.2e-4 of the output's scale, where bf16 against f32 operands moves
# it 3.3e-3 to 4.4e-3 (tests/test_torch_variants.py). Allowed: 1.5e-3 of
# that scale, which the 3xTF32 kernel's output must exceed.
SAMLP_BF16_TOL = 1.5e-3
SA_LAYERS = ("sa1", "sa2", "sa3", "sa4", "proposal")
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
CKPT = Path(__file__).resolve().parent / ".scratch" / "r4_heldout" / "checkpoint_0000000081.msgpack"
EVAL_SCENES = 16


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms per call of ``fn`` between CUDA events, after one
    warm-up. The calls are queued behind a sleep kernel long enough to cover
    their enqueueing, so the device runs them back to back and the host's
    time between launches (the wrappers' Python) does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2.0 * reps * host_s, 0.2) * 2e9))  # cycles, at most ~0.1-0.2 s
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float) -> tuple[float, float]:
    """(ms of the operations at the f32 peak, ms of the bytes at the memory
    rate): the bound is the larger."""
    return ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def fps_bound(B, N, npoint):
    return bound_ms(10.0 * (npoint - 1) * N * B, B * N * 12.0 + B * npoint * 4.0)


def ballquery_bound(xyz, q, nsample, idx, cnt):
    B, N, _ = xyz.shape
    M = q.shape[1]
    # points a query tests: up to its nsample-th hit, or all N
    last = idx[..., nsample - 1].long() + 1
    scanned = float(last.where(cnt >= nsample, N).sum())
    return bound_ms(9.0 * scanned, (B * N + B * M) * 12.0 + B * M * (nsample + 1) * 4.0)


def emit_bound(xyz, q, nsample, idx, cnt):
    """The ball query's bound with the grouped coordinates' bytes written."""
    ops_ms, bytes_ms = ballquery_bound(xyz, q, nsample, idx, cnt)
    return ops_ms, bytes_ms + idx.numel() * 12.0 / PEAK_BYTES * 1e3


def scatter_bound(g, idx, N):
    B, K, C = g.shape
    valid = float(((idx >= 0) & (idx < N)).sum())
    return bound_ms(valid * C, (B * K * C + B * K + B * N * C) * 4.0)


def samlp_bound(h_all, idx, sh0, s0, layers, precision="f32"):
    """((tensor-core ms, bytes ms), f32 CUDA-core ms); the tensor cores at 3 x
    2 operations a multiply-add in TF32 (3xTF32, "f32") or 2 in bf16."""
    B, N, w0 = h_all.shape
    _, M, S = idx.shape
    rows = B * M * S
    widths = [w0] + [w.shape[1] for w, _, _ in layers]
    macs = sum(rows * w_in * w_out for w_in, w_out in zip(widths, widths[1:]))
    f32_ops = 2.0 * macs + 3.0 * rows * w0 + rows * widths[-1] + sum(3.0 * rows * w for w in widths[1:])
    params = sum(w.numel() + s.numel() + t.numel() for w, s, t in layers) + s0.numel()
    nbytes = (h_all.numel() + sh0.numel() + params + B * M * widths[-1]) * 4.0 + idx.numel() * 4.0
    _, bytes_ms = bound_ms(0.0, nbytes)
    tc_ms = (3.0 * 2.0 * macs / PEAK_TF32_FLOPS if precision == "f32" else 2.0 * macs / PEAK_BF16_FLOPS) * 1e3
    return (tc_ms, bytes_ms), f32_ops / PEAK_F32_FLOPS * 1e3


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

    from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
    from votenet_tpu_torch.ops.cuda import fps as fps_mod
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda, query_ball_point_plain

    # None where --kernel-times runs in a checkout whose ball query has one route
    ballquery_route = getattr(bq_mod, "ballquery_route", None)
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda, farthest_point_sample_plain

    print("phase 3: kernel vs plain on the card (CUDA events, warm L2)")
    print(TABLE_HEAD)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    forced = []  # (layer, B, case): the ball query through the route the rule did not take
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
            N = xyz.shape[1]
            cs, _ = fps_mod.fps_route(xyz)
            report("fps", layer, B, f"{N}->{npoint} cs={cs}", equal, err, k_ms, p_ms, fps_bound(B, N, npoint))
        for layer, radius, nsample, xyz, q in bq_cases:
            got = query_ball_point_cuda(radius, nsample, xyz, q)
            want = query_ball_point_plain(radius, nsample, xyz, q)
            equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            k_ms = cuda_ms(lambda: query_ball_point_cuda(radius, nsample, xyz, q), 20)
            p_ms = cuda_ms(lambda: query_ball_point_plain(radius, nsample, xyz, q), 2)
            err = max(int((got[i] - want[i]).abs().max()) for i in range(2))
            N, M = xyz.shape[1], q.shape[1]
            seg = ballquery_route(B, N, M, sm_count)[0] if ballquery_route else 1
            report("ballquery", layer, B, f"N={N} M={M} r={radius} seg={seg}", equal, err, k_ms, p_ms,
                   ballquery_bound(xyz, q, nsample, *want))
            if ballquery_route and (B == 8 or layer == "sa1"):
                forced.append((layer, B, (radius, nsample, xyz, q), want, 1 if seg > 1 else 4))

    # the cluster-size rule's evidence: every route at sa1's and sa2's shapes
    for layer, npoint, xyz in fps_cases[:2]:
        sizes = fps_mod.FPS_CLUSTER_SIZES[2:] if xyz.shape[1] > 4 * fps_mod.FPS_POINTS_PER_CTA else (1, 2, 4)
        us = {cs: cuda_ms(lambda: farthest_point_sample_cuda(npoint, xyz, cluster=cs), 3) * 1e3 / (npoint - 1)
              for cs in sizes}
        print(f"  fps {layer} B=8 us a step by CTAs a row: " + ", ".join(f"{c}: {v:.3f}" for c, v in us.items())
              + f" (the rule: {fps_mod.fps_route(xyz)[0]})")

    # the route rule's evidence: each shape through the other route
    for layer, B, (radius, nsample, xyz, q), want, segments in forced:
        N, M = xyz.shape[1], q.shape[1]
        got = query_ball_point_cuda(radius, nsample, xyz, q, segments=segments)
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        k_ms = cuda_ms(lambda: query_ball_point_cuda(radius, nsample, xyz, q, segments=segments), 20)
        seg = ballquery_route(B, N, M, sm_count, segments)[0]
        print(f"  ballquery {layer} B={B} forced seg={seg}: {'bit-equal' if equal else 'DIFFERS'}, "
              f"{k_ms * 1e3:.1f} us (the rule's route: seg={ballquery_route(B, N, M, sm_count)[0]})")
        if not equal:
            raise AssertionError(f"ball query {layer} B={B} with {seg} segments differs from its plain version")

    # r^2 boundary: d2 = 0.039999996 < float32(0.2)*float32(0.2) = 0.040000003
    p = torch.tensor([[[0.19999999, 5e-05, 0.0], [1.0, 1.0, 1.0]]], device="cuda")
    q = torch.zeros((1, 1, 3), device="cuda")
    want = query_ball_point_plain(0.2, 4, p, q)
    ok = int(want[1][0, 0]) == 1
    for segments in (None, 2) if ballquery_route else (None,):
        got = query_ball_point_cuda(0.2, 4, p, q, **({"segments": segments} if segments else {}))
        ok = ok and int(got[1][0, 0]) == 1 and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"  r^2 boundary point (0.19999999, 5e-05, 0), r=0.2: kernel cnt={int(got[1][0, 0])} "
          f"plain cnt={int(want[1][0, 0])} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("ball query r^2 boundary case")


TABLE_HEAD = (f"  {'kernel':<10} {'layer':<9} {'B':>2} {'shape':<30} {'ok':<6} {'kernel_us':>10} "
              f"{'plain_us':>11} {'library_us':>10} {'bound_us':>9} {'by':<10}")


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


def phase_serve(cfg, scenes, predictor, label="phase 4"):
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
    print(f"{label}: served 3 x B=8 and 3 x B=1: launches {launches} over 6 forwards, 5 + 5 each")
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


def phase_scatter(cfg, scenes, report):
    """The scatter kernel at the four scatters of a training step, B=2 and 8."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

    print("phase 6: scatter-add kernel vs plain (ball-query indices of synthetic scenes; CUDA events, warm L2)")
    print(TABLE_HEAD)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B in (2, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        _, bq_cases = layer_inputs(points, cfg)
        for layer, radius, nsample, xyz, q in bq_cases[1:]:  # sa1's input carries no gradient
            N, C = xyz.shape[1], SCATTER_WIDTHS[layer]
            idx = ops.query_ball_point(radius, nsample, xyz, q)[0].reshape(B, -1).contiguous()
            g = torch.randn((B, idx.shape[1], C), generator=gen, device="cuda")
            got = scatter_add_cuda(g, idx, N)
            want_cpu = scatter_add_plain(g.cpu(), idx.cpu(), N)
            want_card = scatter_add_plain(g, idx, N)
            exact = torch.equal(got.cpu(), want_cpu)
            err = float((got.cpu() - want_cpu).abs().max())
            card_err = float((got - want_card).abs().max())
            card_tol = SCATTER_TOL * float(want_card.abs().max())
            k_ms = cuda_ms(lambda: scatter_add_cuda(g, idx, N), 20)
            p_ms = cuda_ms(lambda: scatter_add_plain(g, idx, N), 20)
            # the library yardstick: one index_add_ call on flat indices (atomics)
            flat = (idx.long() + (torch.arange(B, device="cuda") * N)[:, None]).reshape(-1)
            g2, buf = g.reshape(-1, C), torch.zeros((B * N, C), device="cuda")
            l_ms = cuda_ms(lambda: buf.index_add_(0, flat, g2), 20)
            report("scatter", layer, B, f"K={idx.shape[1]} N={N} C={C}", exact and card_err <= card_tol,
                   err, k_ms, p_ms, scatter_bound(g, idx, N), l_ms)
            print(f"    vs the CPU plain version: {'bit-equal' if exact else f'max diff {err:.3g}'}; "
                  f"vs the card's index_add_: max diff {card_err:.3g} <= {card_tol:.3g}")


def phase_scatter_fast(cfg, scenes, report):
    """The scatter kernel's fast_bf16 variant at the four scatters of a
    training step, B=2 and 8: bit-equal to its plain version on the CPU."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda, scatter_add_plain

    print("phase 13: scatter-add kernel, fast_bf16 variant, vs plain (updates rounded to bf16, summed in f32; "
          "CUDA events, warm L2)")
    print(TABLE_HEAD)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for B in (2, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        _, bq_cases = layer_inputs(points, cfg)
        for layer, radius, nsample, xyz, q in bq_cases[1:]:
            N, C = xyz.shape[1], SCATTER_WIDTHS[layer]
            idx = ops.query_ball_point(radius, nsample, xyz, q)[0].reshape(B, -1).contiguous()
            g = torch.randn((B, idx.shape[1], C), generator=gen, device="cuda")
            got = scatter_add_cuda(g, idx, N, "fast_bf16")
            want_cpu = scatter_add_plain(g.cpu(), idx.cpu(), N, "fast_bf16")
            want_card = scatter_add_plain(g, idx, N, "fast_bf16")
            exact = torch.equal(got.cpu(), want_cpu)
            err = float((got.cpu() - want_cpu).abs().max())
            card_err = float((got - want_card).abs().max())
            card_tol = SCATTER_TOL * float(want_card.abs().max())
            rounding = float((got - scatter_add_cuda(g, idx, N)).abs().max())
            k_ms = cuda_ms(lambda: scatter_add_cuda(g, idx, N, "fast_bf16"), 20)
            p_ms = cuda_ms(lambda: scatter_add_plain(g, idx, N, "fast_bf16"), 20)
            # the library yardstick: one index_add_ call on the rounded updates
            flat = (idx.long() + (torch.arange(B, device="cuda") * N)[:, None]).reshape(-1)
            g2, buf = g.reshape(-1, C).to(torch.bfloat16).float(), torch.zeros((B * N, C), device="cuda")
            l_ms = cuda_ms(lambda: buf.index_add_(0, flat, g2), 20)
            report("scatter_fast_bf16", layer, B, f"K={idx.shape[1]} N={N} C={C}",
                   exact and card_err <= card_tol and rounding > 0, err, k_ms, p_ms, scatter_bound(g, idx, N), l_ms)
            print(f"    vs the CPU plain version: {'bit-equal' if exact else f'max diff {err:.3g}'}; "
                  f"vs the card's index_add_: max diff {card_err:.3g} <= {card_tol:.3g}; "
                  f"vs the exact variant: max diff {rounding:.3g} (the rounding, > 0)")


def train_counters():
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    return {"fps": farthest_point_sample_cuda, "ballquery": query_ball_point_cuda, "scatter": scatter_add_cuda,
            "scatter_fast_bf16": scatter_add_cuda.fast_bf16}


def step_launches(cfg) -> dict:
    """The kernel launches of one full-width training step under ``cfg``:
    FPS and the ball query 5 each; 4 scatters (sa2-sa4, proposal), each in
    the Config's mode where its cotangent is f32, and exact where it is bf16
    (mixed precision's sa2-sa4 feature gathers)."""
    mixed = cfg.mixed_precision and cfg.compute_dtype == "float32"
    fast = cfg.scatter_precision == "fast_bf16"
    n_f32 = 1 if mixed else 4
    return {"fps": 5, "ballquery": 5, "scatter": 4 - n_f32 * fast, "scatter_fast_bf16": n_f32 * fast}


def phase_train(cfg, scenes, profile=False, step_ms=None, label="phase 7"):
    """Trainer.train_epoch: 3 full-width steps at B=8 after one warm-up
    (their ms appended to ``step_ms`` where given), each launching exactly
    ``step_launches(cfg)``."""
    import torch

    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.train import Trainer, create_train_state

    counters = train_counters()
    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device="cuda")
    trainer = Trainer(cfg, state)
    trainer.train_epoch([batch], metrics_every=1)  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    marks = []

    def counts():
        return {k: c.launches for k, c in counters.items()}

    def timed(n):
        for _ in range(n):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), counts()))
            yield batch
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), counts()))

    for c in counters.values():
        c.launches = 0
    trainer.train_epoch(timed(3), metrics_every=1)
    launches = counts()
    step_s, per_step = [], []
    for (t0, c0), (t1, c1) in zip(marks, marks[1:]):
        step_s.append(t1 - t0)
        per_step.append({k: c1[k] - c0[k] for k in c0})
    want = step_launches(cfg)
    for i, d in enumerate(per_step):
        if d != want:
            raise AssertionError(f"train step {i} launched {d}, not {want}")
    losses = {k: list(v) for k, v in trainer.logger.moving.buffers.items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite metrics {losses}")
    still = [n for n, p in state.model.named_parameters() if torch.equal(p, before[n])]
    if still:
        raise AssertionError(f"parameters that did not move in 3 steps: {still}")
    print(f"{label}: Trainer.train_epoch, 3 full-width steps at B=8 (after 1 warm-up): launches {launches}, "
          f"per step {per_step[0]}; all {len(before)} parameter leaves moved")
    print(f"  step ms {[s * 1e3 for s in step_s]}; scenes/s {[8 / s for s in step_s]}")
    if step_ms is not None:
        step_ms.extend(s * 1e3 for s in step_s)
    print(f"  total_cost over the 4 steps {losses['total_cost']}")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_device(lambda: trainer.train_epoch([batch] * 3, metrics_every=3), f"3 training steps, {label}")
    return launches


def profile_device(run, label):
    """Device time by kernel group over ``run()`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key))
    total = sum(ms for ms, _, _ in kernels)
    if total == 0:
        print(f"profile ({label}): the profiler recorded no device time; time with CUDA events instead")
        return
    groups = {}
    for ms, _, name in kernels:
        low = name.lower()
        key = ("fps" if "fps_cluster_kernel" in low
               else "ballquery" if "ballquery_kernel" in low or "bq_merge_kernel" in low
               else "scatter" if "namespace)::scatter_" in low
               else "samlp" if "samlp_kernel" in low or "samlp_split_weights" in low
               else "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma", "sm90_")) else "other")
        groups[key] = groups.get(key, 0.0) + ms
    print(f"profile ({label}): wall {wall_ms:.1f} ms, kernel time {total:.1f} ms, "
          f"busy share {total / wall_ms:.3f}")
    print("  by group (ms, share of kernel time): " + ", ".join(
        f"{k} {v:.1f} ({v / total:.3f})" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:15]:
        print(f"  {ms:9.2f} ms  x{count:<5} {name[:110]}")


def phase_train_cpu_parity(cfg, scenes):
    """One B=2 forward and backward on the GPU and on the CPU, same weights."""
    import torch

    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.train import create_train_state, forward_backward

    batch = next(batch_scenes(iter(scenes[:2]), 2, cfg.max_gt_boxes))
    gpu = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED + 1), device="cuda")
    cpu = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED + 1), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    lg = forward_backward(gpu.model, batch, cfg)
    lc = forward_backward(cpu.model, batch, cfg)
    pts = torch.from_numpy(batch["points"])
    with torch.no_grad():  # the same train-mode forward, for the votes
        ge = {k: v.cpu() for k, v in gpu.model(pts.cuda()).items()}
        ce = cpu.model(pts)
    fi = ops.farthest_point_sample(cfg.proposal_num, ce["seeds_xyz"])
    idx_g, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ge["votes_xyz"], ops.gather_point(ge["votes_xyz"], fi))
    idx_c, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ce["votes_xyz"], ops.gather_point(ce["votes_xyz"], fi))
    flips = int((idx_g != idx_c).sum())
    checks = {}
    for field in lc._fields:
        err, tol = scale_err(getattr(lg, field), getattr(lc, field))
        checks[f"{field} err {err:.3g} <= {tol:.3g}"] = err <= tol
    grads_c = dict(cpu.model.named_parameters())
    rels = []
    for name, p in gpu.model.named_parameters():
        if flips and name.startswith("proposal."):
            continue  # a slot that flipped moves this layer's gradient by O(1)
        a, b = p.grad.cpu().double(), grads_c[name].grad.double()
        floor = 1e-2 * b.numel() ** 0.5
        rels.append((float((a - b).norm()) / max(float(b.norm()), floor), name))
    worst = sorted(rels, reverse=True)[:3]
    leaves = "backbone and voting leaves (proposal layer left out)" if flips else "all leaves"
    checks[f"gradients, {len(rels)} {leaves}, norm-wise: worst {[(f'{r:.3g}', n) for r, n in worst]} < {GRAD_TOL}"] = (
        worst[0][0] < GRAD_TOL
    )
    print(f"phase 8: one B=2 training forward and backward, GPU vs the port's CPU path; "
          f"{flips} proposal-slot flips between the two devices' votes")
    for name, ok in checks.items():
        print(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError("training GPU vs CPU parity")
    return flips


def trained_state_dict():
    """The committed trained checkpoint's weights as a port state_dict."""
    from votenet_tpu_torch.models import convert_flax_variables
    from votenet_tpu_torch.utils.checkpoint import read_flax_msgpack

    tree = read_flax_msgpack(CKPT)
    return convert_flax_variables({"params": tree["params"], "batch_stats": tree["batch_stats"]})


def capture_samlp_args(cfg, state_dict, points):
    """The arguments of the five fused calls of one samlp="on" forward on the
    card (the kernel's dtypes and layouts), in the order sa1-sa4, proposal."""
    import torch

    import votenet_tpu_torch.ops as ops_pkg
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_plain

    model = VoteNet(cfg.replace(samlp="on"))
    model.load_state_dict(state_dict)
    model.cuda()
    captured = []

    def capture(h_all, idx, sh0, s0, layers, precision="f32"):
        c = [h_all.contiguous(), idx.to(torch.int32).contiguous(), sh0.contiguous(), s0.contiguous(),
             [tuple(t.contiguous() for t in layer) for layer in layers]]
        captured.append(c)
        # an earlier checkout's plain version (--kernel-times) takes no precision
        return fused_sa_mlp_pool_plain(*c, **({"precision": precision} if precision != "f32" else {}))

    orig, ops_pkg.fused_sa_mlp_pool = ops_pkg.fused_sa_mlp_pool, capture
    try:
        with torch.inference_mode():
            model(points)
    finally:
        ops_pkg.fused_sa_mlp_pool = orig
    if len(captured) != len(SA_LAYERS):
        raise AssertionError(f"a samlp forward made {len(captured)} fused calls, not {len(SA_LAYERS)}")
    return captured


def phase_samlp(cfg, scenes, state_dict, report, f32_bound):
    """The samlp kernel against its plain version at the five calls, B=1 and 8."""
    import torch

    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    print("phase 9: samlp kernel vs plain (trained checkpoint's arguments; CUDA events, warm L2)")
    print(TABLE_HEAD)
    for B in (1, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        with torch.inference_mode():
            calls = capture_samlp_args(cfg, state_dict, points)
            for layer, args in zip(SA_LAYERS, calls):
                h_all, idx, _, _, layers = args
                widths = [h_all.shape[-1]] + [w.shape[1] for w, _, _ in layers]
                got = fused_sa_mlp_pool_cuda(*args)
                want = fused_sa_mlp_pool_plain(*args)
                err = float((got - want).abs().max())
                tol = SAMLP_TOL * float(want.abs().max())
                ok = err <= tol
                line = f"    vs the card's plain version: max diff {err:.3g} <= {tol:.3g}"
                if B == 1:
                    cpu_args = [t.cpu() for t in args[:4]] + [[tuple(t.cpu() for t in lay) for lay in layers]]
                    want_cpu = fused_sa_mlp_pool_plain(*cpu_args)
                    cpu_err = float((got.cpu() - want_cpu).abs().max())
                    cpu_tol = SAMLP_TOL * float(want_cpu.abs().max())
                    ok = ok and cpu_err <= cpu_tol
                    line += f"; vs the CPU plain version: {cpu_err:.3g} <= {cpu_tol:.3g}"
                k_ms = cuda_ms(lambda: fused_sa_mlp_pool_cuda(*args), 10)
                p_ms = cuda_ms(lambda: fused_sa_mlp_pool_plain(*args), 5)
                shape = f"M={idx.shape[1]} S={idx.shape[2]} w={'/'.join(map(str, widths))}"
                bound, f32_ms = samlp_bound(*args)
                report("samlp", layer, B, shape, ok, err, k_ms, p_ms, bound)
                if B == 8:
                    f32_bound[0] += f32_ms
                print(line + f"; f32 CUDA-core bound {f32_ms * 1e3:.1f} us")


def eval_counters():
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    return {**{k: v for k, v in train_counters().items() if not k.startswith("scatter")},
            "samlp": fused_sa_mlp_pool_cuda, "samlp_bf16": fused_sa_mlp_pool_cuda.bf16}


def same_detections(a, b):
    """(equal, message): per scene the same count and classes, corners and
    scores within REL_TOL of scale."""
    worst = 0.0
    for img_id in a:
        if [d[0] for d in a[img_id]] != [d[0] for d in b[img_id]]:
            return False, f"scene {img_id}: {len(a[img_id])} vs {len(b[img_id])} detections or other classes"
        for (_, ca, sa), (_, cb, sb) in zip(a[img_id], b[img_id]):
            worst = max(worst, float(np.abs(ca - cb).max()) / max(1.0, float(np.abs(cb).max())),
                        abs(sa - sb) / max(1.0, abs(sb)))
    return worst <= REL_TOL, f"worst float gap {worst:.3g} of scale <= {REL_TOL}"


def phase_eval(cfg, state_dict, profile=False, maps=None, samlp_per_forward=5, label="phase 10", beside=None,
               samlp_counter="samlp"):
    """Evaluator over 16 scenes on the card, samlp off then on, each forward
    launching fps 5, ballquery 5 and samlp 0 (off) or ``samlp_per_forward``
    (on: the fused kernel runs the f32 SA layers only) on the counter
    ``samlp_counter`` ("samlp_bf16": the bf16-operand variant), 0 on the
    other. Each samlp mode's {iou: mAP} goes into ``maps`` where given, and
    is printed beside ``beside``'s. In f32 (every layer fused, 3xTF32) also:
    samlp on and off give the same detections, and two scenes through the
    GPU and the CPU path. Returns each samlp mode's launches."""
    import torch

    from votenet_tpu_torch.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu_torch import ops
    from votenet_tpu_torch.eval import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models import VoteNet

    scenes = synthetic_scenes(SEED, cfg, EVAL_SCENES)
    gt_all = synthetic_gt_all(scenes)
    pairs = [(int(s["data_idx"]), s["points"]) for s in scenes]
    cache = DeviceSceneCache(pairs, 8, "cuda")
    counters = eval_counters()
    runs = {}
    checks = {}
    print(f"{label}: Evaluator over {EVAL_SCENES} synthetic scenes at B=8, trained checkpoint, samlp off and on")
    for mode in ("off", "on"):
        model = VoteNet(cfg.replace(samlp=mode))
        model.load_state_dict(state_dict)
        model.cuda()
        predict = make_packed_predict_fn(model, cfg)
        per_forward = []

        def counted(points):
            before = {k: c.launches for k, c in counters.items()}
            out = predict(points)
            per_forward.append({k: c.launches - before[k] for k, c in counters.items()})
            return out

        ev = Evaluator(cfg, gt_all, batch_size=8)
        ev.predictions_for_scenes(predict, cache)  # warm-up
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        pred = ev.predictions_for_scenes(counted, cache)
        torch.cuda.synchronize()
        seconds = [time.perf_counter() - t0]
        launches = {k: c.launches for k, c in counters.items()}
        want = {"fps": 5, "ballquery": 5, "samlp": 0, "samlp_bf16": 0}
        want[samlp_counter] = samlp_per_forward if mode == "on" else 0
        for i, d in enumerate(per_forward):
            if d != want:
                raise AssertionError(f"samlp={mode}: forward {i} launched {d}, not {want}")
        for _ in range(2):  # two more timed passes, for the spread
            t0 = time.perf_counter()
            ev.predictions_for_scenes(predict, cache)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        scores = {iou: Evaluator(cfg, gt_all, ovthresh=iou, batch_size=8).score(pred) for iou in (0.25, 0.5)}
        runs[mode] = (pred, scores, launches)
        if maps is not None:
            maps[mode] = {iou: r["mAP"] for iou, r in scores.items()}
        checks[f"samlp={mode}: mAP finite"] = all(np.isfinite(r["mAP"]) for r in scores.values())
        n_det = sum(len(v) for v in pred.values())
        print(f"  samlp={mode}: launches {launches} over {len(per_forward)} forwards, per forward {per_forward[0]}; "
              f"{n_det} detections; seconds {[round(s, 6) for s in seconds]}, "
              f"eval scenes/s {[round(EVAL_SCENES / s, 2) for s in seconds]}")
        for iou, r in scores.items():
            aps = ", ".join(f"{c} {r['ap'][c]:.4f}" for c in sorted(r["ap"]))
            f32 = f" (f32 {beside[mode][iou]:.4f})" if beside else ""
            print(f"    mAP@{iou} {r['mAP']:.4f}{f32}: {aps}")
        if profile:
            profile_device(lambda: ev.predictions_for_scenes(predict, cache),
                           f"eval, {label.strip()}, samlp={mode}, {EVAL_SCENES} scenes at B=8")
        del model
    if samlp_per_forward != 5 or samlp_counter != "samlp":  # a bf16 mode: its GPU-vs-CPU check is phase 14's or 16's
        return finish(checks, "evaluation checks", {mode: r[2] for mode, r in runs.items()})

    equal, msg = same_detections(runs["on"][0], runs["off"][0])
    checks[f"on vs off: same detections, {msg}"] = equal
    for iou in (0.25, 0.5):
        gap = abs(runs["on"][1][iou]["mAP"] - runs["off"][1][iou]["mAP"])
        checks[f"on vs off: mAP@{iou} gap {gap:.3g} <= 1e-3"] = gap <= 1e-3

    # two scenes through the GPU and the port's CPU path, samlp on
    gpu = VoteNet(cfg.replace(samlp="on"))
    gpu.load_state_dict(state_dict)
    cpu = VoteNet(cfg.replace(samlp="on"))
    cpu.load_state_dict(state_dict)
    gpu.cuda()
    two = pairs[:2]
    ev2 = Evaluator(cfg, gt_all, batch_size=2)
    pg = ev2.predictions_for_scenes(make_packed_predict_fn(gpu, cfg), two)
    pc = ev2.predictions_for_scenes(make_packed_predict_fn(cpu, cfg), two)
    pts = torch.from_numpy(np.stack([p for _, p in two]))
    with torch.inference_mode():
        ge = {k: v.cpu() for k, v in gpu(pts.cuda()).items()}
        ce = cpu(pts)
        fi = ops.farthest_point_sample(cfg.proposal_num, ce["seeds_xyz"])
        idx_g, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ge["votes_xyz"], ops.gather_point(ge["votes_xyz"], fi))
        idx_c, _ = ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, ce["votes_xyz"], ops.gather_point(ce["votes_xyz"], fi))
    flips = int((idx_g != idx_c).sum())
    equal, msg = same_detections(pg, pc)
    # equal lists are required where no vote crossed a ball boundary between devices
    checks[f"GPU vs CPU, 2 scenes ({flips} proposal-slot flips): {'same detections' if equal else 'differ'}, {msg}"] = (
        equal or flips > 0
    )
    return finish(checks, "evaluation checks", {mode: r[2] for mode, r in runs.items()})


def finish(checks, what, result):
    """Print each check; raise if one failed, else return ``result``."""
    for name, ok in checks.items():
        print(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError(what)
    return result


# The precision modes of phases 14-15, as Config overrides.
PRECISION_MODES = {"bf16": dict(compute_dtype="bfloat16"), "mixed": dict(mixed_precision=True)}
# PRECISION_LIMITS (phase 14): proposals_output of one scene of the committed
# checkpoint on the card against the port's CPU path, in a bf16 mode, gap =
# |gpu - cpu| / max(|cpu|, 1): (the median gap, the largest gap over the
# proposals whose ball query took the same slots on both devices, the
# number of proposals with a flipped slot). Both devices round to bf16 at
# the same points, but a matmul that sums in another order can round an
# element to the neighbouring bf16 value, and the layers after it carry
# that on (much more so in bf16 mode, whose sa1 subtracts products of
# absolute coordinates rounded to bf16), so bf16 votes cross the proposal
# layer's ball. Readings on an H100 80GB HBM3 at 700 W: bf16 4.9e-4, 0.0625,
# 48 of 256; mixed 1.3e-4, 0.0158, 24. The card's f32 forward in their
# place: bf16 0.0218, 4.64, 229; mixed 1.93e-3, 0.897, 104. Each limit sits
# between the two, and every run checks that the f32 forward fails one.
# tests/test_torch_checkpoint.py holds the CPU path to JAX's bf16 forward
# by the same limits.
PRECISION_LIMITS = {"bf16": (5e-3, 0.25, 100), "mixed": (1e-3, 0.08, 60)}


def rel_gap(a, b):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return (a - b).abs() / b.abs().clamp(min=1.0)


def precision_gaps(got, want, idx_got, idx_want):
    """(median gap, largest gap over the proposals without a flipped slot,
    proposals with a flipped slot) of ``got`` against ``want``."""
    gap = rel_gap(got, want)
    flipped = (idx_got != idx_want).any(-1)
    return float(gap.median()), float(gap[~flipped].max()) if (~flipped).any() else 0.0, int(flipped.sum())


def within(gaps, limits):
    return all(g <= lim for g, lim in zip(gaps, limits))


def phase_precision(cfg, scenes, state_dict, f32_maps, profile=False):
    """bf16 and mixed serving and eval on the committed checkpoint: B=8 and
    B=1 serving, the 16-scene eval at B=8 with samlp off and on (phase 10
    with the mode's samlp launches), and one scene on the card against the
    port's CPU path within PRECISION_LIMITS."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.models import VoteNet, predict_boxes
    from votenet_tpu_torch.predictor import VoteNetPredictor

    counters = eval_counters()
    f32_model = VoteNet(cfg)
    f32_model.load_state_dict(state_dict)
    f32_model.cuda()
    pts = torch.from_numpy(scenes[0]["points"][None])
    with torch.inference_mode():
        f32_out = {k: v.cpu() for k, v in f32_model(pts.cuda()).items()}
    del f32_model
    launches, checks = {}, {}
    print("phase 14: bf16 and mixed-precision serving and eval, committed checkpoint (epoch 81)")
    # f32 serving of the same weights first: the yardstick of the two modes' requests
    phase_serve(cfg, scenes, VoteNetPredictor(cfg, state_dict, device="cuda", batch_size=8), label="  f32 serving")
    for name, overrides in PRECISION_MODES.items():
        mcfg = cfg.replace(**overrides)
        predictor = VoteNetPredictor(mcfg, state_dict, device="cuda", batch_size=8)
        for c in counters.values():
            c.launches = 0
        phase_serve(mcfg, scenes, predictor, label=f"  {name} serving")
        launches[f"serve_{name}"] = {k: c.launches for k, c in counters.items()}
        checks[f"{name} serving: no samlp launch (samlp off)"] = launches[f"serve_{name}"]["samlp"] == 0
        # samlp runs on the f32 SA layers only: none in bf16, sa1 and the proposal layer in mixed
        per_mode = phase_eval(mcfg, state_dict, profile, samlp_per_forward=2 if name == "mixed" else 0,
                              label=f"  {name} eval", beside=f32_maps)
        launches.update({f"eval_{name}_samlp_{samlp}": counts for samlp, counts in per_mode.items()})

        # one B=1 scene on the card and on the port's CPU path
        cpu_model = VoteNet(mcfg)
        cpu_model.load_state_dict(state_dict)
        matmul = torch.backends.cuda.matmul
        with torch.inference_mode():
            ge = predictor.model(pts.cuda())
            gp = predict_boxes(ge, mcfg)
            ge = {k: v.cpu() for k, v in ge.items()}
            ce = cpu_model(pts)
            keep_cpu = ops.nms3d(gp["bboxes"].cpu(), gp["nms_scores"].cpu(), gp["objectness"].cpu(), mcfg.nms_iou)
            # does cuBLAS's reduced-precision (bf16) split-K reduction move the forward?
            saved = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = not saved
            try:
                other = predictor.model(pts.cuda())["proposals_output"].cpu()
            finally:
                matmul.allow_bf16_reduced_precision_reduction = saved
            fi = ops.farthest_point_sample(mcfg.proposal_num, ce["seeds_xyz"])
            fi_g = ops.farthest_point_sample(mcfg.proposal_num, ge["seeds_xyz"].cuda()).cpu()  # the kernel
            idx = {k: ops.query_ball_point(mcfg.proposal_radius, mcfg.proposal_nsample, e["votes_xyz"],
                                           ops.gather_point(e["votes_xyz"], fi))[0]
                   for k, e in (("gpu", ge), ("cpu", ce), ("f32", f32_out))}
        gaps = precision_gaps(ge["proposals_output"], ce["proposals_output"], idx["gpu"], idx["cpu"])
        f32_gaps = precision_gaps(f32_out["proposals_output"], ce["proposals_output"], idx["f32"], idx["cpu"])
        limits = PRECISION_LIMITS[name]
        dtypes = {k: str(ge[k].dtype).replace("torch.", "") for k in ("seeds_points", "votes_xyz", "proposals_output")}
        want_dtypes = {"seeds_points": "bfloat16" if name == "bf16" else "float32", "votes_xyz": "float32",
                       "proposals_output": "float32"}
        flag_gap = float((other - ge["proposals_output"]).abs().max())
        checks.update({
            f"{name} GPU vs CPU: seeds_xyz equal": torch.equal(ge["seeds_xyz"], ce["seeds_xyz"]),
            f"{name} GPU vs CPU: proposal FPS indices equal": torch.equal(fi, fi_g),
            f"{name} end-point dtypes {dtypes}": dtypes == want_dtypes,
            f"{name} GPU vs CPU proposals_output: median gap, max gap without a flipped slot, flipped proposals "
            f"{gaps[0]:.3g}, {gaps[1]:.3g}, {gaps[2]} within {limits}": within(gaps, limits),
            f"{name} the card's f32 forward against the CPU path ({f32_gaps[0]:.3g}, {f32_gaps[1]:.3g}, "
            f"{f32_gaps[2]}) exceeds one of them": not within(f32_gaps, limits),
            f"{name} keep: CPU NMS of the GPU boxes == GPU keep ({int(gp['keep'].sum())} kept)":
                torch.equal(keep_cpu, gp["keep"].cpu()),
        })
        print(f"  {name}: cuBLAS allow_bf16_reduced_precision_reduction={not saved} against {saved}: "
              f"proposals_output max diff {flag_gap:.3g}")
        del predictor, cpu_model
    return finish(checks, "bf16 / mixed serving and eval checks", launches)


def phase_precision_train(scenes, bare_step_ms, profile=False):
    """3 full-width B=8 steps in throughput_config() with bf16 and with mixed
    precision, exact launches; ms a step beside phase 7's."""
    from votenet_tpu_torch.config import throughput_config

    launches = {}
    for name, overrides in PRECISION_MODES.items():
        step_ms = []
        launches[f"train_{name}"] = phase_train(throughput_config(**overrides), scenes, profile=profile,
                                                step_ms=step_ms, label=f"phase 15 ({name}, throughput preset)")
        print(f"  {name}: ms a step {[round(ms, 2) for ms in step_ms]} beside phase 7's f32 exact "
              f"{[round(ms, 2) for ms in bare_step_ms]}")
    return launches


def phase_samlp_bf16(cfg, scenes, state_dict, report, production_ms):
    """Phase 16's kernels: samlp's bf16-operand variant against its plain
    version at phase 9's five calls, B=1 and 8: within SAMLP_BF16_TOL of the
    card's plain version and, at B=1, of the CPU's; the 3xTF32 kernel's
    output outside it. Device us beside the 3xTF32 kernel's in this process
    (summed at B=8 into ``production_ms``)."""
    import torch

    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda, fused_sa_mlp_pool_plain

    print("phase 16: samlp bf16-operand variant vs plain (trained checkpoint's arguments; CUDA events, warm L2)")
    print(TABLE_HEAD)
    for B in (1, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        with torch.inference_mode():
            calls = capture_samlp_args(cfg, state_dict, points)
            for layer, args in zip(SA_LAYERS, calls):
                h_all, idx, _, _, layers = args
                widths = [h_all.shape[-1]] + [w.shape[1] for w, _, _ in layers]
                got = fused_sa_mlp_pool_cuda(*args, precision="bf16")
                want = fused_sa_mlp_pool_plain(*args, precision="bf16")
                tf32 = fused_sa_mlp_pool_cuda(*args)
                err = float((got - want).abs().max())
                tf32_err = float((tf32 - want).abs().max())
                tol = SAMLP_BF16_TOL * float(want.abs().max())
                ok = err <= tol < tf32_err
                line = (f"    vs the card's plain version: max diff {err:.3g} <= {tol:.3g}, the 3xTF32 kernel's "
                        f"{tf32_err:.3g} above it")
                if B == 1:
                    cpu_args = [t.cpu() for t in args[:4]] + [[tuple(t.cpu() for t in lay) for lay in layers]]
                    want_cpu = fused_sa_mlp_pool_plain(*cpu_args, precision="bf16")
                    cpu_err = float((got.cpu() - want_cpu).abs().max())
                    cpu_tol = SAMLP_BF16_TOL * float(want_cpu.abs().max())
                    ok = ok and cpu_err <= cpu_tol
                    line += f"; vs the CPU plain version: {cpu_err:.3g} <= {cpu_tol:.3g}"
                k_ms = cuda_ms(lambda: fused_sa_mlp_pool_cuda(*args, precision="bf16"), 10)
                f_ms = cuda_ms(lambda: fused_sa_mlp_pool_cuda(*args), 10)
                p_ms = cuda_ms(lambda: fused_sa_mlp_pool_plain(*args, precision="bf16"), 5)
                shape = f"M={idx.shape[1]} S={idx.shape[2]} w={'/'.join(map(str, widths))}"
                bound, _ = samlp_bound(*args, precision="bf16")
                report("samlp_bf16", layer, B, shape, ok, err, k_ms, p_ms, bound)
                if B == 8:
                    production_ms["samlp_bf16"] += f_ms
                print(line + f"; the 3xTF32 kernel {f_ms * 1e3:.1f} us in this process")


def phase_eval_samlp_bf16(cfg, state_dict, f32_maps):
    """Phase 16's eval: phase 10 under ``set_samlp_precision("bf16")``, each
    samlp-on forward launching the bf16 variant 5 times and the 3xTF32
    kernel never; mAP beside phase 10's. The precision is reset to "f32"."""
    from votenet_tpu_torch.ops.dispatch import set_samlp_precision

    set_samlp_precision("bf16")
    try:
        return phase_eval(cfg, state_dict, label="phase 16 eval (samlp_precision bf16)", beside=f32_maps,
                          samlp_counter="samlp_bf16")
    finally:
        set_samlp_precision("f32")


def proto_cloud(rng, B, N):
    """The emit prototype's cloud (benchmarks/bq_emit_xyz_proto.py main):
    half uniform over the room, half a cluster of 1 m."""
    return np.concatenate([
        rng.uniform(-4, 4, (B, N // 2, 3)),
        rng.uniform(-0.5, 0.5, (B, N - N // 2, 3)) + rng.uniform(-3, 3, (B, 1, 3)),
    ], axis=1).astype(np.float32)


# the prototypes' shapes on the card (their mains): the emit prototype's N,
# M, radius, S; the noscalar FPS prototype's B, N, npoint
EMIT_PROTO_SHAPES = {"proto-sa1": (20480, 2048, 0.2, 64), "proto-sa2": (2048, 1024, 0.4, 64)}
FPS_PROTO_SHAPES = ((1, 20480, 2048), (2, 20480, 2048), (8, 20480, 2048))


def phase_bq_emit(cfg, scenes, report, production_ms):
    """Phase 17: the ball query's emit variant at the prototype's two shapes
    (its cloud, queries its first M points) and the five main-path shapes,
    B=1 and 8, each through the rule's route and the other: idx, cnt and
    gxyz bit-equal to query_ball_point_cuda + ops.group_point and to the CPU
    plain version. Then device us of the emit kernel beside the ball query +
    gather's in this process (summed at B=8 over the main-path shapes into
    ``production_ms``); the gather alone is the library column. Returns the
    emit launches of the checks."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops.cuda.ballquery import (
        ballquery_route, query_ball_point_cuda, query_ball_point_emit_xyz_cuda, query_ball_point_emit_xyz_plain)

    print("phase 17: ball query emit-xyz variant vs the ball query + group_point and the CPU plain version")
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []  # (layer, B, (radius, S, xyz, q), in the main-path sum)
    rng = np.random.RandomState(SEED)
    for B in (1, 8):
        for name, (N, M, radius, S) in EMIT_PROTO_SHAPES.items():
            xyz = torch.from_numpy(proto_cloud(rng, B, N)).cuda()
            rows.append((name, B, (radius, S, xyz, xyz[:, :M].contiguous()), False))
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        rows += [(layer, B, (radius, S, xyz, q), True) for layer, radius, S, xyz, q in layer_inputs(points, cfg)[1]]
    query_ball_point_emit_xyz_cuda.launches = 0
    checked = []
    for layer, B, (radius, S, xyz, q), _ in rows:
        want = [a.cuda() for a in query_ball_point_emit_xyz_plain(radius, S, xyz.cpu(), q.cpu())]
        seg = ballquery_route(B, xyz.shape[1], q.shape[1], sm_count)[0]
        ok, err, routes = True, 0.0, []
        for segments in (None, 1 if seg > 1 else 4):
            got = query_ball_point_emit_xyz_cuda(radius, S, xyz, q, segments=segments)
            idx, cnt = query_ball_point_cuda(radius, S, xyz, q, segments=segments)
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, (idx, cnt, ops.group_point(xyz, idx))))
            ok = ok and all(torch.equal(a, b) for a, b in zip(got, want))
            err = max([err] + [float((a.double() - b.double()).abs().max()) for a, b in zip(got, want)])
            routes.append(ballquery_route(B, xyz.shape[1], q.shape[1], sm_count, segments)[0])
        checked.append((ok, err, routes, want))
    launches = query_ball_point_emit_xyz_cuda.launches
    print(f"  {launches} emit launches over {len(rows)} shapes x 2 routes; "
          f"{'every one bit-equal' if all(c[0] for c in checked) else 'SOME DIFFER'}")
    print(TABLE_HEAD)
    for (layer, B, (radius, S, xyz, q), main), (ok, err, routes, want) in zip(rows, checked):
        k_ms = cuda_ms(lambda: query_ball_point_emit_xyz_cuda(radius, S, xyz, q), 20)
        base_ms = cuda_ms(lambda: ops.group_point(xyz, query_ball_point_cuda(radius, S, xyz, q)[0]), 20)
        l_ms = cuda_ms(lambda: ops.group_point(xyz, want[0]), 20)
        p_ms = cuda_ms(lambda: query_ball_point_emit_xyz_plain(radius, S, xyz, q), 2)
        N, M = xyz.shape[1], q.shape[1]
        report("ballquery_emit_xyz", layer, B, f"N={N} M={M} r={radius} seg={routes[0]}", ok, err, k_ms, p_ms,
               emit_bound(xyz, q, S, want[0], want[1]), l_ms, total=main)
        if B == 8 and main:
            production_ms["ballquery_emit_xyz"] += base_ms
        print(f"    bit-equal through seg={routes[0]} and seg={routes[1]}: {ok}; the ball query + group_point "
              f"{base_ms * 1e3:.1f} us in this process")
    if launches == 0:
        raise AssertionError("phase 17 launched no emit kernel")
    return launches


def phase_fps_noscalar(cfg, scenes, report, production_ms):
    """Phase 18: the noscalar FPS variant at the prototype's shapes (1, 2 and
    8 x 20480 -> 2048, its uniform clouds) and the five main-path shapes at
    B=8: indices bit-equal to the production kernel's and the plain
    version's, at the cluster size the production rule picks. Then device
    us beside the production kernel's in this process (summed over the
    main-path shapes into ``production_ms``), and us a step of both at
    every cluster size at sa1's shape. Returns the variant's launches of the
    checks."""
    import torch

    from votenet_tpu_torch.ops.cuda import fps as fps_mod
    from votenet_tpu_torch.ops.cuda.fps import (
        farthest_point_sample_cuda, farthest_point_sample_plain, fps_rowwise_noscalar_cuda)

    print("phase 18: FPS noscalar variant vs the production kernel and the plain version")
    rng = np.random.RandomState(SEED)
    rows = [(f"proto-B{B}", npoint, torch.from_numpy(rng.uniform(-4, 4, (B, N, 3)).astype(np.float32)).cuda(), False)
            for B, N, npoint in FPS_PROTO_SHAPES]
    points = torch.from_numpy(np.stack([s["points"] for s in scenes[:8]])).cuda()
    fps_cases = layer_inputs(points, cfg)[0]
    rows += [(layer, npoint, xyz, True) for layer, npoint, xyz in fps_cases]
    fps_rowwise_noscalar_cuda.launches = 0
    checked = []
    for _, npoint, xyz, _ in rows:
        got = fps_rowwise_noscalar_cuda(npoint, xyz)
        want = farthest_point_sample_plain(npoint, xyz)
        checked.append((torch.equal(got, farthest_point_sample_cuda(npoint, xyz)) and torch.equal(got, want),
                        int((got - want).abs().max())))
    launches = fps_rowwise_noscalar_cuda.launches
    print(f"  {launches} noscalar launches over {len(rows)} shapes; "
          f"{'every one bit-equal' if all(c[0] for c in checked) else 'SOME DIFFER'}")
    print(TABLE_HEAD)
    for (layer, npoint, xyz, main), (ok, err) in zip(rows, checked):
        B, N = xyz.shape[0], xyz.shape[1]
        k_ms = cuda_ms(lambda: fps_rowwise_noscalar_cuda(npoint, xyz), 10)
        prod_ms = cuda_ms(lambda: farthest_point_sample_cuda(npoint, xyz), 10)
        p_ms = cuda_ms(lambda: farthest_point_sample_plain(npoint, xyz), 1)
        cs, _ = fps_mod.fps_route(xyz)
        report("fps_noscalar", layer, B, f"{N}->{npoint} cs={cs}", ok, err, k_ms, p_ms, fps_bound(B, N, npoint),
               total=main)
        if main:
            production_ms["fps_noscalar"] += prod_ms
        print(f"    the production kernel {prod_ms * 1e3:.1f} us in this process; us a step: noscalar "
              f"{k_ms * 1e3 / max(npoint - 1, 1):.3f}, production {prod_ms * 1e3 / max(npoint - 1, 1):.3f}")
    layer, npoint, xyz = fps_cases[0]
    steps = []
    for cs in fps_mod.FPS_CLUSTER_SIZES:
        if cs * fps_mod.FPS_THREADS * fps_mod.FPS_POINTS_PER_THREAD[-1] < xyz.shape[1]:
            steps.append(f"{cs}: - (the variant needs the register route)")
            continue
        ns = cuda_ms(lambda: fps_rowwise_noscalar_cuda(npoint, xyz, cluster=cs), 3) * 1e3 / (npoint - 1)
        pr = cuda_ms(lambda: farthest_point_sample_cuda(npoint, xyz, cluster=cs), 3) * 1e3 / (npoint - 1)
        steps.append(f"{cs}: {ns:.3f} / {pr:.3f}")
    print(f"  fps {layer} B=8 us a step by CTAs a row, noscalar / production: " + ", ".join(steps)
          + f" (the rule: {fps_mod.fps_route(xyz)[0]})")
    if launches == 0:
        raise AssertionError("phase 18 launched no noscalar kernel")
    return launches


MINI_TRAIN_IDS = (5051, 5067)  # 16 training scenes
MINI_VAL_IDS = (1, 9)  # 8 validation scenes


@contextlib.contextmanager
def fit_probes():
    """Record, while the block runs: per epoch the seconds ``train_epoch``
    waited on its input pipeline and the steps it took; the eval's wall
    seconds, forwards and peak device memory (reset before it); each
    ``save_checkpoint``'s ms and bytes. Restores what it patched."""
    import torch

    import votenet_tpu_torch.eval.evaluator as evaluator_mod
    import votenet_tpu_torch.train.loop as loop_mod
    from votenet_tpu_torch.utils import checkpoint as ckpt_mod

    rec = {"epochs": [], "evals": [], "saves": [], "forwards": 0}
    train_epoch, evaluate = loop_mod.Trainer.train_epoch, evaluator_mod.Evaluator.evaluate
    decode, save = evaluator_mod.decode_batch_predictions, ckpt_mod.save_checkpoint

    def timed_epoch(self, batches, *a, **k):
        epoch = {"wait_s": 0.0, "steps": 0}
        rec["epochs"].append(epoch)

        def waited():
            it = iter(batches)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    epoch["wait_s"] += time.perf_counter() - t0
                epoch["steps"] += 1
                yield batch

        return train_epoch(self, waited(), *a, **k)

    def timed_evaluate(self, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = evaluate(self, *a, **k)
        torch.cuda.synchronize()
        rec["evals"].append({"s": time.perf_counter() - t0, "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return out

    def counted_decode(*a, **k):
        rec["forwards"] += 1
        return decode(*a, **k)

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        path = save(*a, **k)
        rec["saves"].append({"ms": (time.perf_counter() - t0) * 1e3, "bytes": os.path.getsize(path)})
        return path

    loop_mod.Trainer.train_epoch, evaluator_mod.Evaluator.evaluate = timed_epoch, timed_evaluate
    evaluator_mod.decode_batch_predictions, ckpt_mod.save_checkpoint = counted_decode, timed_save
    try:
        yield rec
    finally:
        loop_mod.Trainer.train_epoch, evaluator_mod.Evaluator.evaluate = train_epoch, evaluate
        evaluator_mod.decode_batch_predictions, ckpt_mod.save_checkpoint = decode, save


def phase_fit(bare_step_ms, preset="full", n_points=24000, device="cuda", label="phase 11"):
    """run_train on a generated miniature: 2 epochs with the eval at epoch 2,
    then a resume that trains epoch 3; exact launch counts."""
    from votenet_tpu_torch import run_train
    from votenet_tpu_torch.config import default_config, throughput_config, tiny_config
    from votenet_tpu_torch.data.mini_fixture import generate_mini_sunrgbd
    from votenet_tpu_torch.utils.checkpoint import all_checkpoint_steps, checkpoint_path, read_flax_msgpack

    counters = eval_counters() | {k: train_counters()[k] for k in ("scatter", "scatter_fast_bf16")}
    per_step = step_launches({"tiny": tiny_config, "throughput": throughput_config, "full": default_config}[preset]())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fit_") as tmp:
        root = Path(tmp)
        rng = np.random.RandomState(SEED)
        t0 = time.perf_counter()
        generate_mini_sunrgbd(str(root / "mini"), list(range(*MINI_TRAIN_IDS)), rng, n_points=n_points)
        generate_mini_sunrgbd(str(root / "mini"), list(range(*MINI_VAL_IDS)), rng, n_points=n_points)
        gen_s = time.perf_counter() - t0
        args = [f"--data_root={root / 'mini'}", f"--cache_dir={root / 'cache'}", f"--log_dir={root / 'run'}",
                f"--preset={preset}", "--batch_size=8", "--eval_every_k_epochs=2", "--samlp=on",
                f"--device={device}", "--train_idx_range={},{}".format(*MINI_TRAIN_IDS),
                "--val_idx_range={},{}".format(*MINI_VAL_IDS)]
        outs, stats = [], []
        for c in counters.values():
            c.launches = 0
        with fit_probes() as rec:
            for max_epoch in (2, 3):
                buf = io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = run_train.main(args + [f"--max_epoch={max_epoch}"])
                outs.append((buf.getvalue(), time.perf_counter() - t0))
                stats.append(json.loads((root / "run" / "stat.json").read_text()))
                if rc != 0:
                    raise AssertionError(f"run_train --max_epoch={max_epoch} exited {rc}")
        launches = {k: c.launches for k, c in counters.items()}
        kept = sorted(all_checkpoint_steps(str(root / "run")))
        steps = int(read_flax_msgpack(checkpoint_path(str(root / "run"), 3))["step"])
    fwd = rec["forwards"]
    print(f"{label}: run_train at preset={preset} on a generated miniature (16 training scenes, 8 validation, "
          f"{n_points} points a scene, written in {gen_s:.2f} s), B=8, samlp on, 2 epochs then a resume to 3")
    for (text, secs), label in zip(outs, ("--max_epoch=2 (cold cache)", "--max_epoch=3 (resumed)")):
        print(f"  {label}: {secs:.2f} s")
        for line in text.splitlines():
            print(f"    {line}")
    want = {"fps": 5 * steps + 5 * fwd, "ballquery": 5 * steps + 5 * fwd, "scatter": per_step["scatter"] * steps,
            "scatter_fast_bf16": per_step["scatter_fast_bf16"] * steps, "samlp": 5 * fwd, "samlp_bf16": 0}
    records = stats[0] + stats[1]
    checks = {
        "resumed from epoch 2": "resumed from epoch 2" in outs[1][0],
        f"checkpoints kept {kept} (2 and 3 among them)": {2, 3} <= set(kept),
        "stat.json's last record is epoch 3 (a fresh history on resume)": [r["epoch_num"] for r in stats[1]] == [3],
        f"epoch 2's mAP0.25 finite ({stats[0][-1].get('mAP0.25')})":
            bool(np.isfinite(stats[0][-1].get("mAP0.25", np.nan))),
        f"{steps} steps (2 an epoch x 3 epochs), {fwd} eval forward(s)": steps == 6 and fwd == 1,
        f"launches {launches} == {want}": launches == want,
    }
    for name, ok in checks.items():
        print(f"  {name}: {'ok' if ok else 'FAIL'}")
    for r, ep in zip(records, rec["epochs"]):
        step_ms = r["epoch_time"] * 1e3 / max(ep["steps"], 1)
        print(f"  epoch {r['epoch_num']}: epoch_time {r['epoch_time']:.4f} s, {ep['steps']} steps, "
              f"{step_ms:.1f} ms a step inside fit (phase 7's bare train_epoch steps: "
              f"{[round(ms, 1) for ms in bare_step_ms]}), input-pipeline wait {ep['wait_s'] * 1e3:.1f} ms "
              f"({ep['wait_s'] / r['epoch_time']:.3f} of the epoch)")
    for ev in rec["evals"]:
        print(f"  eval callback: {ev['s'] * 1e3:.1f} ms wall over {fwd} forward(s) at B=64, peak device memory "
              f"{ev['peak_gib']:.2f} GiB")
    for i, sv in enumerate(rec["saves"]):
        print(f"  save_checkpoint {i + 1}: {sv['ms']:.1f} ms, {sv['bytes']} bytes")
    if not all(checks.values()):
        raise AssertionError("run_train checks")
    return launches


def phase_resume_jax_checkpoint(device="cuda"):
    """The committed JAX checkpoint resumed on the card, one step, saved
    again and read back bit-equal."""
    import torch

    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.models import flax_param_path
    from votenet_tpu_torch.train import Trainer, create_train_state, make_lr_schedule
    from votenet_tpu_torch.utils.checkpoint import read_flax_msgpack, save_checkpoint

    cfg = default_config()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        shutil.copy(CKPT, tmp)
        state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device)
        trainer = Trainer(cfg, state, log_dir=tmp)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            epoch = trainer.resume()
        resume_ms = (time.perf_counter() - t0) * 1e3
        adam_steps = {float(state.optimizer.state[p]["step"]) for p in state.model.parameters()}
        lr, want_lr = state.schedule(state.step), make_lr_schedule(cfg.base_lr, cfg.lr_schedule, 512)(41472)
        checks = {
            f"resume() -> {epoch}, prints {buf.getvalue().strip()!r}": epoch == 81
            and "resumed from epoch 81" in buf.getvalue(),
            f"state.step {state.step}": state.step == 41472,
            f"Adam's step on every parameter {sorted(adam_steps)}": adam_steps == {41472.0},
            f"rate {lr} == make_lr_schedule's {want_lr}": lr == want_lr,
        }
        batch = next(batch_scenes(iter(synthetic_scenes(SEED, cfg, 8)), 8, cfg.max_gt_boxes))
        trainer.train_epoch([batch], metrics_every=1)
        path = save_checkpoint(tmp, state, 82)
        tree = read_flax_msgpack(path)
        counts = (int(tree["step"]), int(tree["opt_state"]["1"]["count"]), int(tree["opt_state"]["2"]["count"]))
        checks[f"step and both counts {counts}"] = counts == (41473,) * 3
        # the card's state, copied to the host leaf by leaf, against the file
        differ = []

        def check_leaf(flax_tree, path, t):
            leaf = flax_tree
            for k in path.split("/"):
                leaf = leaf[k]
            host = t.detach().cpu().numpy()
            host = np.ascontiguousarray(host.T if path.endswith("/kernel") else host)
            if leaf.dtype != np.float32 or leaf.shape != host.shape or leaf.tobytes() != host.tobytes():
                differ.append(path)

        adam = tree["opt_state"]["1"]
        for name, p in state.model.named_parameters():
            path = flax_param_path(name, state.model)
            check_leaf(tree["params"], path, p)
            check_leaf(adam["mu"], path, state.optimizer.state[p]["exp_avg"])
            check_leaf(adam["nu"], path, state.optimizer.state[p]["exp_avg_sq"])
        for name, b in state.model.named_buffers():
            mod, leaf = name.rsplit(".", 1)
            stat = {"running_mean": "mean", "running_var": "var"}[leaf]
            check_leaf(tree["batch_stats"], "/".join(mod.split(".") + [stat]), b)
        n = 3 * len(list(state.model.parameters())) + len(list(state.model.buffers()))
        checks[f"{n} leaves (params, moments, statistics) bit-equal to the card's state: {len(differ)} differ"] = not differ
    print(f"phase 12: the committed JAX checkpoint (epoch 81) resumed on the card in {resume_ms:.1f} ms, "
          f"one B=8 step, saved at 82 and read back")
    for name, ok in checks.items():
        print(f"  {name}: {'ok' if ok else 'FAIL'}")
    if not all(checks.values()):
        raise AssertionError(f"resume of the JAX checkpoint; differing leaves {differ[:5]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no GPU to run on", file=sys.stderr)
        return 1
    try:
        from votenet_tpu_torch.config import default_config
        from votenet_tpu_torch.data.synthetic import synthetic_scenes
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
    f32_bound = [0.0]  # samlp's f32 CUDA-core bound over the B=8 shapes
    variants = ("samlp_bf16", "ballquery_emit_xyz", "fps_noscalar")
    stats = {k: {"err": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "ops_ms": 0.0, "bytes_ms": 0.0,
                 "bound_ms": 0.0} for k in ("fps", "ballquery", "scatter", "samlp", "scatter_fast_bf16") + variants}
    production_ms = dict.fromkeys(variants, 0.0)  # phases 16-18: the production kernels' sums beside

    def report(kernel, layer, B, shape, equal, err, k_ms, p_ms, bound, l_ms=None, total=True):
        st = stats[kernel]
        st["err"] = max(st["err"], err)
        ops_ms, bytes_ms = bound
        if B == 8 and total:  # per-forward (or per-step) sums at the B=8 batch
            st["ms"] += k_ms
            st["plain_ms"] += p_ms
            st["ops_ms"] += ops_ms
            st["bytes_ms"] += bytes_ms
            st["bound_ms"] += max(ops_ms, bytes_ms)
            if l_ms is not None:
                st["library_ms"] = (st["library_ms"] or 0.0) + l_ms
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        lib = f"{l_ms * 1e3:>10.1f}" if l_ms is not None else f"{'-':>10}"
        print(f"  {kernel:<10} {layer:<9} {B:>2} {shape:<30} {str(equal):<6} {k_ms * 1e3:>10.1f} "
              f"{p_ms * 1e3:>11.1f} {lib} {max(ops_ms, bytes_ms) * 1e3:>9.1f} {by:<10}")
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
    if "--kernel-times" in sys.argv[1:]:  # phases 1-3, 9 and 16-18's kernels: to set beside another checkout's
        from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
        from votenet_tpu_torch.ops.cuda import fps as fps_mod
        from votenet_tpu_torch.ops.cuda import samlp as samlp_mod

        state_dict = run("read checkpoint", trained_state_dict)
        if state_dict is not None:
            run("samlp kernel", lambda: phase_samlp(cfg, scenes, state_dict, report, f32_bound))
            if hasattr(samlp_mod.fused_sa_mlp_pool_cuda, "bf16"):  # a checkout with the variants
                run("samlp bf16 kernel", lambda: phase_samlp_bf16(cfg, scenes, state_dict, report, production_ms))
        if hasattr(bq_mod, "query_ball_point_emit_xyz_cuda"):
            run("ball query emit-xyz", lambda: phase_bq_emit(cfg, scenes, report, production_ms))
        if hasattr(fps_mod, "fps_rowwise_noscalar_cuda"):
            run("fps noscalar", lambda: phase_fps_noscalar(cfg, scenes, report, production_ms))
        print(json.dumps({"kernel_times": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"]}
                                           for k, v in stats.items() if k != "scatter"},
                          "production_ms": production_ms, "failed": failed}))
        print(card)
        return 1 if failed else 0
    predictor = run("predictor", lambda: VoteNetPredictor(
        cfg, device="cuda", batch_size=8, generator=torch.Generator().manual_seed(SEED)))
    launches = None
    if predictor is not None:
        run("calibrate head", lambda: calibrate_head(predictor, scenes))
        launches = run("serve", lambda: phase_serve(cfg, scenes, predictor))
        run("cpu parity", lambda: phase_cpu_parity(cfg, scenes, predictor))
        del predictor
    run("scatter kernel", lambda: phase_scatter(cfg, scenes, report))
    bare_step_ms = []
    train_launches = run("train", lambda: phase_train(cfg, scenes, profile="--profile" in sys.argv[1:],
                                                      step_ms=bare_step_ms))
    run("train cpu parity", lambda: phase_train_cpu_parity(cfg, scenes))
    state_dict = run("read checkpoint", trained_state_dict)
    eval_launches = None
    f32_maps = {}
    if state_dict is not None:
        run("samlp kernel", lambda: phase_samlp(cfg, scenes, state_dict, report, f32_bound))
        eval_launches = run("eval", lambda: phase_eval(cfg, state_dict, profile="--profile" in sys.argv[1:],
                                                       maps=f32_maps))
    fit_launches = run("fit", lambda: phase_fit(bare_step_ms))
    run("resume the JAX checkpoint", phase_resume_jax_checkpoint)
    run("scatter kernel, fast_bf16", lambda: phase_scatter_fast(cfg, scenes, report))
    paths = {}  # path -> its launches by kernel, each read after the path ran from counts set to 0
    if state_dict is not None and f32_maps:
        paths.update(run("bf16 and mixed serving and eval", lambda: phase_precision(
            cfg, scenes, state_dict, f32_maps, profile="--profile" in sys.argv[1:])) or {})
    paths.update(run("bf16 and mixed training", lambda: phase_precision_train(
        scenes, bare_step_ms, profile="--profile" in sys.argv[1:])) or {})
    paths["fit_throughput"] = run("fit, throughput preset", lambda: phase_fit(
        bare_step_ms, preset="throughput", label="phase 15 (run_train --preset=throughput)"))
    # phases 16-18: the kernel variants, each on its own path, counts from 0
    if state_dict is not None:
        run("samlp bf16 kernel", lambda: phase_samlp_bf16(cfg, scenes, state_dict, report, production_ms))
        if f32_maps:
            paths.update({f"eval_samlp_bf16_{mode}": counts for mode, counts in (run(
                "eval, samlp bf16", lambda: phase_eval_samlp_bf16(cfg, state_dict, f32_maps)) or {}).items()})
    emit_launches = run("ball query emit-xyz", lambda: phase_bq_emit(cfg, scenes, report, production_ms))
    noscalar_launches = run("fps noscalar", lambda: phase_fps_noscalar(cfg, scenes, report, production_ms))

    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    def measured(name):
        st = stats[name]
        return {
            "max_abs_err": st["err"], "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
            "bound_by": "operations" if st["ops_ms"] >= st["bytes_ms"] else "bytes",
            "library_ms": st["library_ms"],
        }

    def path_launches(kernel):
        return {path: counts[kernel] for path, counts in paths.items() if counts and kernel in counts}

    # launches: the training path's count (phase 7, 3 steps); the serving
    # path's (phase 4, 6 forwards) and the eval path's (phase 10, samlp on,
    # 2 forwards) stand beside it for FPS and the ball query; samlp's is the
    # eval path's; launches_fit: run_train's (phase 11, 6 steps and 1 eval
    # forward); launches_paths: the paths of phases 14-15 (bf16 and mixed
    # serving, eval and training; run_train --preset=throughput). The fast
    # scatter's launches: phase 15's bf16 training in the throughput preset.
    kernels = [
        {
            "name": "fps", "route": "cuda", "source": "votenet_tpu_torch/csrc/fps.cu",
            "replaces": "votenet_tpu/ops/pallas/fps.py:47",
            "also_replaces": "votenet_tpu/ops/pallas/fps.py:79",
            "launches": train_launches["fps"], "launches_serve": launches["fps"],
            "launches_eval": eval_launches["on"]["fps"], "launches_fit": fit_launches["fps"],
            "launches_paths": path_launches("fps"), **measured("fps"), "tolerance": 0,
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
        {
            "name": "ballquery", "route": "cuda", "source": "votenet_tpu_torch/csrc/ballquery.cu",
            "replaces": "votenet_tpu/ops/pallas/ballquery.py:71",
            "launches": train_launches["ballquery"], "launches_serve": launches["ballquery"],
            "launches_eval": eval_launches["on"]["ballquery"], "launches_fit": fit_launches["ballquery"],
            "launches_paths": path_launches("ballquery"), **measured("ballquery"), "tolerance": 0,
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
        {
            "name": "scatter", "route": "cuda", "source": "votenet_tpu_torch/csrc/scatter.cu",
            "replaces": "votenet_tpu/ops/pallas/scatter.py:43",
            "launches": train_launches["scatter"], "launches_fit": fit_launches["scatter"],
            "launches_paths": path_launches("scatter"), **measured("scatter"), "tolerance": 0,
            "tolerance_vs_card_plain": f"{SCATTER_TOL} of scale",
            "ms_is": "sum over the 4 training-step shapes at B=8",
        },
        {
            "name": "scatter_fast_bf16", "route": "cuda", "source": "votenet_tpu_torch/csrc/scatter.cu",
            "replaces": "votenet_tpu/ops/pallas/scatter.py:43", "variant": "passes=1 (scatter_precision=fast_bf16)",
            "launches": paths["train_bf16"]["scatter_fast_bf16"],
            "launches_fit": paths["fit_throughput"]["scatter_fast_bf16"],
            "launches_paths": path_launches("scatter_fast_bf16"), **measured("scatter_fast_bf16"), "tolerance": 0,
            "tolerance_vs_card_plain": f"{SCATTER_TOL} of scale",
            "ms_is": "sum over the 4 training-step shapes at B=8",
        },
        {
            "name": "samlp", "route": "cuda", "source": "votenet_tpu_torch/csrc/samlp.cu",
            "replaces": "votenet_tpu/ops/pallas/samlp.py:78",
            "launches": eval_launches["on"]["samlp"], "launches_fit": fit_launches["samlp"],
            "launches_paths": path_launches("samlp"), **measured("samlp"), "bound_f32_ms": f32_bound[0], "tolerance": f"{SAMLP_TOL} of scale",
            "ms_is": "sum over the 5 eval-forward shapes at B=8",
        },
        # the variants: launches on each phase's own path (phase 16's eval,
        # samlp on; phases 17-18's checks); production_ms is the production
        # kernel's sum over the same shapes in this process (phase 17: the
        # ball query + group_point, whose gather alone is library_ms)
        {
            "name": "samlp_bf16", "route": "cuda", "source": "votenet_tpu_torch/csrc/samlp.cu",
            "replaces": "votenet_tpu/ops/pallas/samlp.py:78", "variant": 'precision="bf16" (samlp.py:87-89)',
            "launches": paths["eval_samlp_bf16_on"]["samlp_bf16"], **measured("samlp_bf16"),
            "production_ms": production_ms["samlp_bf16"], "tolerance": f"{SAMLP_BF16_TOL} of scale",
            "ms_is": "sum over the 5 eval-forward shapes at B=8",
        },
        {
            "name": "ballquery_emit_xyz", "route": "cuda", "source": "votenet_tpu_torch/csrc/ballquery.cu",
            "replaces": "benchmarks/bq_emit_xyz_proto.py:44", "variant": "also writes group_point(xyz, idx)",
            "launches": emit_launches, **measured("ballquery_emit_xyz"),
            "production_ms": production_ms["ballquery_emit_xyz"], "tolerance": 0,
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
        {
            "name": "fps_noscalar", "route": "cuda", "source": "votenet_tpu_torch/csrc/fps.cu",
            "replaces": "benchmarks/fps_noscalar_proto.py:47", "variant": "(value, index) candidates, masked-sum coordinates",
            "launches": noscalar_launches, **measured("fps_noscalar"), "production_ms": production_ms["fps_noscalar"],
            "tolerance": 0, "ms_is": "sum over the 5 main-path shapes at B=8",
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
