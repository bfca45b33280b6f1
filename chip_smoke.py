#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's serving, training and evaluation
paths on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of the repository
    python3 chip_smoke.py --profile  # also: torch.profiler over 3 training steps and one eval pass, each mode
    python3 chip_smoke.py --kernel-times  # phases 1-3, 32, 9, 16-18, 23, 31, 22's and 26's kernels alone (no final line)
    python3 chip_smoke.py --head-times  # the detection head's times alone, public names only (no final line)
    python3 chip_smoke.py --multi-device  # phases 1-2 and 19-21 alone (no final line)
    python3 chip_smoke.py --e2e-times  # serving, training and eval times alone, public names only (no final line)
    python3 chip_smoke.py --bn-library  # batch norm's K1 and K3 beside their library calls alone (no final line)
    python3 chip_smoke.py --bn  # phase 32 alone (no final line)
    python3 chip_smoke.py --sass  # SASS instructions an element of the batch-norm pool kernels' hot loops
    python3 chip_smoke.py --outputs PATH  # serving, training-step and eval outputs saved for --compare-outputs
    python3 chip_smoke.py --compare-outputs A B  # two checkouts' --outputs files: bit-equal, or each gradient's gap

``--kernel-times`` also runs from a copy of this file placed at the root of
another checkout of the port (an earlier commit's archive), so that both
commits' kernels are timed by the same code in one call: phase 3 then skips
the ball query's route rows where that checkout has one route, and phases
16-18, 23 and 31, 22 and 26 where it lacks the kernel (or, for the last
three, this file's decode kernel), and phase 32 where it lacks the
batch-norm kernels. ``--head-times`` runs from such a copy
too: it times the decode, the IoU matrix, ``ops.nms3d`` and
``predict_boxes`` through names every checkout since the NMS kernel has;
so does ``--e2e-times`` (B=8 serving requests, B=1 ``detect()``, B=8
training steps in f32, bf16 and mixed with their peak memory and profiles,
the eval with samlp off and on), through names every checkout with the
precision presets has, with each B=8 training step's and serving forward's
device launches (torch.profiler) and host ms until the call returns; and
``--bn-library``, ``--bn``, ``--sass`` and ``--outputs``, through names every
checkout with the batch-norm kernels has (phase 32's per-channel end and
epilogue gates only where the checkout has them).

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
19. Data parallelism at world size 1: a one-rank NCCL process group in this
   process; one full-width B=8 step's losses, gradients and batch
   statistics through the distributed path (synced batch norm, the loss's
   global denominators, the gradient all-reduce) bit-equal to the plain
   path's (both under PyTorch's deterministic algorithms); both whole steps
   timed in turns, 20 each, and the difference of their medians printed
   beside the plain step's interquartile range (unresolved when inside
   it): what the data-parallel machinery costs on one card. The distributed step launches FPS 5, the
   ball query 5 and the scatter 4 times, and each batch-norm site K1 + K2
   (K2 running the statistics' end from the group's sums) and K3 + K4;
   the device launches of one step of each path (torch.profiler) and the
   statistics' end kernels among them (none: a checkout that has the
   end's own kernel counts its launches).
20. Two ranks sharing the card over gloo (NCCL refuses two ranks on one
   device), spawned processes: dp=2, B=8 (4 rows a rank) against this
   process's step on the same 8 scenes: the losses within REL_TOL of scale,
   every gradient leaf before the clip within GRAD_TOL norm-wise (the
   proposal layer left out where a proposal slot flips between the two
   runs' votes, as phase 8), the running statistics within REL_TOL of
   scale, each rank's step launching FPS 5, the ball query 5 and the
   scatter 4 times, and both ranks' ``params_l2`` after the step
   bit-equal. The step's ms are two ranks sharing one card, not a
   data-parallel rate.
21. sp=2 over the same two ranks at B=2, each a 10240-point slab of sa1's
   cloud: the sharded FPS, the centres' gather, the ball query, the grouped
   gather and its gradient bit-equal to the single-device kernels' at sa1's
   shape (the sharded FPS a PyTorch loop with one exchange a step, its us a
   step on the host clock printed; the ball query and the scatter 1 launch
   each); then one
   train-mode forward of the whole model with sa1 sharded, its end points
   within REL_TOL of scale of the single-device forward's (FPS 4 launches:
   sa1's is the loop; the ball query 5).
22. NMS: the greedy kernel (``csrc/nms3d.cu``: its own order and
   candidates from the scores and objectness) on the decoded boxes of phase
   4's seed-0 model and of phase 10's trained checkpoint, B=1 and 8: its
   keep mask equal to the fixpoint's (candidates, ``torch.argsort``, the
   Jacobi loop) on the card and on the CPU on the card's IoU, and on the
   CPU's IoU to the CPU's ``ops.nms3d``; the gates of the device-independent
   head, from the same end points: the decode's outputs (corners included:
   0 floats differ) equal to the CPU's bit for bit, the card's IoU floats
   (the kernel of ``csrc/iou3d.cu``) equal to the CPU's from the CPU's own
   corners, no IoU pair on either side of the threshold between the
   devices, the CPU's mask equal to the card's (0 boxes differ), and every
   output of ``predict_boxes`` equal; ``ops.nms3d`` and ``predict_boxes`` on
   the card under the sync debug mode "error"; device us of the kernel
   (beside its earlier time) and of the plain version. Then decode + NMS
   apart at B=1 and 8: the decode and the IoU matrix (each kernel and its
   eager plain version) and ``predict_boxes`` (device ms), ``predict_boxes``
   through each route (kernel; the decode's plain version; the greedy's),
   the packed fetch and the host decode (host ms); phase 10's eval pass
   (samlp on) and ``detect()`` by route, in turns. Serving (phase 4) and
   eval (phase 10) launch the fused decode + IoU kernel and the greedy once
   a forward each.
23. The ball query's fast_bf16 variant (``bq_precision="fast_bf16"``: the
   TPU semantics of the JAX package's matmul-expansion hit test) at the five
   main-path shapes, B=1 and 8, through both routes: bit-equal to its plain
   version on the card and, at B=1, on the CPU; the slots and counts that
   differ from the exact query; device us beside the exact kernel's. Then
   one B=8 serving forward, phase 10's eval (samlp off and on) and
   ``run_eval --bq_precision=fast_bf16`` under the mode: 5 launches of the
   variant a forward, none of the exact kernel.
24. remat: one full-width B=8 step with and without remat from the same
   weights under deterministic algorithms: losses, gradients and running
   statistics bit-equal; a remat step launches FPS and the ball query 9
   times (sa1-sa4 again in the backward); both steps' ms in turns; peak
   device memory of both at B=8, 32 and 64 (where the plain step runs out
   of memory, remat's alone); then phase 11 with ``--remat=true
   --bq_precision=fast_bf16``.
25. The reference API's other paths, once each on the card against the
   CPU: ``PointNetSAModule``'s poolings, ``group_all``, ``knn``,
   ``use_xyz=False``, ``use_bn=False``, a layer without features, and
   ``PointNetSAModuleMSG``, in eval and train mode (indices equal, floats
   and statistics within REL_TOL of scale); ``knn_point``, ``select_top_k``,
   ``query_ball_point_topk`` and ``prob_sample`` bit-equal.
26. The IoU matrix kernel (``csrc/iou3d.cu``) on phase 22's decoded boxes,
   B=1 and 8: the self-matrix's triangle (the corners given twice, as NMS
   does) equal bit for bit to the full route (a copy as the second
   argument) and (==) to its plain version on the card and on the CPU;
   device us of the triangle (beside its bound and its earlier time), of
   the full route and of the plain version's eager passes.
27. NMS past 1024 boxes a row (N = 1025, 1056, 2048, 4096; B=2; seeded
   boxes in a room grown with N): the greedy kernel's workspace route equal
   to the plain walk and the fixpoint on the card, ``ops.nms3d`` on the card
   (no host sync) to the CPU's; device us of the greedy beside its earlier
   time, ms of the op.
28. ``three_nn_streaming`` against ``three_nn_dense`` at B=8, 20480 ->
   2048 points, and ``query_ball_point_streaming`` and ``_dense`` against
   the ball-query kernel at sa1's shape, B=8: bit-equal; device ms and peak
   memory of each.
29. ``gather_packing="bf16_hilo"``: a full-width B=8 packed step against
   the f32 step from the committed checkpoint's weights within
   PACKING_CARD_LIMITS and PACKING_LIMITS, the same step with ``lo``
   zeroed and with ``lo`` negated outside PACKING_CARD_LIMITS, the card's
   f32 step against the CPU's within PACKING_LIMITS; the packed step's launches
   (the scatter 4, exact: sa2-sa4's bf16 cotangents and the proposal
   layer's f32 one) and both steps' ms in turns; then phase 11 with
   ``--gather_packing=bf16_hilo``.
30. ``run_train --steps_per_dispatch=4`` on phase 11's miniature at B=2 (8
   steps an epoch: metrics fetched at step 8), 2 epochs, against 1, both under
   deterministic algorithms: the checkpoints byte-equal, each run's ms a
   step, the K=4 run's launches.
31. The decode kernel (``csrc/decode.cu``) and the head's fused decode +
   IoU self-matrix kernel (``csrc/iou3d.cu`` ``decode_iou_kernel``) on the
   end points of phase 4's seed-0 model and of phase 10's trained
   checkpoint, B=1 and 8, and (the fused kernel) on seeded random end
   points of phase 27's 1025-4096 proposals at B=2: every decoded output
   equal bit for bit to the decode's plain version on the card and on the
   CPU, every IoU float to the IoU kernel's on the decode kernel's corners
   and to the plain version's on the card (bits) and on the CPU (==: its
   max keeps -0 where the card's gives +0, as for the IoU kernel);
   device us of each kernel, of the two launches the fused one replaces
   (the decode kernel, then the IoU kernel's triangle) and of the plain
   versions' eager passes beside the bounds. It runs before phase 22.
32. Batch norm + ReLU's kernels with the layer around them
   (``csrc/batchnorm.cu``: the sums, the normalisation with the ReLU, the
   backward's sums, the input's cotangent; each reading the dense layer's
   output h and forming x = ``(h - corr) + b`` itself; at an SA layer's
   last width K2's pool variant, the max over the ball's slots and the tie
   counts, and K3 and K4 on the pooled cotangent) against their plain
   versions (``ops/batchnorm.py``) on the card, at every batch-norm site of
   a full-width forward and training step (23, ``bn_sites``, each with its
   prologue and pool) at B=8 and B=1 in f32 and bf16, and at sa1's sites
   at B=64 (8.4M rows) in f32 and bf16, on inputs padded as
   the ball query pads a ball: K2 (the pool's maxima and counts too) and K4
   bit-equal, the sums within BN_SUM_TOL of each channel's sum of |terms|
   and within an f32 ulp of torch's f64 sum of the same terms,
   each kernel's two runs bit-identical; device us of each kernel, its
   plain version, the eager passes it replaces (``eager_ms``: the
   prologue's, and K2 + ``torch.amax`` at a pool) and its stage's own
   PyTorch call on the old inputs (``torch.batch_norm_stats``, ``_elemt``,
   ``_backward_reduce``, ``_backward_elemt`` on x and a full dy; no ReLU,
   no pool), beside the bytes bound, a per-site table of K1-K4 against
   each site's bound, and ``F.batch_norm``'s whole training forward and
   backward beside K1 + K2 and K3 + K4 over a B=8 step's sites. The
   per-channel end is bit-equal to the torch ops it replaces on the same
   sums on the card (K1's and K3's last CTAs, eval's K2 forming its own
   mul; ``bn_apply_group``: K2's end from a data-parallel group's sums, with
   var_raw < 0, a NaN and a zero among them, st, the running statistics and
   y bit-equal to the torch ops and K2 on their mean and mul; an eval
   backward's K3 and K4 from the running statistics bit-equal to K3 and K4
   on the end's torch ops), K4's epilogue (``bn_bwd_apply_sums``: the
   prologue's cotangents) within one ulp of the dtype of torch's f64 sums
   of the same rounded dx plus BN_F64_FLOOR of the sums of |terms| (library
   column: the two torch sums it replaces), and the bf16 pool kernels' sums
   over the 5 pooled sites of a B=8 step are printed against twice their
   bounds. It runs after phase 3. Every other phase's launch checks count
   the kernels too (``bn_launches``: a forward applies 23 times, 5 of them
   pooled, fewer where samlp fuses; a step launches each 23 times, the
   forward two 35 under remat; the launches that took the centred or the
   bias prologue; K4's with the epilogue; a data-parallel step's 23 K2
   launches with the statistics' end).

Output: a JSON line of the kernels, the ``nvidia-smi`` line of the card, and
last ``{"ok": true, "device": {...}}``. In the kernels' line ``ms``,
``plain_ms``, ``library_ms`` and ``bound_ms`` are sums over the B=8 shapes
of a forward (FPS, ball query, samlp) or of a training step (scatter);
``launches`` is the training path's count, ``launches_fit`` phase 11's
(phase 15's for the fast variant), ``launches_paths`` phases 14-16's; the
variants' ``launches`` are their phase's (16's eval, 17's and 18's checks)
and ``production_ms`` the production kernel's sum beside them. The port's
own kernels follow: ``nms3d`` (``launches`` phase 4's serving path, 6
forwards; ``ms`` the greedy of one B=8 forward of the trained checkpoint,
``plain_ms`` its plain version's on the card: the candidates, the argsort
and the fixpoint), ``decode_iou`` (the head's fused decode + IoU
self-matrix: ``launches`` phase 4's, ``ms`` and ``plain_ms`` the kernel
and the decode's and the IoU's plain versions on the trained checkpoint's
B=8 end points, ``replaced_ms`` the two launches it replaces, phase 31),
``iou3d`` and ``decode`` (off the main path since the fused kernel:
``launches`` their phases' checks, 26 and 31; ``ms`` and ``plain_ms`` the
IoU triangle and the decode alone on the same B=8 boxes and end points),
``ballquery_fast_bf16``
(``launches`` phase 23's serving forward; ``production_ms`` the exact
kernel's) and the batch-norm kernels and their pooled variants (``launches`` phase
7's training path, beside serving's, eval's and ``run_train``'s; ``ms``,
``plain_ms``, ``bound_ms``, ``library_ms`` and ``eager_ms`` sums over the
sites of a B=8 step in f32 that take each, phase 32; ``bf16_us`` and
``bf16_bound_us`` of the pool kernels over the bf16 step's pooled sites),
K4 with its epilogue (``bn_bwd_apply_sums``) and K2 with a data-parallel
group's statistics' end (``bn_apply_group``: ``launches`` phase 19's
distributed step).
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
The fast_bf16 ball query: the exact one's (9 operations a test). The NMS
greedy: the IoUs the run's candidates need read (each candidate's with the
boxes after it in the order: a non-candidate's row is not needed), 4 bytes
of score and 8 of objectness in and 1 of keep out a box; one threshold
test an IoU read and one comparison a pair to rank. The IoU matrix:
IOU_PAIR_OPS f32 operations a pair and IOU_BOX_OPS a box (counted from the
kernel's formulation, below), the corners read and the matrix written; the
self-matrix NMS asks for needs N (N + 1) / 2 pairs. The decode: the head's
channels and centres read and its 34 words a proposal written;
DECODE_OPS and 2 a compared score a proposal. Batch norm: the (R, C) input
(and cotangent) read and the output written, the prologue's centre rows
and bias read, at a pool the maxima, counts and pooled cotangent in place
of the full output or cotangent, a few f32 operations an element
(``bn_bounds``): bound by bytes.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import inspect
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


def launch_counts(counters):
    """{name: launches} of kernel wrappers ({} for none)."""
    return {k: c.launches for k, c in counters.items()}


def zero_counts(counters):
    import torch

    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0


def timed_calls(fn, n, counters=None):
    """Each of n calls ``fn(i)`` on the host clock through a device sync:
    [(ms, launches, output)], launches the change of ``counters``' counts
    over the call ({} without counters)."""
    import torch

    counters = counters or {}
    res = []
    for i in range(n):
        c0 = launch_counts(counters)
        t0 = time.perf_counter()
        out = fn(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        c1 = launch_counts(counters)
        res.append((ms, {k: c1[k] - c0[k] for k in c1}, out))
    return res


def serve_times(predictor, scenes, n, counters=None):
    """Serving through public names, after a warm-up (cuBLAS handles, the
    allocator) and with ``counters`` set to 0 after it: n B=8 requests of
    scenes[:8], outputs fetched to the host, then n ``detect()`` calls at
    B=1 on scenes[i], each as :func:`timed_calls` gives it. The one
    measurement of phases 4 and 14 and of ``--e2e-times``."""
    batch = np.stack([s["points"] for s in scenes[:8]])
    predictor(batch)
    predictor.detect(scenes[0]["points"])
    zero_counts(counters or {})
    requests = timed_calls(lambda i: {k: v.cpu() for k, v in predictor(batch).items()}, n, counters)
    detects = timed_calls(lambda i: predictor.detect(scenes[i % len(scenes)]["points"]), n, counters)
    return requests, detects


def phase_serve(cfg, scenes, predictor, label="phase 4"):
    """3 batch requests at B=8 and 3 detect() calls at B=1, counting launches."""
    import torch

    P, NC = cfg.proposal_num, cfg.num_class
    counters = {k: c for k, c in eval_counters().items()
                if k in ("fps", "ballquery", "ballquery_fast_bf16", *HEAD_LAUNCHES, *bn_counters())}
    bq = "ballquery_fast_bf16" if cfg.bq_precision == "fast_bf16" else "ballquery"
    per_forward = ({"fps": 5, "ballquery": 0, "ballquery_fast_bf16": 0, **HEAD_LAUNCHES} | {bq: 5}
                   | bn_launches(cfg, train=False, samlp=cfg.samlp == "on"))
    requests, detects = serve_times(predictor, scenes, 3, counters)
    launches = launch_counts(counters)
    for _, got, _ in requests + detects:
        if got != per_forward:
            raise AssertionError(f"a forward launched {got}, not {per_forward}")
    for _, _, out in requests:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        want = {"bboxes": (8, P, 8, 3), "class_scores": (8, P, NC), "keep": (8, P), "objectness": (8, P, 2)}
        if shapes != want:
            raise AssertionError(f"output shapes {shapes} != {want}")
        for k in ("bboxes", "class_scores", "objectness"):
            if not torch.isfinite(out[k]).all():
                raise AssertionError(f"non-finite {k}")
    for _, _, dets in detects:
        for name, corners, score in dets:
            if corners.shape != (8, 3) or not np.isfinite(corners).all() or not np.isfinite(score):
                raise AssertionError(f"bad detection {name} {corners.shape} {score}")
    batch_s, single_s = [ms / 1e3 for ms, _, _ in requests], [ms / 1e3 for ms, _, _ in detects]
    print(f"{label}: served 3 x B=8 and 3 x B=1: launches {launches} over 6 forwards, {per_forward} each")
    print(f"  B=8 request seconds {batch_s}; scenes/s {[8 / s for s in batch_s]}")
    print(f"  B=1 detect() seconds {single_s}; detections {[len(d) for _, _, d in detects]}")
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


BN_COUNTS = ("bn_stats", "bn_apply", "bn_apply_pool", "bn_bwd_reduce", "bn_bwd_reduce_pooled", "bn_bwd_apply",
             "bn_bwd_apply_pooled", "bn_prologue_centre", "bn_prologue_bias", "bn_bwd_apply_sums", "bn_apply_group")


def bn_counters():
    """The batch-norm site's counts: each kernel's launches over full rows,
    K2's pool variant's and K3's and K4's at a pooled site, the launches
    (of any stage) that took the centred or the bias prologue, K4's launches
    with the epilogue (the prologue's cotangents) and K2's launches that ran
    the statistics' end from a data-parallel group's sums. A checkout
    without the last two counts them 0."""
    from types import SimpleNamespace

    from votenet_tpu_torch.ops.cuda import batchnorm as bn

    none = SimpleNamespace(launches=0)
    return {"bn_stats": bn.bn_stats_cuda, "bn_apply": bn.bn_apply_cuda, "bn_apply_pool": bn.bn_apply_cuda.pool,
            "bn_bwd_reduce": bn.bn_bwd_reduce_cuda, "bn_bwd_reduce_pooled": bn.bn_bwd_reduce_cuda.pooled,
            "bn_bwd_apply": bn.bn_bwd_apply_cuda, "bn_bwd_apply_pooled": bn.bn_bwd_apply_cuda.pooled,
            "bn_prologue_centre": bn.PROLOGUE_LAUNCHES["centre"], "bn_prologue_bias": bn.PROLOGUE_LAUNCHES["bias"],
            "bn_bwd_apply_sums": getattr(bn.bn_bwd_apply_cuda, "sums", none),
            "bn_apply_group": getattr(bn.bn_apply_cuda, "group", none)}


def train_counters():
    from votenet_tpu_torch.ops.cuda.ballquery import query_ball_point_cuda
    from votenet_tpu_torch.ops.cuda.fps import farthest_point_sample_cuda
    from votenet_tpu_torch.ops.cuda.scatter import scatter_add_cuda

    return {"fps": farthest_point_sample_cuda, "ballquery": query_ball_point_cuda,
            "ballquery_fast_bf16": query_ball_point_cuda.fast_bf16, "scatter": scatter_add_cuda,
            "scatter_fast_bf16": scatter_add_cuda.fast_bf16, **bn_counters()}


def bn_launches(cfg, train: bool, samlp: bool = False, backward: bool = True, group: bool = False) -> dict:
    """The batch-norm counts (``bn_counters``) of one forward (eval) or
    training step under ``cfg``, from the layer list (``bn_sites``): 23
    sites at the reference widths. Eval: one apply a site, the pool variant
    at an SA layer's last width, none in an SA layer whose MLP samlp fuses
    (``samlp``: the f32 layers, all five in f32, sa1 and the proposal layer
    under mixed precision, none in bf16). A step: stats and apply a site,
    again for sa1-sa4 under remat (whose backward recomputes them), and both
    backward kernels once a site, pooled at the pools. Every launch at a
    site takes its prologue: the centred one at an SA layer's first width
    (but the split first layers of sa2-sa4 under mixed precision and, in
    training, of sa1-sa4 under ``gather_packing="bf16_hilo"``, which add
    their bias themselves), the bias elsewhere; each backward K4 with a
    dense bias writes the prologue's cotangents (``bn_bwd_apply_sums``).
    ``group`` (a data-parallel group): each training forward's K2 runs the
    statistics' end from the group's sums (``bn_apply_group``; 0 in a
    checkout whose end had a kernel of its own, which this file does not
    count).
    ``backward=False``: a training forward alone (stats and apply)."""
    mixed = cfg.mixed_precision and cfg.compute_dtype == "float32"
    split = {"sa2", "sa3", "sa4"} if mixed else set()
    if train and cfg.gather_packing == "bf16_hilo":  # the backbone's packed gathers (sa1's features are its xyz)
        split = {"sa1", "sa2", "sa3", "sa4"}
    fused = set()
    if samlp and not train and cfg.compute_dtype == "float32":
        fused = {"sa1", "proposal"} if mixed else {"sa1", "sa2", "sa3", "sa4", "proposal"}
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    group_end = group and hasattr(bnc.bn_apply_cuda, "group")
    n = dict.fromkeys(BN_COUNTS, 0)
    for layer, _, _, prologue, pooled in bn_sites(cfg):
        if layer in fused:
            continue
        fwd = 1 + (train and cfg.remat and layer in ("sa1", "sa2", "sa3", "sa4"))
        bwd = int(train and backward)
        if train:
            n["bn_stats"] += fwd
            n["bn_bwd_reduce_pooled" if pooled else "bn_bwd_reduce"] += bwd
            n["bn_bwd_apply_pooled" if pooled else "bn_bwd_apply"] += bwd
        n["bn_apply_pool" if pooled else "bn_apply"] += fwd
        if not (prologue == "centre" and layer in split):
            n[f"bn_prologue_{prologue}"] += (2 * fwd + 2 * bwd) if train else 1
            n["bn_bwd_apply_sums"] += bwd
        n["bn_apply_group"] += fwd if train and group_end else 0
    return n


def step_launches(cfg, group: bool = False) -> dict:
    """The kernel launches of one full-width training step under ``cfg``:
    FPS and the ball query 5 each (9 under remat: sa1-sa4 run again in the
    backward), the ball query on the Config's variant; 4 scatters (sa2-sa4,
    proposal), each in the Config's mode where its cotangent is f32, and
    exact where it is bf16 (mixed precision's sa2-sa4 feature gathers, and
    the packed ones of ``gather_packing="bf16_hilo"``); the batch-norm
    kernels as :func:`bn_launches` counts them (``group``: a data-parallel
    step's)."""
    mixed = cfg.mixed_precision and cfg.compute_dtype == "float32"
    fast = cfg.scatter_precision == "fast_bf16"
    n_f32 = 1 if mixed or cfg.gather_packing == "bf16_hilo" else 4
    n_bq = 9 if cfg.remat else 5
    bq_fast = cfg.bq_precision == "fast_bf16"
    return {"fps": n_bq, "ballquery": 0 if bq_fast else n_bq, "ballquery_fast_bf16": n_bq if bq_fast else 0,
            "scatter": 4 - n_f32 * fast, "scatter_fast_bf16": n_f32 * fast,
            **bn_launches(cfg, train=True, group=group)}


def train_times(cfg, scenes, n, counters=None):
    """``Trainer.train_epoch`` through public names: a full-width state from
    seed SEED, one warm-up step (cuBLAS handles, the allocator), then n
    steps on one B=8 batch of scenes[:8], ``counters`` set to 0 between.
    Returns (trainer, batch, [(step ms, launches)], peak GiB of the warm-up
    and the steps, the parameter leaves the n steps left unmoved). The one
    measurement of phases 7 and 15 and of ``--e2e-times``."""
    import torch

    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.train import Trainer, create_train_state

    counters = counters or {}
    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device="cuda")
    trainer = Trainer(cfg, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()  # the steps' peak, not an earlier phase's
    trainer.train_epoch([batch], metrics_every=1)
    before = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    zero_counts(counters)
    marks = []

    def timed():
        for _ in range(n):
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), launch_counts(counters)))
            yield batch
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), launch_counts(counters)))

    trainer.train_epoch(timed(), metrics_every=1)
    steps = [((t1 - t0) * 1e3, {k: c1[k] - c0[k] for k in c0}) for (t0, c0), (t1, c1) in zip(marks, marks[1:])]
    still = [k for k, p in state.model.named_parameters() if torch.equal(p, before[k])]
    return trainer, batch, steps, torch.cuda.max_memory_allocated() / 2**30, still


def phase_train(cfg, scenes, profile=False, step_ms=None, label="phase 7"):
    """Trainer.train_epoch: 3 full-width steps at B=8 after one warm-up
    (their ms appended to ``step_ms`` where given), each launching exactly
    ``step_launches(cfg)``."""
    counters = train_counters()
    trainer, batch, steps, peak_gib, still = train_times(cfg, scenes, 3, counters)
    launches = launch_counts(counters)
    want = step_launches(cfg)
    for i, (_, d) in enumerate(steps):
        if d != want:
            raise AssertionError(f"train step {i} launched {d}, not {want}")
    losses = {k: list(v) for k, v in trainer.logger.moving.buffers.items()}
    if not all(np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"non-finite metrics {losses}")
    if still:
        raise AssertionError(f"parameters that did not move in 3 steps: {still}")
    n_leaves = len(list(trainer.state.model.parameters()))
    print(f"{label}: Trainer.train_epoch, 3 full-width steps at B=8 (after 1 warm-up): launches {launches}, "
          f"per step {steps[0][1]}; all {n_leaves} parameter leaves moved")
    print(f"  step ms {[ms for ms, _ in steps]}; scenes/s {[8e3 / ms for ms, _ in steps]}")
    if step_ms is not None:
        step_ms.extend(ms for ms, _ in steps)
    print(f"  total_cost over the 4 steps {losses['total_cost']}")
    print(f"  peak device memory {peak_gib:.2f} GiB")
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
               else "batchnorm" if any(w in low for w in ("bn_stats_kernel", "bn_apply_", "bn_bwd_"))
               else "gemm" if any(w in low for w in ("gemm", "cutlass", "xmma", "sm90_"))
               else "elementwise" if "elementwise" in low or "reduce_kernel" in low else "other")
        groups[key] = groups.get(key, 0.0) + ms
    print(f"profile ({label}): wall {wall_ms:.1f} ms, kernel time {total:.1f} ms, "
          f"busy share {total / wall_ms:.3f}")
    print("  by group (ms, share of kernel time): " + ", ".join(
        f"{k} {v:.1f} ({v / total:.3f})" for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, count, name in sorted(kernels, reverse=True)[:25]:
        print(f"  {ms:9.2f} ms  x{count:<5} {name[:160]}")


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


# The head's launches a forward (``predict_boxes``): the fused decode + IoU
# self-matrix and the greedy; the decode and IoU kernels alone are off the
# path (``decode_proposals``, ``ops.box3d_iou_matrix``)
HEAD_LAUNCHES = {"nms": 1, "iou3d": 0, "decode": 0, "decode_iou": 1}


def eval_counters():
    """Forward-path counters: the training path's but the scatters, samlp's,
    and the head's (a checkout without the fused head counts it 0)."""
    from types import SimpleNamespace

    from votenet_tpu_torch.ops.cuda import decode as dec
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda
    from votenet_tpu_torch.ops.cuda.samlp import fused_sa_mlp_pool_cuda

    return {**{k: v for k, v in train_counters().items() if not k.startswith("scatter")},
            "samlp": fused_sa_mlp_pool_cuda, "samlp_bf16": fused_sa_mlp_pool_cuda.bf16, "nms": nms3d_greedy_cuda,
            "iou3d": box3d_iou_matrix_cuda, "decode": dec.decode_proposals_cuda,
            "decode_iou": getattr(dec, "decode_iou_cuda", SimpleNamespace(launches=0))}


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


def eval_passes(ev, predict, cache, n, counters=None):
    """``ev.predictions_for_scenes(predict, cache)`` through public names:
    one warm-up pass, ``counters`` set to 0, then n passes on the host clock
    through a device sync. Returns (seconds of each pass, each forward's
    launches, the last pass's predictions). The one measurement of phases
    10, 14 and 16 and of ``--e2e-times``."""
    import torch

    counters = counters or {}
    per_forward = []

    def counted(points):
        c0 = launch_counts(counters)
        out = predict(points)
        c1 = launch_counts(counters)
        per_forward.append({k: c1[k] - c0[k] for k in c1})
        return out

    ev.predictions_for_scenes(predict, cache)
    zero_counts(counters)
    seconds, pred = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        pred = ev.predictions_for_scenes(counted, cache)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds, per_forward, pred


def phase_eval(cfg, state_dict, profile=False, maps=None, samlp_per_forward=5, label="phase 10", beside=None,
               samlp_counter="samlp"):
    """Evaluator over 16 scenes on the card, samlp off then on, each forward
    launching fps 5, the ball query 5 (on the Config's variant), the decode,
    the IoU and nms 1 each, and
    samlp 0 (off) or ``samlp_per_forward``
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
        ev = Evaluator(cfg, gt_all, batch_size=8)
        seconds, per_forward, pred = eval_passes(ev, predict, cache, 3, counters)
        launches = launch_counts(counters)
        bq = "ballquery_fast_bf16" if cfg.bq_precision == "fast_bf16" else "ballquery"
        want = {"fps": 5, "ballquery": 0, "ballquery_fast_bf16": 0, "samlp": 0, "samlp_bf16": 0, **HEAD_LAUNCHES}
        want[bq] = 5
        want[samlp_counter] = samlp_per_forward if mode == "on" else 0
        want |= bn_launches(cfg, train=False, samlp=mode == "on")
        for i, d in enumerate(per_forward):
            if d != want:
                raise AssertionError(f"samlp={mode}: forward {i} launched {d}, not {want}")
        scores = {iou: Evaluator(cfg, gt_all, ovthresh=iou, batch_size=8).score(pred) for iou in (0.25, 0.5)}
        runs[mode] = (pred, scores, launches)
        if maps is not None:
            maps[mode] = {iou: r["mAP"] for iou, r in scores.items()}
        checks[f"samlp={mode}: mAP finite"] = all(np.isfinite(r["mAP"]) for r in scores.values())
        n_det = sum(len(v) for v in pred.values())
        print(f"  samlp={mode}: launches {launches} over 3 passes' {len(per_forward)} forwards, per forward "
              f"{per_forward[0]}; {n_det} detections; seconds {[round(s, 6) for s in seconds]}, "
              f"eval scenes/s {[round(EVAL_SCENES / s, 2) for s in seconds]}")
        for iou, r in scores.items():
            aps = ", ".join(f"{c} {r['ap'][c]:.4f}" for c in sorted(r["ap"]))
            f32 = f" (f32 {beside[mode][iou]:.4f})" if beside else ""
            print(f"    mAP@{iou} {r['mAP']:.4f}{f32}: {aps}")
        if profile:
            profile_device(lambda: ev.predictions_for_scenes(predict, cache),
                           f"eval, {label.strip()}, samlp={mode}, {EVAL_SCENES} scenes at B=8")
        del model
    if samlp_per_forward != 5 or samlp_counter != "samlp" or cfg.bq_precision != "exact":
        # a bf16 mode: its GPU-vs-CPU check is phase 14's or 16's; fast_bf16's ball query phase 23's
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


def phase_fit(bare_step_ms, preset="full", n_points=24000, device="cuda", label="phase 11", extra=()):
    """run_train on a generated miniature: 2 epochs with the eval at epoch 2,
    then a resume that trains epoch 3; exact launch counts. ``extra``:
    more flags (Config overrides) for both runs."""
    from votenet_tpu_torch import run_train
    from votenet_tpu_torch.config import config_from_args, default_config, throughput_config, tiny_config
    from votenet_tpu_torch.data.mini_fixture import generate_mini_sunrgbd
    from votenet_tpu_torch.utils.checkpoint import all_checkpoint_steps, checkpoint_path, read_flax_msgpack

    counters = eval_counters() | {k: train_counters()[k] for k in ("scatter", "scatter_fast_bf16")}
    run_cfg = config_from_args(list(extra), base={"tiny": tiny_config, "throughput": throughput_config,
                                                  "full": default_config}[preset]())
    per_step = step_launches(run_cfg)
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
                "--val_idx_range={},{}".format(*MINI_VAL_IDS), *extra]
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
    bq = "ballquery_fast_bf16" if run_cfg.bq_precision == "fast_bf16" else "ballquery"
    want = {k: per_step[k] * steps for k in ("fps", "ballquery", "ballquery_fast_bf16", "scatter",
                                             "scatter_fast_bf16")}
    want = want | {"fps": want["fps"] + 5 * fwd, bq: want[bq] + 5 * fwd, "samlp": 5 * fwd, "samlp_bf16": 0,
                   **{k: n * fwd for k, n in HEAD_LAUNCHES.items()}}
    want |= {k: per_step[k] * steps + n * fwd for k, n in bn_launches(run_cfg, train=False, samlp=True).items()}
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


# ---------------------------------------------------- phases 19-21: multi-device

def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _stats(model) -> dict:
    return {n: b.detach().clone() for n, b in model.named_buffers()}


def phase_dp_world1(cfg, scenes, device="cuda", backend="nccl", profile_launches=False):
    """Phase 19: a one-rank process group (NCCL on the card) in this process.
    One B=8 step's gradients, batch statistics and losses through the
    distributed path (``forward_backward`` with the mesh's data group, then
    the gradient all-reduce) bit-equal to the plain path's, both with
    PyTorch's deterministic algorithms (index_add_ and gather's backward sum
    atomically otherwise, so that two runs of one path differ by ulps); then
    both whole steps timed in turns without them, 20 each; with
    ``profile_launches`` (this script's own runs: in the card tests'
    process, torch.profiler sessions of later tests recorded no device
    events once this phase had profiled, which the phase followed by one
    session alone did not reproduce) each path's device launches of one
    step.
    Returns the distributed step's launches."""
    import torch
    import torch.distributed as dist

    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.parallel import comm, make_mesh
    from votenet_tpu_torch.parallel.launch import free_port, init_process_group
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step

    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    init_process_group(backend, 1, 0, free_port(), 300)
    try:
        mesh = make_mesh()
        group = mesh.group("data")
        states = {k: create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device)
                  for k in ("plain", "dist")}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out = {}
            for k, g in (("plain", None), ("dist", group)):
                losses = forward_backward(states[k].model, batch, cfg, group=g)
                comm.all_reduce_((p.grad for p in states[k].model.parameters()), g)
                out[k] = (losses, _grads(states[k].model), _stats(states[k].model))
        finally:
            torch.use_deterministic_algorithms(False)
        (lp, gp, sp_), (ld, gd, sd) = out["plain"], out["dist"]
        checks = {
            "losses bit-equal": all(torch.equal(a, b) for a, b in zip(lp, ld)),
            f"{len(gp)} gradient leaves bit-equal": all(torch.equal(gp[n], gd[n]) for n in gp),
            f"{len(sp_)} batch-norm statistics bit-equal": all(torch.equal(sp_[n], sd[n]) for n in sp_),
        }
        steps = {"plain": make_train_step(cfg), "dist": make_train_step(cfg, group=group)}
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        for k in steps:  # warm-up
            steps[k](states[k], batch)
        counters = train_counters()
        sync()
        for c in counters.values():
            c.launches = 0
        steps["dist"](states["dist"], batch)
        sync()
        launches = {n: c.launches for n, c in counters.items()}
        ms = {"plain": [], "dist": []}
        host_ms = {"plain": [], "dist": []}  # until the step returns, before the sync: the host's share
        gc_ms = {"plain": 0.0, "dist": 0.0}  # Python's garbage collector inside the timed steps
        side, gc_t0 = [None], [0.0]

        def on_gc(event, info):
            if side[0] is not None:
                if event == "start":
                    gc_t0[0] = time.perf_counter()
                else:
                    gc_ms[side[0]] += (time.perf_counter() - gc_t0[0]) * 1e3

        gc.callbacks.append(on_gc)
        try:
            for k in ["plain", "dist", "dist", "plain"] * 10:
                side[0] = k
                t0 = time.perf_counter()
                steps[k](states[k], batch)
                host_ms[k].append((time.perf_counter() - t0) * 1e3)
                sync()
                ms[k].append((time.perf_counter() - t0) * 1e3)
                side[0] = None
        finally:
            gc.callbacks.remove(on_gc)
        want = step_launches(cfg, group=True)
        checks[f"one distributed step launches {want}"] = launches == want
        if profile_launches:  # every device launch of one step of each path (torch.profiler)
            from votenet_tpu_torch.ops.cuda import batchnorm as bnc

            names = {k: device_kernel_names(lambda k=k: steps[k](states[k], batch)) for k in steps}
            ends = sum("bn_channels" in n for n in names["dist"])
            print(f"  device launches of one step: plain {len(names['plain'])}, distributed {len(names['dist'])}; "
                  f"of the distributed step's, {ends} of the statistics' end's own kernel")
            if not hasattr(bnc, "bn_channels_cuda"):  # K2 runs the group's end
                checks["the distributed step launches no kernel of the statistics' end's own"] = ends == 0
        diff = float(np.median(ms["dist"]) - np.median(ms["plain"]))
        q1, q3 = np.percentile(ms["plain"], [25, 75])
        spread = float(q3 - q1)
        print(f"phase 19: a one-rank {backend} process group, one B=8 step through the distributed path "
              f"beside the plain path, the same weights and batch, {len(ms['plain'])} steps each in turns")
        for k in ms:
            print(f"  {k} step ms: median {float(np.median(ms[k])):.3f}, range {min(ms[k]):.3f}-{max(ms[k]):.3f}, "
                  f"all {[round(v, 3) for v in ms[k]]}; host until return, median "
                  f"{float(np.median(host_ms[k])):.3f}; Python GC {gc_ms[k]:.3f} in all")
        print(f"  median difference {diff:.3f} ms (the data-parallel machinery on one card: batch-norm and loss "
              f"all-reduces, the gradient all-reduce); the plain step's interquartile range {spread:.3f} ms: "
              f"{'resolved' if abs(diff) > spread else 'unresolved, inside the plain step spread'}")
        return finish(checks, "distributed path at world size 1", launches)
    finally:
        dist.destroy_process_group()


def _two_rank_phases(rank, world, preset, device):
    """Phases 20-21 on one of two ranks sharing the card over gloo (NCCL
    refuses two ranks on one device). Returns this rank's results."""
    import torch

    from votenet_tpu_torch.config import default_config, tiny_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.models.pointnet2 import batch_norm_group
    from votenet_tpu_torch.parallel import comm, make_mesh, point_sharding, shard_batch
    from votenet_tpu_torch.parallel import point_sharded as sp
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step, params_l2

    cfg = {"full": default_config, "tiny": tiny_config}[preset]()
    scenes = synthetic_scenes(SEED, cfg, 8)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    counters = train_counters()

    def zero():
        for c in counters.values():
            c.launches = 0

    def counts():
        return {k: c.launches for k, c in counters.items()}

    out = {}
    # phase 20: dp=2, B=8 global, 4 rows a rank
    mesh = make_mesh()
    group = mesh.group("data")
    local = shard_batch(next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes)), mesh)
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device)
    losses = forward_backward(state.model, local, cfg, group=group)
    comm.all_reduce_((p.grad for p in state.model.parameters()), group)
    reduced = comm.all_reduce(torch.stack([v.float() for v in losses]), group)
    out["losses"] = dict(zip(losses._fields, reduced.cpu().unbind()))
    out["grads"] = {n: g.cpu() for n, g in _grads(state.model).items()}
    out["stats"] = {n: b.cpu() for n, b in _stats(state.model).items()}
    with torch.no_grad(), batch_norm_group(state.model, group):  # the step's forward again, for the votes
        out["votes_xyz"] = state.model(torch.as_tensor(local["points"]).to(device))["votes_xyz"].cpu()
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device)
    step = make_train_step(cfg, group=group)
    step(state, local)  # warm-up
    step_ms = []
    for i in range(3):
        sync()
        if i == 0:
            zero()
        t0 = time.perf_counter()
        step(state, local)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["dp_launches"] = counts()
    out["step_ms"] = step_ms
    out["params_l2"] = params_l2(state.model)
    del state

    # phase 21: sp=2 at B=2, each rank a 10240-point slab of sa1's cloud
    mesh = make_mesh(("data", "points"), (1, 2))
    pg = mesh.group("points")
    xyz = torch.as_tensor(np.stack([s["points"] for s in scenes[:2]])).to(device)
    slab = point_sharding(xyz, pg)
    npoint, radius, nsample = cfg.sa_npoints[0], cfg.sa_radii[0], cfg.sa_nsamples[0]
    zero()
    sp.farthest_point_sample_sharded(16, slab, pg)  # warm-up
    sync()
    t0 = time.perf_counter()
    fps_idx = sp.farthest_point_sample_sharded(npoint, slab, pg)
    sync()
    out["fps_us_step"] = (time.perf_counter() - t0) * 1e6 / (npoint - 1)
    new_xyz = sp.gather_point_sharded(slab, fps_idx, pg)
    idx, cnt = sp.query_ball_point_sharded(radius, nsample, slab, new_xyz, pg)
    feats = torch.cat([slab, slab * slab], dim=-1).requires_grad_(True)
    g = sp.group_point_sharded(feats, idx, pg)
    cot = torch.as_tensor(np.random.RandomState(SEED).randn(*g.shape).astype(np.float32)).to(device)
    (g * cot).sum().backward()
    out["sp_ops"] = {"fps": fps_idx.cpu(), "new_xyz": new_xyz.cpu(), "idx": idx.cpu(), "cnt": cnt.cpu(),
                     "group": g.detach().cpu(), "grad": comm.all_gather(feats.grad, pg).cpu()}
    out["sp_ops_launches"] = counts()
    model = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device,
                               sp_mesh=mesh, sp_min_points=min(4096, cfg.point_num)).model.train()
    zero()
    with torch.no_grad():
        ep = model(slab)
    out["sp_forward_launches"] = counts()
    out["sp_forward"] = {k: v.cpu() for k, v in ep.items()}
    return out


def phase_two_ranks(cfg, scenes, preset="full", device="cuda"):
    """Phases 20-21: two ranks on the one card over gloo, spawned processes
    (``parallel.launch.run_ranks``), held against this process's
    single-device runs. Returns {path: launches} of rank 0."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.parallel.launch import run_ranks
    from votenet_tpu_torch.train import create_train_state, forward_backward

    if device == "cuda":
        torch.cuda.empty_cache()  # this process's cached blocks, for the two ranks'
    t0 = time.perf_counter()
    ranks = run_ranks(_two_rank_phases, 2, args=(preset, device), timeout=600, threads=4)
    wall = time.perf_counter() - t0

    # phase 20: dp=2 against one process on the same 8 scenes
    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device)
    losses = forward_backward(state.model, batch, cfg)
    grads, stats = _grads(state.model), _stats(state.model)
    with torch.no_grad():  # the step's forward again, for the votes
        ep = {k: v.cpu() for k, v in state.model(torch.as_tensor(batch["points"]).to(device)).items()}
    votes, dp_votes = ep["votes_xyz"], torch.cat([r["votes_xyz"] for r in ranks])
    fi = ops.farthest_point_sample(cfg.proposal_num, ep["seeds_xyz"])  # seeds come from the input alone

    def ball(v):
        return ops.query_ball_point(cfg.proposal_radius, cfg.proposal_nsample, v, ops.gather_point(v, fi))[0]

    flips = int((ball(votes) != ball(dp_votes)).sum())
    checks = {}
    for r, res in enumerate(ranks):
        for field, v in zip(losses._fields, losses):
            err, tol = scale_err(res["losses"][field], v)
            checks[f"rank {r} {field} err {err:.3g} <= {tol:.3g}"] = err <= tol
        rels = []
        for name, g in grads.items():
            if flips and name.startswith("proposal."):
                continue  # a slot that flipped moves this layer's gradient by O(1)
            a, b = res["grads"][name].double(), g.cpu().double()
            rels.append((float((a - b).norm()) / max(float(b.norm()), 1e-2 * b.numel() ** 0.5), name))
        worst = sorted(rels, reverse=True)[:2]
        checks[f"rank {r} gradients before the clip, {len(rels)} leaves, norm-wise worst "
               f"{[(f'{x:.3g}', n) for x, n in worst]} < {GRAD_TOL}"] = worst[0][0] < GRAD_TOL
        serr = max(scale_err(res["stats"][n], b)[0] / scale_err(res["stats"][n], b)[1] for n, b in stats.items())
        checks[f"rank {r} running statistics within {REL_TOL} of scale (worst {serr:.3g} of it)"] = serr <= 1
        want = step_launches(cfg, group=True)
        checks[f"rank {r} step launches {want}"] = res["dp_launches"] == want
    l2 = [r["params_l2"] for r in ranks]
    checks[f"params_l2 bit-equal across the ranks {l2}"] = l2[0] == l2[1]
    print(f"phase 20: dp=2 over gloo, two ranks sharing one card, B=8 (4 rows a rank) against one process; "
          f"{flips} proposal-slot flips between the votes; spawn and both phases {wall:.1f} s")
    print(f"  step ms (two ranks sharing one card, not a data-parallel rate): rank 0 {ranks[0]['step_ms']}, "
          f"rank 1 {ranks[1]['step_ms']}")
    finish(checks, "dp=2 against one process", None)

    # phase 21: sp=2 ops at sa1's shape and one sp forward, against one device
    xyz = torch.as_tensor(np.stack([s["points"] for s in scenes[:2]])).to(device)
    npoint, radius, nsample = cfg.sa_npoints[0], cfg.sa_radii[0], cfg.sa_nsamples[0]
    fps_idx = ops.farthest_point_sample(npoint, xyz)
    new_xyz = ops.gather_point(xyz, fps_idx)
    idx, cnt = ops.query_ball_point(radius, nsample, xyz, new_xyz)
    feats = torch.cat([xyz, xyz * xyz], dim=-1).requires_grad_(True)
    g = ops.group_point(feats, idx)
    cot = torch.as_tensor(np.random.RandomState(SEED).randn(*g.shape).astype(np.float32)).to(device)
    (g * cot).sum().backward()
    want = {"fps": fps_idx, "new_xyz": new_xyz, "idx": idx, "cnt": cnt, "group": g.detach(), "grad": feats.grad}
    model = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device=device).model.train()
    with torch.no_grad():
        ep = model(xyz)
    checks = {}
    for r, res in enumerate(ranks):
        for k, w in want.items():
            got = res["sp_ops"][k]
            if k == "grad":  # (2 ranks, B, N/2, C) slabs -> (B, N, C)
                got = torch.cat(list(got), dim=1)
            checks[f"rank {r} sharded {k} bit-equal"] = torch.equal(got, w.cpu())
        gaps = {k: scale_err(res["sp_forward"][k], v) for k, v in ep.items()}
        checks[f"rank {r} sp forward end points within {REL_TOL} of scale (max gaps "
               f"{ {k: f'{e:.3g}' for k, (e, _) in gaps.items()} })"] = all(e <= tol for e, tol in gaps.values())
        no_bn = dict.fromkeys(bn_counters(), 0)
        # sa1's FPS: a torch loop; batch norm's training forward, no backward
        want_sp = {"fps": 4, "ballquery": 5, "ballquery_fast_bf16": 0, "scatter": 0, "scatter_fast_bf16": 0,
                   **bn_launches(cfg, train=True, backward=False)}
        checks[f"rank {r} sp forward launches {want_sp}"] = res["sp_forward_launches"] == want_sp
        want_ops = {"fps": 0, "ballquery": 1, "ballquery_fast_bf16": 0, "scatter": 1, "scatter_fast_bf16": 0,
                    **no_bn}
        checks[f"rank {r} sharded ops launches {want_ops}"] = res["sp_ops_launches"] == want_ops
    print(f"phase 21: sp=2 over gloo at B=2, sa1's shape ({cfg.point_num} -> {npoint} points, r={radius}, "
          f"K={nsample}), each rank a {cfg.point_num // 2}-point slab, against the single-device kernels")
    print(f"  sharded FPS {ranks[0]['fps_us_step']:.1f} us a step (rank 0; rank 1 "
          f"{ranks[1]['fps_us_step']:.1f}; host clock): one exchange over gloo a step, two ranks sharing one card")
    finish(checks, "sp=2 against one device", None)
    return {"dp2_gloo_step": ranks[0]["dp_launches"], "sp2_ops": ranks[0]["sp_ops_launches"],
            "sp2_forward": ranks[0]["sp_forward_launches"]}


# ---------------------------------------------------------------- phases 22-25


def detection_models(cfg, scenes, state_dict):
    """(trained, cases): the committed checkpoint's VoteNet on the card, and
    the (name, model, scenes) whose decoded boxes phases 22 and 26 take:
    phase 4's seed-0 model (its head shifted as there) on ``scenes`` and the
    trained one on phase 10's eval scenes."""
    import torch

    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.predictor import VoteNetPredictor

    trained = VoteNet(cfg)
    trained.load_state_dict(state_dict)
    trained.cuda()
    seeded = VoteNetPredictor(cfg, device="cuda", batch_size=8, generator=torch.Generator().manual_seed(SEED))
    calibrate_head(seeded, scenes)
    return trained, [("phase-4", seeded.model, scenes), ("phase-10", trained, synthetic_scenes(SEED, cfg, EVAL_SCENES))]


def nms_reads(scores, obj):
    """The IoUs the greedy reads on this data: the candidate at order
    position p needs its IoUs with the N - 1 - p boxes after it."""
    import torch

    N = scores.shape[1]
    order = torch.argsort(scores.cpu(), dim=1, descending=True, stable=True)
    cand = (obj[..., 1] > obj[..., 0]).cpu().gather(1, order)
    return int(((N - 1 - torch.arange(N)) * cand).sum())


def nms_bound(B, N, reads):
    """The greedy's least time: the scores (4 bytes), the objectness (8) and
    the keep mask (1) a box, the ``reads`` IoUs this run's candidates need
    (4 bytes each); one threshold test an IoU read and one comparison a
    pair of boxes to rank them."""
    return bound_ms(float(reads + B * N * N), reads * 4.0 + B * N * 13.0)


# The head's kernel times of record before this slice's redesigns of the
# greedy and the IoU matrix (H100 80GB HBM3, 700.00 W; chip_smoke.py's
# phases 22, 26 and 27 of PR 10-11, PERF.md section 6), printed beside this
# run's as "earlier -> now".
EARLIER_US = {("nms3d", "phase-10", 8): 20.7, ("iou3d", "phase-10", 8): 33.8, ("iou3d", "phase-4", 8): 47.3,
              ("nms3d", "N=1025", 2): 170.7, ("nms3d", "N=1056", 2): 177.9, ("nms3d", "N=2048", 2): 430.5,
              ("nms3d", "N=4096", 2): 972.8}


def earlier_now(kernel, layer, B, ms):
    if (kernel, layer, B) in EARLIER_US:
        print(f"  {kernel} {layer} B={B}: earlier {EARLIER_US[kernel, layer, B]:.1f} us (H100 80GB HBM3, 700.00 W, "
              f"PERF.md) -> now {ms * 1e3:.1f} us")


@contextlib.contextmanager
def decode_nms_route(route):
    """Within the block decode + NMS take ``route``: "kernel" (as shipped:
    two launches), "loop" (the greedy's plain version on the card: the
    candidates, ``torch.argsort`` and the fixpoint, one host sync a round)
    or "plain_decode" (the decode's plain version on the card's tensors,
    some 80 eager launches, then the IoU kernel): the routes timed side by
    side in one process."""
    import importlib

    import torch

    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

    nms_mod = importlib.import_module("votenet_tpu_torch.ops.nms3d")
    dec_mod = importlib.import_module("votenet_tpu_torch.models.decode")
    saved = nms_mod.nms3d_greedy_cuda, dec_mod.kernel_route
    if route == "loop":
        nms_mod.nms3d_greedy_cuda = lambda iou, scores, obj, thr: nms3d_jacobi_plain(
            iou, torch.argsort(scores, dim=1, descending=True, stable=True), obj[..., 1] > obj[..., 0], thr)
    elif route == "plain_decode":
        dec_mod.kernel_route = lambda t, op: "cpu"
    try:
        yield
    finally:
        nms_mod.nms3d_greedy_cuda, dec_mod.kernel_route = saved


def host_ms(fn, reps):
    """Host-clock ms of ``fn()`` through a device sync, each of ``reps``
    calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def same_floats(a, b):
    """Equal tensors, floats compared by their bits (a NaN equals its own
    bits, -0 differs from +0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def phase_nms(cfg, scenes, state_dict, report, kernels_only=False):
    """Phase 22: the NMS greedy kernel against the fixpoint on the card and
    the CPU's keep mask, on the decoded boxes of phase 4's seed-0 model and
    of phase 10's trained checkpoint, B=1 and 8; the head on the card
    against the CPU from the same end points (decode, IoU, masks,
    ``predict_boxes``: gates); no host sync inside ``ops.nms3d`` or
    ``predict_boxes`` on the card; then decode + NMS apart (decode, IoU,
    ``predict_boxes`` each route, the packed fetch, the host decode), phase
    10's eval pass and ``detect()`` by route."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.data.synthetic import synthetic_gt_all
    from votenet_tpu_torch.eval import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.eval.evaluator import decode_batch_predictions
    from votenet_tpu_torch.models import VoteNet, predict_boxes
    from votenet_tpu_torch.models.decode import decode_proposals, decode_proposals_plain
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain
    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain
    from votenet_tpu_torch.predictor import VoteNetPredictor

    print("phase 22: NMS greedy kernel vs the fixpoint on the card and the CPU's mask; the head on the card "
          "against the CPU (CUDA events)")
    print(TABLE_HEAD)
    trained, cases = detection_models(cfg, scenes, state_dict)
    eval_scenes = cases[1][2]
    checks = {}
    thr = cfg.nms_iou

    def plain_greedy(iou, scores, obj):
        order = torch.argsort(scores, dim=1, descending=True, stable=True)
        return nms3d_jacobi_plain(iou, order, obj[..., 1] > obj[..., 0], thr)

    for name, model, sc in cases:
        for B in (1, 8):
            pts = torch.from_numpy(np.stack([s["points"] for s in sc[:B]])).cuda()
            with torch.inference_mode():
                ep = model(pts)
                ep_cpu = {k: v.cpu() for k, v in ep.items()}
                d = decode_proposals(ep, cfg)
                d_cpu = decode_proposals(ep_cpu, cfg)  # the CPU's own decode of the card's end points
                corners, scores, obj = d["bboxes"], d["nms_scores"], d["objectness"]
                cand = obj[..., 1] > obj[..., 0]
                iou = ops.box3d_iou_matrix(corners, corners)
                got = nms3d_greedy_cuda(iou, scores, obj, thr)
                loop = plain_greedy(iou, scores, obj)
                loop_cpu = plain_greedy(iou.cpu(), scores.cpu(), obj.cpu())
                iou_cpu = ops.box3d_iou_matrix(d_cpu["bboxes"], d_cpu["bboxes"])
                cpu = ops.nms3d(d_cpu["bboxes"], d_cpu["nms_scores"], d_cpu["objectness"], thr)
                on_cpu_iou = nms3d_greedy_cuda(iou_cpu.cuda(), scores, obj, thr)
                head_cpu = predict_boxes(ep_cpu, cfg)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")  # any sync inside ops.nms3d or predict_boxes raises
                try:
                    whole = ops.nms3d(corners, scores, obj, thr)
                    head = predict_boxes(ep, cfg)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                equal = torch.equal(got, loop) and torch.equal(got.cpu(), loop_cpu) and torch.equal(whole, got)
                k_ms = cuda_ms(lambda: nms3d_greedy_cuda(iou, scores, obj, thr), 50)
                p_ms = cuda_ms(lambda: plain_greedy(iou, scores, obj), 3)
            n_cand, n_kept = int(cand.sum()), int(got.sum())
            crossed = int(((iou.cpu() > thr) != (iou_cpu > thr)).sum())
            differ = int((cpu != got.cpu()).sum())
            checks[f"{name} B={B}: the kernel's keep == the fixpoint's on the card == the CPU fixpoint's on the "
                   f"card's IoU == ops.nms3d on the card, {n_cand} candidates, {n_kept} kept"] = equal and (
                       0 < n_kept <= n_cand)
            checks[f"{name} B={B}: the kernel on the CPU's IoU == the CPU's ops.nms3d"] = torch.equal(
                on_cpu_iou.cpu(), cpu)
            checks[f"{name} B={B}: the IoU floats on the card (the kernel) == the CPU's (the plain version on the "
                   f"CPU's own corners) ({int((iou.cpu() != iou_cpu).sum())} differ), IoU pairs on either side of "
                   f"the threshold between the devices: {crossed}"] = torch.equal(iou.cpu(), iou_cpu) and crossed == 0
            checks[f"{name} B={B}: the CPU's mask differs from the card's in {differ} boxes"] = differ == 0
            a, b = d["bboxes"].cpu(), d_cpu["bboxes"]
            ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
            checks[f"{name} B={B}: the decode's corners, card against CPU from the same end points: "
                   f"{int((a != b).sum())} of {a.numel()} floats differ, at most {int(ulps.max())} ulps"] = (
                       same_floats(a, b))
            checks[f"{name} B={B}: every decode output on the card == the CPU's, bit for bit"] = all(
                same_floats(d[k].cpu(), d_cpu[k]) for k in d)
            checks[f"{name} B={B}: predict_boxes on the card == on the CPU (every output, the keep mask: "
                   f"{int(head['keep'].sum())} kept)"] = all(same_floats(head[k].cpu(), head_cpu[k]) for k in head)
            report("nms3d", name, B, f"N={scores.shape[1]} cand={n_cand} kept={n_kept}", equal, 0, k_ms, p_ms,
                   nms_bound(B, scores.shape[1], nms_reads(scores, obj)), total=name == "phase-10")
            earlier_now("nms3d", name, B, k_ms)
    checks["ops.nms3d and predict_boxes on the card: no host sync (sync debug mode 'error')"] = True
    if kernels_only:
        return finish(checks, "NMS kernel checks", None)

    print("  decode + NMS apart, trained checkpoint (device ms by CUDA events; host ms through a sync)")
    for B in (1, 8):
        pts = torch.from_numpy(np.stack([s["points"] for s in eval_scenes[:B]])).cuda()
        with torch.inference_mode():
            ep = trained(pts)
            d = decode_proposals(ep, cfg)
            dec_ms = cuda_ms(lambda: decode_proposals(ep, cfg), 10)
            dec_plain_ms = cuda_ms(lambda: decode_proposals_plain(ep, cfg), 10)
            iou_ms = cuda_ms(lambda: ops.box3d_iou_matrix(d["bboxes"], d["bboxes"]), 10)
            iou_plain_ms = cuda_ms(lambda: box3d_iou_matrix_plain(d["bboxes"], d["bboxes"]), 3)
            head_ms = cuda_ms(lambda: predict_boxes(ep, cfg), 10)
            routes = {}
            for route in ("kernel", "plain_decode", "loop", "loop", "plain_decode", "kernel"):
                with decode_nms_route(route):
                    routes.setdefault(route, []).extend(host_ms(lambda: predict_boxes(ep, cfg), 5))
            predict = make_packed_predict_fn(trained, cfg)
            out = predict(pts)
            torch.cuda.synchronize()
            fetch, host = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                cnt = out["cnt"].cpu().numpy()
                rows = out["packed"][:, : max(int(cnt.max()), 1)].cpu().numpy()
                fetch.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                decode_batch_predictions(list(range(B)), {"packed": rows, "cnt": cnt}, {})
                host.append((time.perf_counter() - t0) * 1e3)
        print(f"  B={B}: decode {dec_ms:.4f} ms (the kernel; its plain version's eager passes {dec_plain_ms:.3f} "
              f"ms), IoU matrix {iou_ms:.4f} ms (the kernel; its eager plain version {iou_plain_ms:.3f} ms), "
              f"predict_boxes {head_ms:.4f} ms (device); predict_boxes host clock by route in turns: " + "; ".join(
                  f"{r} median {float(np.median(v)):.3f} ms {[round(x, 3) for x in v]}" for r, v in routes.items())
              + f"; packed fetch median {float(np.median(fetch)):.3f} ms, host decode median "
              f"{float(np.median(host)):.3f} ms")
    # phase 10's eval pass (samlp on), whose host enqueues the next forward
    # while the card runs this one unless the head waits for the card
    gt_all = synthetic_gt_all(eval_scenes)
    cache = DeviceSceneCache([(int(s["data_idx"]), s["points"]) for s in eval_scenes], 8, "cuda")
    on = VoteNet(cfg.replace(samlp="on"))
    on.load_state_dict(state_dict)
    predict = make_packed_predict_fn(on.cuda(), cfg)
    ev = Evaluator(cfg, gt_all, batch_size=8)
    ev.predictions_for_scenes(predict, cache)  # warm-up
    passes = {}
    for route in ("kernel", "plain_decode", "loop", "loop", "plain_decode", "kernel") * 2:
        with decode_nms_route(route):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.predictions_for_scenes(predict, cache)
            torch.cuda.synchronize()
            passes.setdefault(route, []).append(EVAL_SCENES / (time.perf_counter() - t0))
    print(f"  eval pass, {EVAL_SCENES} scenes at B=8, samlp on, scenes/s by route in turns: " + "; ".join(
        f"{r} median {float(np.median(v)):.2f} {[round(x, 2) for x in v]}" for r, v in passes.items()))
    predictor = VoteNetPredictor(cfg, state_dict, device="cuda", batch_size=1)
    detect = {}
    for route in ("kernel", "plain_decode", "loop", "loop", "plain_decode", "kernel"):
        with decode_nms_route(route):
            predictor.detect(eval_scenes[0]["points"])  # warm-up
            for i in range(5):
                t0 = time.perf_counter()
                predictor.detect(eval_scenes[i]["points"])
                detect.setdefault(route, []).append((time.perf_counter() - t0) * 1e3)
    print("  detect() ms, B=1, trained checkpoint, routes in turns (kernel: as shipped; plain_decode: the decode's "
          "plain version on the card; loop: the greedy's plain version on the card): " + "; ".join(
              f"{r} median {float(np.median(v)):.3f} {[round(x, 3) for x in v]}" for r, v in detect.items()))
    return finish(checks, "NMS checks", None)


# The decode kernel's operations a proposal (csrc/decode.cu), beside the
# argmaxes' 2 a compared score: the size 9 (the add, the floor's compare and
# select, the product, each of 3), the centre 3, the heading 6 (the product,
# the add, the scale, the fmod, the fix's compare and add), sin and cos 31
# (the quadrant's product and rint, 4 parts of 2, the square, 7 and 9 for
# the polynomials, 4 selects and negations), the half extents 3, the 8
# corners 9 each.
DECODE_OPS = 9 + 3 + 6 + 31 + 3 + 8 * 9


def decode_bound(B, P, C, NH, NS, NC):
    """The decode's least time: the head's channels and the proposal centres
    read (C + 3 floats a proposal), the corners, centre, size, heading and
    score written (32 floats) and the two classes (int32); DECODE_OPS and 2
    a compared score a proposal at the f32 peak."""
    return bound_ms(float((DECODE_OPS + 2 * (NH + NS + NC)) * B * P), B * P * (C + 3 + 32 + 2) * 4.0)


def decode_iou_bound(B, P, C, NH, NS, NC):
    """The fused head kernel's least time: the decode's (``decode_bound``)
    and the IoU self-matrix's pairs and boxes (``iou_bound``) added, its
    bytes the decode's and the (B, P, P) matrix written (the corners are
    never read)."""
    d_ops, d_bytes = decode_bound(B, P, C, NH, NS, NC)
    i_ops, _ = iou_bound(B, P, P, self_matrix=True)
    return d_ops + i_ops, d_bytes + B * P * P * 4.0 / PEAK_BYTES * 1e3


def long_end_points(cfg, B, P, seed):
    """Seeded random head channels (B, P, C) and proposal centres in a room
    grown with P (phase 27's densities): about half the proposals
    candidates, residuals of either sign, some sizes at the 1e-6 floor."""
    import torch

    rng = np.random.RandomState(seed)
    NH, NS = cfg.num_heading_bin, cfg.num_size_cluster
    out = rng.randn(B, P, cfg.num_proposal_channels).astype(np.float32)
    out[..., 5 + NH:5 + 2 * NH] *= 0.5
    out[..., 5 + 2 * NH + NS:5 + 2 * NH + 4 * NS] *= 0.3
    side = 4.0 * np.sqrt(P / 256.0)
    xyz = rng.uniform(-side, side, (B, P, 3)).astype(np.float32)
    return {"proposals_output": torch.from_numpy(out).cuda(), "proposals_xyz": torch.from_numpy(xyz).cuda()}


def phase_decode(cfg, scenes, state_dict, report):
    """Phase 31: the decode kernel (``csrc/decode.cu``) and the head's fused
    decode + IoU self-matrix kernel (``csrc/iou3d.cu``) against their plain
    versions on the card and on the CPU, on the end points of phase 4's
    seed-0 model and of phase 10's trained checkpoint, B=1 and 8, and (the
    fused kernel) on seeded random end points of 1025-4096 proposals at
    B=2: every decoded output equal bit for bit, the fused IoU matrix bit
    for bit to the two launches' and the plain version's on the card and
    (==) to the CPU's, whose max keeps -0 where the card's gives +0;
    device us of each kernel, of the
    two launches the fused one replaces and of the plain versions' eager
    passes beside the bounds. Returns {"launches": each kernel's in this
    phase, "replaced_ms": the two launches' at the trained checkpoint's
    B=8}."""
    import torch

    from votenet_tpu_torch.models.decode import _kernel_inputs, decode_proposals, decode_proposals_plain
    from votenet_tpu_torch.ops.cuda.decode import decode_iou_cuda, decode_proposals_cuda
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

    print("phase 31: the decode kernel and the head's fused decode + IoU kernel vs their plain versions on the card "
          "and the CPU (CUDA events)")
    print(TABLE_HEAD)
    checks, replaced = {}, {}
    counters = {"decode": decode_proposals_cuda, "decode_iou": decode_iou_cuda}
    zero_counts(counters)
    _, cases = detection_models(cfg, scenes, state_dict)
    NH, NS, NC = cfg.num_heading_bin, cfg.num_size_cluster, cfg.num_class

    def plain_head(ep):
        d = decode_proposals_plain(ep, cfg)
        return d, box3d_iou_matrix_plain(d["bboxes"], d["bboxes"])

    def two_launches(args):
        c = decode_proposals_cuda(*args)["bboxes"]
        return box3d_iou_matrix_cuda(c, c)

    runs = [(name, B, lambda model=model, sc=sc, B=B: model(torch.from_numpy(
        np.stack([s["points"] for s in sc[:B]])).cuda())) for name, model, sc in cases for B in (1, 8)]
    runs += [(f"N={N}", 2, lambda N=N: long_end_points(cfg, 2, N, N)) for N in NMS_LONG_ROWS]
    for name, B, make in runs:
        with torch.inference_mode():
            ep = make()
            args = _kernel_inputs(ep, cfg)
            ep_cpu = {k: v.cpu() for k, v in ep.items()}
            fields, iou = decode_iou_cuda(*args)
            d_plain, iou_plain = plain_head(ep)
            d_cpu, iou_cpu = plain_head(ep_cpu)
            eq = (all(same_floats(fields[k], d_plain[k]) and same_floats(fields[k].cpu(), d_cpu[k]) for k in fields)
                  and same_floats(iou, two_launches(args)) and same_floats(iou, iou_plain)
                  and torch.equal(iou.cpu(), iou_cpu))
            signs = int((iou.cpu().view(torch.int32) != iou_cpu.view(torch.int32)).sum())
            err = float((iou.cpu().double() - iou_cpu.double()).abs().max())
            _, P, C = ep["proposals_output"].shape
            k_ms = cuda_ms(lambda: decode_iou_cuda(*args), 50)
            r_ms = cuda_ms(lambda: two_launches(args), 50)
            p_ms = cuda_ms(lambda: plain_head(ep), 3)
            checks[f"{name} B={B}: the fused kernel's 7 decoded outputs == the decode's plain version's on the card "
                   f"and on the CPU, bit for bit; its IoU matrix == the two launches' and the IoU's plain version's "
                   f"on the card bit for bit, == the CPU's ({signs} zeros of the other sign)"] = eq
            report("decode_iou", name, B, f"P={P} C={C}", eq, err, k_ms, p_ms, decode_iou_bound(B, P, C, NH, NS, NC),
                   total=name == "phase-10")
            print(f"    the two launches it replaces (decode, then the IoU triangle): {r_ms * 1e3:.1f} us; the fused "
                  f"kernel {k_ms * 1e3:.1f} us")
            replaced[name, B] = r_ms
            if name.startswith("N="):
                continue
            got = decode_proposals(ep, cfg)
            plain = decode_proposals_plain(ep, cfg)
            equal = all(same_floats(got[k], plain[k]) and same_floats(got[k].cpu(), d_cpu[k]) for k in d_cpu)
            d_err = max(float((got[k].cpu().double() - d_cpu[k].double()).abs().max()) for k in d_cpu)
            dk_ms = cuda_ms(lambda: decode_proposals(ep, cfg), 50)
            dp_ms = cuda_ms(lambda: decode_proposals_plain(ep, cfg), 10)
        checks[f"{name} B={B}: every decode output of the decode kernel == the plain version's on the card == on "
               f"the CPU, bit for bit"] = equal
        report("decode", name, B, f"P={P} C={C}", equal, d_err, dk_ms, dp_ms, decode_bound(B, P, C, NH, NS, NC),
               total=name == "phase-10")
    launches = launch_counts(counters)
    return finish(checks, "decode kernel checks", {"launches": launches, "replaced_ms": replaced[("phase-10", 8)]})


def head_times(cfg, scenes, state_dict):
    """``--head-times``: the detection head at B=1 and 8 on the trained
    checkpoint's end points, through public names only (``decode_proposals``,
    ``ops.box3d_iou_matrix``, ``ops.nms3d``, ``predict_boxes``), so that a
    copy of this file at the root of an earlier checkout times that
    checkout's head with the same code: device ms of each (CUDA events) and
    ``predict_boxes``' host ms through a sync (medians of 20)."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.models import VoteNet, predict_boxes
    from votenet_tpu_torch.models.decode import decode_proposals

    model = VoteNet(cfg)
    model.load_state_dict(state_dict)
    model.cuda()
    eval_scenes = synthetic_scenes(SEED, cfg, EVAL_SCENES)
    res = {}
    for B in (1, 8):
        pts = torch.from_numpy(np.stack([s["points"] for s in eval_scenes[:B]])).cuda()
        with torch.inference_mode():
            ep = model(pts)
            d = decode_proposals(ep, cfg)
            c, s, o = d["bboxes"], d["nms_scores"], d["objectness"]
            res[B] = {
                "decode_ms": cuda_ms(lambda: decode_proposals(ep, cfg), 20),
                "iou_ms": cuda_ms(lambda: ops.box3d_iou_matrix(c, c), 20),
                "nms_op_ms": cuda_ms(lambda: ops.nms3d(c, s, o, cfg.nms_iou), 20),
                "predict_boxes_ms": cuda_ms(lambda: predict_boxes(ep, cfg), 20),
                "predict_boxes_host_ms": float(np.median(host_ms(lambda: predict_boxes(ep, cfg), 20))),
            }
        print(f"head times B={B}: " + ", ".join(f"{k} {v:.4f}" for k, v in res[B].items()))
    print(json.dumps({"head_times": res}))


def phase_bq_fast(cfg, scenes, report, production_ms, state_dict=None, f32_maps=None):
    """Phase 23: the ball query's fast_bf16 variant at the five main-path
    shapes, B=1 and 8, through both routes: bit-equal to its plain version on
    the card and, at B=1, on the CPU; slots and counts that differ from the
    exact query; device us beside the exact kernel's. With ``state_dict``
    also one B=8 serving forward and phase 10's eval under
    ``bq_precision="fast_bf16"``, and ``run_eval --bq_precision=fast_bf16``.
    Returns each path's launches."""
    import torch

    from votenet_tpu_torch.ops.cuda.ballquery import ballquery_route, query_ball_point_cuda, query_ball_point_plain

    print("phase 23: ball query fast_bf16 variant vs its plain version and the exact kernel (CUDA events, warm L2)")
    print(TABLE_HEAD)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    checks = {}
    for B in (1, 8):
        points = torch.from_numpy(np.stack([s["points"] for s in scenes[:B]])).cuda()
        _, bq_cases = layer_inputs(points, cfg)
        for layer, radius, nsample, xyz, q in bq_cases:
            N, M = xyz.shape[1], q.shape[1]
            seg = ballquery_route(B, N, M, sm_count)[0]
            want = query_ball_point_plain(radius, nsample, xyz, q, "fast_bf16")
            equal = True
            for segments in (None, 1 if seg > 1 else 4):
                got = query_ball_point_cuda(radius, nsample, xyz, q, segments=segments, mode="fast_bf16")
                equal = equal and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            if B == 1:
                cpu = query_ball_point_plain(radius, nsample, xyz.cpu(), q.cpu(), "fast_bf16")
                equal = equal and torch.equal(got[0].cpu(), cpu[0]) and torch.equal(got[1].cpu(), cpu[1])
            exact = query_ball_point_cuda(radius, nsample, xyz, q)
            k_ms = cuda_ms(lambda: query_ball_point_cuda(radius, nsample, xyz, q, mode="fast_bf16"), 20)
            e_ms = cuda_ms(lambda: query_ball_point_cuda(radius, nsample, xyz, q), 20)
            p_ms = cuda_ms(lambda: query_ball_point_plain(radius, nsample, xyz, q, "fast_bf16"), 2)
            report("ballquery_fast_bf16", layer, B, f"N={N} M={M} r={radius} seg={seg}", equal, 0, k_ms, p_ms,
                   ballquery_bound(xyz, q, nsample, *want))
            if B == 8:
                production_ms["ballquery_fast_bf16"] += e_ms
            print(f"    both routes{' and the CPU' if B == 1 else ''}: {'bit-equal' if equal else 'DIFFER'}; "
                  f"vs exact: {int((exact[0] != want[0]).sum())} of {want[0].numel()} slots, "
                  f"{int((exact[1] != want[1]).sum())} of {want[1].numel()} counts differ; exact kernel "
                  f"{e_ms * 1e3:.1f} us")
    if state_dict is None:
        return None
    from votenet_tpu_torch import run_eval
    from votenet_tpu_torch.predictor import VoteNetPredictor

    fcfg = cfg.replace(bq_precision="fast_bf16")
    counters = eval_counters()
    predictor = VoteNetPredictor(fcfg, state_dict, device="cuda", batch_size=8)
    batch = np.stack([s["points"] for s in scenes[:8]])
    predictor(batch)  # warm-up
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = {k: v.cpu() for k, v in predictor(batch).items()}
    paths = {"serve_bq_fast_bf16": {k: c.launches for k, c in counters.items()}}
    want = {"fps": 5, "ballquery": 0, "ballquery_fast_bf16": 5, "samlp": 0, "samlp_bf16": 0, **HEAD_LAUNCHES,
            **bn_launches(fcfg, train=False)}
    checks[f"one B=8 serving forward launches {paths['serve_bq_fast_bf16']} == {want}"] = (
        paths["serve_bq_fast_bf16"] == want)
    checks["its outputs finite"] = all(torch.isfinite(out[k]).all() for k in ("bboxes", "class_scores"))
    del predictor
    paths.update({f"eval_bq_fast_bf16_samlp_{m}": c for m, c in phase_eval(
        fcfg, state_dict, label="  phase 23 eval (bq_precision=fast_bf16)", beside=f32_maps).items()})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        shutil.copy(CKPT, Path(tmp) / CKPT.name)
        for c in counters.values():
            c.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_eval.main([f"--log_dir={tmp}", "--synthetic=16", "--batch_size=8", "--samlp=on",
                                "--bq_precision=fast_bf16"])
        paths["run_eval_bq_fast_bf16"] = {k: c.launches for k, c in counters.items()}
    text = buf.getvalue()
    print("  run_eval --bq_precision=fast_bf16 --samlp=on --synthetic=16 --batch_size=8 (committed checkpoint):")
    print("    " + " ".join(line.strip() for line in text.splitlines() if "mAP" in line or "checkpoint" in line))
    checks[f"run_eval exit {rc}, launches {paths['run_eval_bq_fast_bf16']}"] = (
        rc == 0 and paths["run_eval_bq_fast_bf16"]["ballquery_fast_bf16"] == 10
        and paths["run_eval_bq_fast_bf16"]["ballquery"] == 0 and "epoch 81" in text)
    return finish(checks, "fast_bf16 ball query checks", paths)


def phase_remat(scenes, bare_step_ms, large_batches=(32, 64)):
    """Phase 24: remat at full width. One B=8 step with and without remat
    from the same weights under deterministic algorithms: losses, gradients
    and statistics bit-equal; the remat step's launches (FPS and the ball
    query 9, sa1-sa4's again in the backward); both steps' ms in turns and
    their peak device memory at B=8 and each of ``large_batches`` (where the
    plain step runs out of memory, remat's alone); then run_train with
    ``--remat=true --bq_precision=fast_bf16``. Returns each path's launches."""
    import torch

    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step

    cfg = default_config()
    cfgs = {False: cfg, True: cfg.replace(remat=True)}
    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    states = {r: create_train_state(c, 512, torch.Generator().manual_seed(SEED), device="cuda")
              for r, c in cfgs.items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = {r: (forward_backward(states[r].model, batch, c), _grads(states[r].model), _stats(states[r].model))
               for r, c in cfgs.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    (lp, gp, sp_), (lr, gr, sr) = out[False], out[True]
    checks = {
        "losses bit-equal": all(torch.equal(a, b) for a, b in zip(lp, lr)),
        f"{len(gp)} gradient leaves bit-equal": all(torch.equal(gp[n], gr[n]) for n in gp),
        f"{len(sp_)} running statistics bit-equal (moved once)": all(torch.equal(sp_[n], sr[n]) for n in sp_),
    }
    steps = {r: make_train_step(c) for r, c in cfgs.items()}
    for r in steps:  # warm-up
        steps[r](states[r], batch)
    counters = train_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    steps[True](states[True], batch)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    checks[f"one remat step launches {launches} == {step_launches(cfgs[True])}"] = launches == step_launches(cfgs[True])
    ms = {False: [], True: []}
    for r in [False, True, True, False] * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[r](states[r], batch)
        torch.cuda.synchronize()
        ms[r].append((time.perf_counter() - t0) * 1e3)
    peaks = {}
    big = {B: next(batch_scenes(iter(synthetic_scenes(SEED + 1, cfg, B)), B, cfg.max_gt_boxes))
           for B in large_batches}
    big[8] = batch
    for B, b in sorted(big.items()):
        for r in (False, True):
            torch.cuda.synchronize()
            gc.collect()  # what a failed step's traceback held
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                steps[r](states[r], b)
            except torch.OutOfMemoryError:
                if r:
                    raise
                peaks[(B, r)] = None  # the plain step does not fit the card
                for p in states[r].model.parameters():
                    p.grad = None
                continue
            finally:
                torch.cuda.synchronize()
            peaks[(B, r)] = (torch.cuda.max_memory_allocated() / 2**30, (time.perf_counter() - t0) * 1e3)
    print("phase 24: remat, full width, one B=8 step with and without from the same weights (deterministic "
          "algorithms for the comparison), then both timed in turns")
    for r in (False, True):
        print(f"  {'remat' if r else 'plain'} step ms: median {float(np.median(ms[r])):.3f}, "
              f"all {[round(v, 3) for v in ms[r]]}")
    total = torch.cuda.get_device_properties(0).total_memory / 2**30
    for B in sorted(big):
        (p1, t1_) = peaks[(B, True)]
        if peaks[(B, False)] is None:
            print(f"  B={B}: the plain step runs out of the card's {total:.2f} GiB; remat's peak {p1:.3f} GiB, "
                  f"its step {t1_:.1f} ms")
            continue
        (p0, t0_) = peaks[(B, False)]
        print(f"  B={B}: peak device memory plain {p0:.3f} GiB, remat {p1:.3f} GiB ({p1 / p0:.3f} of plain, "
              f"{p0 - p1:.3f} GiB saved); that step's ms plain {t0_:.1f}, remat {t1_:.1f}")
    checks[f"remat's peak below plain's at B={sorted(big)}, where plain fits"] = all(
        peaks[(B, False)] is None or peaks[(B, True)][0] < peaks[(B, False)][0] for B in big)
    paths = {"train_remat": launches}
    paths["fit_remat_bq_fast_bf16"] = phase_fit(
        bare_step_ms, extra=("--remat=true", "--bq_precision=fast_bf16"),
        label="  phase 24 (run_train --remat=true --bq_precision=fast_bf16)")
    return finish(checks, "remat checks", paths)


def dead_path_cases():
    """(name, build(generator) -> module, takes features) of phase 25."""
    from votenet_tpu_torch.models.pointnet2 import PointNetSAModule, PointNetSAModuleMSG

    def sa(**kw):
        return lambda g, c: PointNetSAModule(512, 0.4, 32, c, (64, 64, 128), g, samlp=True, **kw)

    return [
        ("pooling=avg", sa(pooling="avg"), True),
        ("pooling=weighted_avg", sa(pooling="weighted_avg"), True),
        ("pooling=max_and_avg", sa(pooling="max_and_avg", mlp2=(128, 64)), True),
        ("group_all", sa(group_all=True), True),
        ("knn", sa(knn=True), True),
        ("use_xyz=False", sa(use_xyz=False), True),
        ("use_bn=False", sa(use_bn=False, mlp2=(128, 64)), True),
        ("no features", sa(), False),
        ("MSG", lambda g, c: PointNetSAModuleMSG(512, (0.2, 0.4), (16, 32), c, ((32, 64), (64, 128)), g), True),
    ]


def phase_dead_paths(scenes):
    """Phase 25: the reference API's other paths once each on the card
    against their CPU run: every SA option, the MSG module (eval and train
    mode, B=2, 2048 points with 64 features), and knn_point, select_top_k,
    query_ball_point_topk and prob_sample."""
    import copy

    import torch

    from votenet_tpu_torch import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(SEED)
    xyz = np.stack([s["points"][rng.permutation(len(s["points"]))[:2048]] for s in scenes[:2]])
    feats = rng.randn(2, 2048, 64).astype(np.float32)
    cx, cf = torch.from_numpy(xyz), torch.from_numpy(feats)
    gx, gf = cx.cuda(), cf.cuda()
    checks = {}
    print("phase 25: the reference API's other paths, the card against the CPU")
    for name, build, with_feats in dead_path_cases():
        cpu = build(torch.Generator().manual_seed(SEED), 64 if with_feats else 0)
        gpu = copy.deepcopy(cpu).cuda()
        for train in (False, True):
            cpu.train(train)
            gpu.train(train)
            with torch.no_grad():
                a = cpu(cx, cf if with_feats else None)
                b = gpu(gx, gf if with_feats else None)
            ok, worst = True, 0.0
            for x, y in zip(a, b):
                if x.dtype == torch.int32:
                    ok = ok and torch.equal(x, y.cpu())
                else:
                    err, tol = scale_err(y, x)
                    worst = max(worst, err / tol)
            for (n1, s1), (_, s2) in zip(cpu.named_buffers(), gpu.named_buffers()):
                err, tol = scale_err(s2, s1)
                worst = max(worst, err / tol)
            checks[f"{name} {'train' if train else 'eval'}: indices equal, floats and statistics within "
                   f"REL_TOL of scale ({worst:.3g} of it)"] = ok and worst <= 1.0
    lat = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8), indexing="ij"), -1).reshape(-1, 3)
    lx = torch.from_numpy(lat[rng.permutation(len(lat))][None].astype(np.float32) * np.float32(0.25))
    lq = lx[:, :300] + 0.125
    dist = torch.from_numpy(rng.randint(0, 9, (2, 64, 500)).astype(np.float32))
    p = torch.from_numpy(rng.randint(0, 5, (2, 2000)).astype(np.float32))
    r = torch.from_numpy((rng.uniform(0, 1, (2, 300)) * p.sum(-1, keepdims=True).numpy()).astype(np.float32))
    op_cases = {
        "knn_point, tied distances": lambda d: ops.knn_point(16, lx.to(d), lq.to(d)),
        "select_top_k": lambda d: ops.select_top_k(8, dist.to(d)),
        "query_ball_point_topk": lambda d: ops.query_ball_point_topk(0.4, 32, cx.to(d), cx[:, :256].to(d)),
        "prob_sample, integer probabilities": lambda d: (ops.prob_sample(p.to(d), r.to(d)),),
    }
    for name, fn in op_cases.items():
        a, b = fn("cpu"), fn("cuda")
        checks[f"{name}: bit-equal"] = all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
    topk = ops.query_ball_point_topk(0.4, 32, gx, gx[:, :256].contiguous())
    kern = ops.query_ball_point(0.4, 32, gx, gx[:, :256].contiguous())
    checks["query_ball_point_topk == the ball query kernel"] = all(torch.equal(x, y) for x, y in zip(topk, kern))
    return finish(checks, "dead-path checks", None)


# ---------------------------------------------------------------- phases 26-30

# The IoU kernel's operations (csrc/iou3d.cu): a pair's two boundary sums, each
# 16 clips of 20 (the start's offset from the plane 2, c0 and c1 4 each, 2
# compares, the guard, the negation and the division 3, lo's and hi's
# selects 2, the dead test 3), then 24 an edge (the max and min over the
# planes 6, the clamps 4, the valid test 2, the clipped ends 8, the cross
# product 3 and its select 1) and the 3 adds over the edges: 419 each; the
# combination 19 (the signs' products and sum, the cap, the clamp, the y
# overlap, the union, the division). Once a box: its area and sign 18, its
# edges 8, its volume 3.
IOU_PAIR_OPS = 2 * 419 + 19
IOU_BOX_OPS = 18 + 8 + 3


def iou_bound(B, N, M, self_matrix=False):
    """The IoU matrix's least time: IOU_PAIR_OPS a pair and IOU_BOX_OPS a box
    at the f32 peak; the corners read (96 bytes a box) and the matrix
    written (4 bytes a pair). The self-matrix (the same corners twice, N ==
    M) needs N (N + 1) / 2 pairs, its N boxes read once, the whole matrix
    written."""
    if self_matrix:
        return bound_ms(IOU_PAIR_OPS * B * N * (N + 1) / 2 + IOU_BOX_OPS * B * N, B * N * 96.0 + B * N * N * 4.0)
    return bound_ms(IOU_PAIR_OPS * B * N * M + IOU_BOX_OPS * B * (N + M), B * (N + M) * 96.0 + B * N * M * 4.0)


def phase_iou(cfg, scenes, state_dict, report):
    """Phase 26: the IoU kernel against its plain version on the card and on
    the CPU, on phase 4's and phase 10's decoded boxes at B=1 and 8: the
    self-matrix's triangle (the corners given twice, as NMS gives them) and
    the full route (a copy as the second argument) equal to each other bit
    for bit and to the plain version (==, element by element); device us of
    the triangle (beside its bound), of the full route (beside its own) and
    of the plain version's eager passes on the card. Returns the kernel's
    launches in this phase."""
    import torch

    from votenet_tpu_torch.models.decode import decode_proposals
    from votenet_tpu_torch.ops.cuda.iou3d import box3d_iou_matrix_cuda
    from votenet_tpu_torch.ops.iou3d import box3d_iou_matrix_plain

    print("phase 26: IoU matrix kernel vs its plain version on the card and the CPU (CUDA events)")
    print(TABLE_HEAD)
    checks = {}
    zero_counts({"iou3d": box3d_iou_matrix_cuda})
    _, cases = detection_models(cfg, scenes, state_dict)
    for (name, model, sc), B in ((case, B) for case in cases for B in (1, 8)):
        pts = torch.from_numpy(np.stack([s["points"] for s in sc[:B]])).cuda()
        with torch.inference_mode():
            corners = decode_proposals(model(pts), cfg)["bboxes"].contiguous()
            other = corners.clone()
            got = box3d_iou_matrix_cuda(corners, corners)
            full = box3d_iou_matrix_cuda(corners, other)
            plain = box3d_iou_matrix_plain(corners, corners)
            cpu = box3d_iou_matrix_plain(corners.cpu(), corners.cpu())
            k_ms = cuda_ms(lambda: box3d_iou_matrix_cuda(corners, corners), 50)
            f_ms = cuda_ms(lambda: box3d_iou_matrix_cuda(corners, other), 50)
            p_ms = cuda_ms(lambda: box3d_iou_matrix_plain(corners, corners), 3)
        equal = same_floats(got, full) and torch.equal(got, plain) and torch.equal(got.cpu(), cpu)
        err = float((got - plain).abs().max())
        N = corners.shape[1]
        checks[f"{name} B={B}: the triangle == the full route (bits) == plain on the card == plain on the CPU "
               f"({int((got.cpu() != cpu).sum())} of {cpu.numel()} floats differ from the CPU's; "
               f"{int((got > 0).sum())} pairs overlap)"] = equal
        report("iou3d", name, B, f"N=M={N} triangle", equal, err, k_ms, p_ms, iou_bound(B, N, N, self_matrix=True),
               total=name == "phase-10")
        print(f"  iou3d {name} B={B}: the full route (c2 a copy) {f_ms * 1e3:.1f} us, its bound "
              f"{max(iou_bound(B, N, N)) * 1e3:.1f} us")
        earlier_now("iou3d", name, B, k_ms)
        if name == "phase-10" and B == 8:
            block_times(corners)
    return finish(checks, "IoU kernel checks", box3d_iou_matrix_cuda.launches)


def block_times(corners):
    """The plain IoU matrix in blocks of 65536 pairs and in one block (B=8,
    N=256: 524288 pairs): host ms on the CPU (the CPU route of
    ``ops.nms3d``, torch's threads) in turns, device ms on the card. The
    plain version takes the first on the CPU (``_PLAIN_BLOCK_PAIRS``), the
    second on the card (``_PLAIN_DEVICE_BLOCK_PAIRS``)."""
    import torch

    from votenet_tpu_torch.ops import iou3d

    cpu = corners.cpu()
    kept = iou3d._PLAIN_BLOCK_PAIRS, iou3d._PLAIN_DEVICE_BLOCK_PAIRS
    sizes = {"blocks of 65536": 1 << 16, "one block": 1 << 20}
    host = {k: [] for k in sizes}
    card = {}
    try:
        for k in list(sizes) * 3:
            iou3d._PLAIN_BLOCK_PAIRS = sizes[k]
            host[k] += host_ms(lambda: iou3d.box3d_iou_matrix_plain(cpu, cpu), 1)
        for k, v in sizes.items():
            iou3d._PLAIN_DEVICE_BLOCK_PAIRS = v
            card[k] = cuda_ms(lambda: iou3d.box3d_iou_matrix_plain(corners, corners), 3)
    finally:
        iou3d._PLAIN_BLOCK_PAIRS, iou3d._PLAIN_DEVICE_BLOCK_PAIRS = kept
    for k in sizes:
        print(f"  plain IoU, phase-10 B=8, {k}: CPU host ms {[round(v, 2) for v in host[k]]} "
              f"({torch.get_num_threads()} threads), card device ms {card[k]:.3f}")


NMS_LONG_ROWS = (1025, 1056, 2048, 4096)


def phase_nms_long(report):
    """Phase 27: NMS at N = 1025, 1056, 2048 and 4096 boxes a row, B=2,
    seeded boxes (the room grown with N so that overlaps stay as frequent as
    at 256): the greedy kernel's keep mask (the workspace route) equal to
    the plain walk's and the fixpoint's on the card, and ``ops.nms3d`` on the
    card (the IoU and greedy kernels, no host sync) to ``ops.nms3d`` on the
    CPU; device us of the greedy (its rank, pack and walk launches) beside
    its earlier time, ms of the whole op."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.models.decode import get_3d_bbox
    from votenet_tpu_torch.ops.cuda.nms3d import nms3d_greedy_cuda, nms3d_greedy_plain
    from votenet_tpu_torch.ops.nms3d import nms3d_jacobi_plain

    print("phase 27: NMS past 1024 boxes a row (the workspace route), B=2, kernel vs the plain walk, the "
          "fixpoint and the CPU (CUDA events)")
    print(TABLE_HEAD)
    checks = {}
    thr = 0.25
    for N in NMS_LONG_ROWS:
        rng = np.random.RandomState(SEED + N)
        room = 1.2 * (N / 256) ** 0.5
        f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
        corners = get_3d_bbox(f(rng.uniform(0.3, 2.0, (2, N, 3))), f(rng.uniform(0, 2 * np.pi, (2, N))),
                              f(rng.uniform(-room, room, (2, N, 3)) * np.array([1, 0.3, 1])))
        scores, obj = f(rng.randn(2, N)), f(rng.randn(2, N, 2))
        g = [x.cuda() for x in (corners, scores, obj)]
        with torch.inference_mode():
            iou = ops.box3d_iou_matrix(g[0], g[0])
            order = torch.argsort(g[1], dim=1, descending=True, stable=True)
            cand = g[2][..., 1] > g[2][..., 0]
            got = nms3d_greedy_cuda(iou, g[1], g[2], thr)
            walk = nms3d_greedy_plain(iou, order, cand, thr)
            fix = nms3d_jacobi_plain(iou, order, cand, thr)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                whole = ops.nms3d(*g, thr)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            cpu = ops.nms3d(corners, scores, obj, thr)
            k_ms = cuda_ms(lambda: nms3d_greedy_cuda(iou, g[1], g[2], thr), 10)
            p_ms = cuda_ms(lambda: nms3d_jacobi_plain(iou, torch.argsort(g[1], dim=1, descending=True, stable=True),
                                                      g[2][..., 1] > g[2][..., 0], thr), 1)
            op_ms = cuda_ms(lambda: ops.nms3d(*g, thr), 5)
        n_cand, n_kept = int(cand.sum()), int(got.sum())
        equal = torch.equal(got, walk) and torch.equal(got, fix) and torch.equal(whole, got)
        checks[f"N={N}: the kernel's keep == the walk's == the fixpoint's == ops.nms3d on the card, {n_cand} "
               f"candidates, {n_kept} kept"] = equal and 0 < n_kept < n_cand
        checks[f"N={N}: ops.nms3d on the card == on the CPU ({int((whole.cpu() != cpu).sum())} boxes differ)"] = (
            torch.equal(whole.cpu(), cpu))
        report("nms3d", f"N={N}", 2, f"cand={n_cand} kept={n_kept}", equal, 0, k_ms, p_ms,
               nms_bound(2, N, nms_reads(g[1], g[2])), total=False)
        earlier_now("nms3d", f"N={N}", 2, k_ms)
        print(f"  N={N}: ops.nms3d on the card (IoU kernel + greedy) {op_ms:.3f} ms")
    checks["ops.nms3d on the card past 1024 boxes: no host sync (sync debug mode 'error')"] = True
    return finish(checks, "long-row NMS checks", None)


def phase_streaming(cfg, scenes):
    """Phase 28: ``three_nn_streaming`` against ``three_nn_dense`` at B=8,
    20480 queries over sa1's 2048 FPS points (~7.5 GiB of dense pairs), and
    ``query_ball_point_streaming`` and ``query_ball_point_dense`` against the
    ball-query kernel at sa1's shape, B=8: bit-equal; device ms and peak
    memory of each."""
    import torch

    from votenet_tpu_torch import ops
    from votenet_tpu_torch.ops import interpolate

    print("phase 28: streaming three_nn and ball query against the dense forms and the kernel, B=8 (CUDA events)")
    pts = torch.from_numpy(np.stack([s["points"] for s in scenes[:8]])).cuda()
    src = ops.gather_point(pts, ops.farthest_point_sample(cfg.sa_npoints[0], pts))
    checks, rows = {}, []

    def measured(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() / 2**30, cuda_ms(fn, 1)

    route = "dense" if 8 * pts.shape[1] * src.shape[1] * interpolate.THREE_NN_PAIR_BYTES <= \
        interpolate.THREE_NN_DENSE_BUDGET else "streaming"
    with torch.inference_mode():
        dense, d_gib, d_ms = measured(lambda: ops.three_nn_dense(pts, src))
        stream, s_gib, s_ms = measured(lambda: ops.three_nn_streaming(pts, src))
        checks[f"three_nn {pts.shape[1]} -> {src.shape[1]}: streaming == dense (three_nn takes {route})"] = all(
            torch.equal(a, b) for a, b in zip(dense, stream))
        rows.append(f"three_nn: dense {d_ms:.2f} ms, peak {d_gib:.2f} GiB; streaming (8192 queries a block) "
                    f"{s_ms:.2f} ms, peak {s_gib:.2f} GiB")
        del dense, stream
        q = ops.gather_point(pts, ops.farthest_point_sample(cfg.sa_npoints[0], pts))
        r, k = cfg.sa_radii[0], cfg.sa_nsamples[0]
        kern, k_gib, k_ms = measured(lambda: ops.query_ball_point(r, k, pts, q))
        bq_d, bd_gib, bd_ms = measured(lambda: ops.query_ball_point_dense(r, k, pts, q))
        bq_s, bs_gib, bs_ms = measured(lambda: ops.query_ball_point_streaming(r, k, pts, q))
    for name, got in (("dense", bq_d), ("streaming (4096 points a block)", bq_s)):
        checks[f"query_ball_point {name} == the kernel at sa1's shape ({pts.shape[1]} -> {q.shape[1]}, r={r})"] = (
            all(torch.equal(a, b) for a, b in zip(got, kern)))
    rows.append(f"ball query: the kernel {k_ms * 1e3:.1f} us, peak {k_gib:.2f} GiB; dense {bd_ms:.2f} ms, peak "
                f"{bd_gib:.2f} GiB; streaming {bs_ms:.2f} ms, peak {bs_gib:.2f} GiB")
    for row in rows:
        print(f"  {row}")
    return finish(checks, "streaming checks", None)


# PACKING_LIMITS (phase 29): a bf16_hilo step against the f32 step from the
# same weights: (the total loss's relative gap, the global gradient's norm
# ratio's (low, high), its cosine's floor), tests/test_gather_packing.py's
# limits on JAX's packed step. The weights are the committed checkpoint's
# (epoch 81): on the port's CPU path at full width, B=8, they read 7.8e-5,
# 1.023, 0.9947. Seed-0 random weights are no yardstick: there a
# proposal's vote moved by the packing's rounding changes its ball and its
# loss terms, and the same comparison read 3.9e-2, 0.816, 0.421 (B=8; 3.4e-3,
# 1.051, 0.918 at B=2). The card's f32 step against the CPU's f32 step
# (phase 8's comparison) must meet them too.
PACKING_LIMITS = (2e-2, (0.75, 1.3), 0.75)


def step_gaps(a, b):
    """(loss relative gap, global gradient norm ratio, cosine) of step
    ``a`` = (losses, grads) against ``b``."""
    import torch

    va = torch.cat([a[1][k].double().ravel().cpu() for k in sorted(a[1])])
    vb = torch.cat([b[1][k].double().ravel().cpu() for k in sorted(b[1])])
    la, lb = float(a[0].total), float(b[0].total)
    return abs(la - lb) / abs(lb), float(va.norm() / vb.norm()), float(va @ vb / (va.norm() * vb.norm()))


def within_packing(gaps):
    loss, (lo, hi), cos = PACKING_LIMITS
    return gaps[0] <= loss and lo < gaps[1] < hi and gaps[2] > cos


# PACKING_CARD_LIMITS (phase 29): the packed step's own limits on the card,
# (the loss's relative gap, the gradient norm ratio's distance from 1, the
# cosine's floor), set between the sound packed step's readings and the
# controls' (PACKING_CONTROLS: the same step with lo zeroed, coordinates at
# bf16 alone, and with lo negated, a mis-split). Readings on an H100 80GB
# HBM3 at 700 W (deterministic algorithms, so every run reads the same):
# sound 1.15e-4, 1.0225, 0.9945; lo zeroed 1.94e-3, 1.0702, 0.8771; lo
# negated 2.46e-4, 1.0330, 0.8452 (the port's CPU path: sound 7.8e-5,
# 1.023, 0.9947). The cosine parts them widest. PACKING_LIMITS stays the
# outer check.
PACKING_CARD_LIMITS = (5e-4, 0.05, 0.98)
PACKING_CONTROLS = {
    "lo zeroed": lambda hi, lo: (hi, lo * 0),
    "lo negated": lambda hi, lo: (hi, -lo),
}


def within_card_packing(gaps):
    loss, norm, cos = PACKING_CARD_LIMITS
    return gaps[0] <= loss and abs(gaps[1] - 1.0) <= norm and gaps[2] >= cos


def phase_packing(scenes, state_dict, bare_step_ms):
    """Phase 29: ``gather_packing="bf16_hilo"`` at full width. One B=8
    forward and backward packed and f32 from the committed checkpoint's
    weights (``state_dict``) on the card (deterministic algorithms): the
    packed step's gaps to the f32 step within PACKING_CARD_LIMITS and
    PACKING_LIMITS, each of PACKING_CONTROLS' steps outside
    PACKING_CARD_LIMITS, and the card's f32 B=2 step against the CPU's
    within PACKING_LIMITS; a packed step's launches (FPS 5, the ball query
    5, the scatter 4: sa2-sa4's bf16 cotangents take the exact kernel) and
    both steps' ms in turns; then phase 11's run_train with
    ``--gather_packing=bf16_hilo``. Returns each path's launches."""
    import torch

    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.models import pointnet2
    from votenet_tpu_torch.train import create_train_state, forward_backward, make_train_step

    cfg = default_config()
    cfgs = {"f32": cfg, "packed": cfg.replace(gather_packing="bf16_hilo")}
    batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
    states = {k: create_train_state(c, 512, torch.Generator().manual_seed(SEED), device="cuda")
              for k, c in cfgs.items()}
    split = pointnet2.split_hilo

    def packed_step(control=None):
        states["packed"].model.load_state_dict(state_dict)
        if control is not None:
            pointnet2.split_hilo = lambda x: control(*split(x))
        try:
            return forward_backward(states["packed"].model, batch, cfgs["packed"]), _grads(states["packed"].model)
        finally:
            pointnet2.split_hilo = split

    states["f32"].model.load_state_dict(state_dict)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        f32 = forward_backward(states["f32"].model, batch, cfg), _grads(states["f32"].model)
        packed = packed_step()
        gaps = step_gaps(packed, f32)
        control_gaps = {name: step_gaps(packed_step(c), f32) for name, c in PACKING_CONTROLS.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    small = next(batch_scenes(iter(scenes[:2]), 2, cfg.max_gt_boxes))
    cpu_state = create_train_state(cfg, 512, torch.Generator().manual_seed(SEED), device="cpu")
    cpu_state.model.load_state_dict(state_dict)
    states["f32"].model.load_state_dict(state_dict)  # the statistics as the CPU's (the step above moved them)
    f32_gaps = step_gaps((forward_backward(states["f32"].model, small, cfg), _grads(states["f32"].model)),
                         (forward_backward(cpu_state.model, small, cfg), _grads(cpu_state.model)))
    del cpu_state
    checks = {
        f"the packed B=8 step against the f32 step: loss gap {gaps[0]:.3g}, gradient norm ratio {gaps[1]:.6f}, "
        f"cosine {gaps[2]:.6f} within {PACKING_CARD_LIMITS}": within_card_packing(gaps),
        f"  and within {PACKING_LIMITS}": within_packing(gaps),
        **{f"control, {name}: {g[0]:.3g}, {g[1]:.6f}, {g[2]:.6f} outside {PACKING_CARD_LIMITS}":
           not within_card_packing(g) for name, g in control_gaps.items()},
        f"the card's f32 B=2 step against the CPU's: {f32_gaps[0]:.3g}, {f32_gaps[1]:.4f}, {f32_gaps[2]:.4f} "
        "within them too": within_packing(f32_gaps),
        "the packed step's gradients finite": all(torch.isfinite(g).all() for g in packed[1].values()),
    }
    steps = {k: make_train_step(c) for k, c in cfgs.items()}
    for k in steps:  # warm-up
        steps[k](states[k], batch)
    counters = train_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    steps["packed"](states["packed"], batch)
    torch.cuda.synchronize()
    launches = {n: c.launches for n, c in counters.items()}
    want = step_launches(cfgs["packed"])
    checks[f"one packed step launches {launches} == {want}"] = launches == want
    ms = {"f32": [], "packed": []}
    for k in ["f32", "packed", "packed", "f32"] * 3:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps[k](states[k], batch)
        torch.cuda.synchronize()
        ms[k].append((time.perf_counter() - t0) * 1e3)
    print("phase 29: gather_packing=bf16_hilo, full width, B=8, the packed step against the f32 step from the "
          "committed checkpoint's weights")
    for k in ms:
        print(f"  {k} step ms: median {float(np.median(ms[k])):.3f}, all {[round(v, 3) for v in ms[k]]}")
    finish(checks, "bf16_hilo step checks", None)
    return {"train_bf16_hilo": launches,
            "fit_bf16_hilo": phase_fit(bare_step_ms, extra=("--gather_packing=bf16_hilo",),
                                       label="  phase 29 (run_train --gather_packing=bf16_hilo)")}


def phase_dispatch(n_points=24000, batch_size=2, k=4, epochs=2):
    """Phase 30: ``run_train --steps_per_dispatch=4`` on phase 11's
    miniature at B=2 (8 steps an epoch, logged at step 8), 2 epochs without the
    eval, against ``--steps_per_dispatch=1``, both under deterministic
    algorithms: the checkpoints byte-equal; each run's ms a step (epoch_time
    over its steps) and the K=4 run's launches (16 steps' worth)."""
    import torch

    from votenet_tpu_torch import run_train
    from votenet_tpu_torch.config import default_config
    from votenet_tpu_torch.data.mini_fixture import generate_mini_sunrgbd
    from votenet_tpu_torch.utils.checkpoint import checkpoint_path

    counters = train_counters()
    checks, ms, launches = {}, {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dispatch_") as tmp:
        root = Path(tmp)
        rng = np.random.RandomState(SEED)
        generate_mini_sunrgbd(str(root / "mini"), list(range(*MINI_TRAIN_IDS)), rng, n_points=n_points)
        generate_mini_sunrgbd(str(root / "mini"), list(range(*MINI_VAL_IDS)), rng, n_points=n_points)
        bytes_ = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for K in (1, k):
                log_dir = root / f"k{K}"
                args = [f"--data_root={root / 'mini'}", f"--cache_dir={root / 'cache'}", f"--log_dir={log_dir}",
                        f"--batch_size={batch_size}", f"--max_epoch={epochs}", "--eval_every_k_epochs=1000",
                        f"--steps_per_dispatch={K}", "--train_idx_range={},{}".format(*MINI_TRAIN_IDS),
                        "--val_idx_range={},{}".format(*MINI_VAL_IDS)]
                for c in counters.values():
                    c.launches = 0
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = run_train.main(args)
                if K == k:
                    launches = {n: c.launches for n, c in counters.items()}
                stats = json.loads((log_dir / "stat.json").read_text())
                steps_an_epoch = (MINI_TRAIN_IDS[1] - MINI_TRAIN_IDS[0]) // batch_size
                ms[K] = [r["epoch_time"] * 1e3 / steps_an_epoch for r in stats]
                checks[f"run_train --steps_per_dispatch={K} exit {rc}"] = rc == 0
                bytes_[K] = Path(checkpoint_path(str(log_dir), epochs)).read_bytes()
        finally:
            torch.use_deterministic_algorithms(False)
    steps = epochs * (MINI_TRAIN_IDS[1] - MINI_TRAIN_IDS[0]) // batch_size
    want = {n: v * steps for n, v in step_launches(default_config()).items()}
    checks[f"epoch {epochs}'s checkpoint of K={k} byte-equal to K=1's ({len(bytes_[1])} bytes)"] = (
        bytes_[1] == bytes_[k])
    checks[f"K={k}: {steps} steps launched {launches} == {want}"] = launches == want
    print(f"phase 30: run_train --steps_per_dispatch={k} against 1 on phase 11's miniature at B={batch_size}, "
          f"{epochs} epochs, deterministic algorithms")
    for K, v in ms.items():
        print(f"  K={K}: ms a step inside fit by epoch {[round(x, 2) for x in v]} (epoch 1 reads the cold cache)")
    return finish(checks, "steps_per_dispatch checks", {"fit_steps_per_dispatch_4": launches})


# ---------------------------------------------------------------- phase 32

BN_KERNELS = ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_apply")
# the kernels and variants of the JSON line: K2's pool variant, K3 and K4 at a pooled site
BN_VARIANTS = {"bn_apply": "bn_apply_pool", "bn_bwd_reduce": "bn_bwd_reduce_pooled",
               "bn_bwd_apply": "bn_bwd_apply_pooled"}
# K4 with the epilogue (the prologue's cotangents: every K4 of a step at a
# site with a dense bias) and K2 running the statistics' end from a
# data-parallel group's sums (either variant)
BN_EXTRA = ("bn_bwd_apply_sums", "bn_apply_group")
BN_ROWS = BN_KERNELS + tuple(BN_VARIANTS.values()) + BN_EXTRA
# Batch norm's per-channel sums (K1, K3) against torch.sum on the card: the
# kernels add exact terms in f64 and round once (within an f32 ulp of the
# exact sum); torch adds in f32 in its own tree, each rounding erring by at
# most 2^-24 of a partial sum: ~1e-6 of the channel's sum of |terms| at R =
# 8.4M (random-walk estimate). Allowed: 1e-5 of that sum of |terms|,
# channel by channel. K2 and K4 against their plain versions: the same
# operations in the same order (each rounding once), held bit for bit.
BN_SUM_TOL = 1e-5
# And against torch's f64 sum of the same exact terms: the f32 sums (K1's
# f64 ones rounded as the op rounds them) within 2^-23 of |sum| (an f32 ulp
# at most; correct rounding errs by half that) plus 2^-40 of the sum of
# |terms| (two f64 sums in different orders, ~1e-13 of it at worst at R =
# 8.4M). A row lost or added moves a sum by a term, 1e-7 of the sum of
# |terms| or more at the model's sites: far outside.
BN_F64_ULPS, BN_F64_FLOOR = 2.0 ** -23, 2.0 ** -40
# The epilogue's bf16 cotangents (corr's, the dense bias's): an f64 sum
# rounded once to bf16 errs by half a bf16 ulp, 2^-8 of |sum| at most
# (torch's f64 -> bf16 cast on the CPU goes through f32: a little more)
BN_F64_ULPS_BF16 = 2.0 ** -7


def device_kernel_names(fn) -> list[str]:
    """The names of the device kernels (and memsets, memcpys) ``fn``
    launches, in launch order, from torch.profiler's CUDA activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def bn_sites(cfg):
    """(layer, rows a scene, channels, prologue, pooled) of each batch norm
    + ReLU of a forward, in the layer list's order (``bn_launches`` counts
    them): an SA layer's first width takes the centred prologue ("centre"),
    every other site the dense bias ("bias"); an SA layer's last width is
    pooled over its ``nsample`` slots."""
    sites = []

    def sa(name, rows, mlp):
        sites.extend((name, rows, w, "centre" if j == 0 else "bias", j == len(mlp) - 1) for j, w in enumerate(mlp))

    for i, mlp in enumerate(cfg.sa_mlps):
        sa(f"sa{i + 1}", cfg.sa_npoints[i] * cfg.sa_nsamples[i], mlp)
    for i, mlp in enumerate(cfg.fp_mlps):  # fp1 at sa3's points, fp2 at sa2's
        sites += [(f"fp{i + 1}", cfg.sa_npoints[2 - i], w, "bias", False) for w in mlp]
    sites += [("voting", cfg.sa_npoints[1], w, "bias", False) for w in cfg.vote_units[:-1]]
    sa("proposal", cfg.proposal_num * cfg.proposal_nsample, cfg.proposal_mlp)
    sites += [("mlp2", cfg.proposal_num, w, "bias", False) for w in cfg.proposal_mlp2_hidden]
    return sites


def bn_slots(cfg, layer):
    """The slots a ball (S) of an SA layer's pool."""
    return cfg.proposal_nsample if layer == "proposal" else cfg.sa_nsamples[int(layer[2:]) - 1]


def bn_bounds(R, C, es_in, es_out, S=1, prologue=None, pooled=False):
    """(ops ms, bytes ms) of K1-K4 at R x C (units of S rows): each input read
    once, each output written once (the per-channel vectors 4 bytes a
    channel); the prologue reads the dense bias (C) and the centre's rows
    (R / S x C) and adds one operation an element for each; at a pooled
    site K2 writes the maxima and int32 counts (R / S x C) in place of y and
    K3 and K4 read them and the pooled cotangent in place of dy. f32
    operations an element: K1 3 (an add, a square, an add), K2 4 (subtract,
    multiply, add, max; pooled 2 more, the compare and the count), K3 and
    K4 9 (K2's three, the mask's compare and select, and the subtract,
    multiply and two adds of the sums or of dx; pooled 3 more: the compare,
    the division by the count, the select). K4 with the epilogue: 2 adds an
    element more (the unit's sum, the bias's), and corr's cotangent (R / S x
    C) and the dense bias's (C f32) written. K2 with the statistics' end
    (a data-parallel group's): K2's (or its pool variant's), plus the two
    f64 sums and the weight read, the running statistics read and written
    and the (4, C) statistics written, ~20 operations a channel."""
    n = float(R) * C
    G = float(R) // S
    pro_ops = n * ((prologue == "centre") + (prologue is not None))
    pro_bytes = (G * C * es_in if prologue == "centre" else 0) + (C * es_in if prologue else 0)
    pool_out = G * C * (es_out + 4)
    dy = G * C * (2 * es_out + 4) if pooled else n * es_out
    k4_ops, k4_bytes = (12 if pooled else 9) * n + pro_ops, 2 * n * es_in + dy + pro_bytes + 20 * C
    epi_bytes = (G * C * es_in if prologue == "centre" else 0) + (4 * C if prologue else 0)
    k2_ops, k2_bytes = (6 if pooled else 4) * n + pro_ops, n * es_in + (pool_out if pooled else n * es_out) + pro_bytes
    return {"bn_stats": bound_ms(3 * n + pro_ops, n * es_in + pro_bytes + 8 * C),
            "bn_apply": bound_ms(k2_ops, k2_bytes + 12 * C),
            "bn_bwd_reduce": bound_ms((12 if pooled else 9) * n + pro_ops, n * es_in + dy + pro_bytes + 20 * C),
            "bn_bwd_apply": bound_ms(k4_ops, k4_bytes),
            "bn_bwd_apply_sums": bound_ms(k4_ops + (2 * n if prologue else 0), k4_bytes + epi_bytes),
            "bn_apply_group": bound_ms(k2_ops + 20 * C, k2_bytes + 4 * C + 52 * C)}


def bn_site_inputs(R, C, dtype, seed, prologue=None, S=1, pooled=False, device="cuda"):
    """A site's random inputs on the card: h (R, C) (scale 3, mean 1), at a
    pooled site with the ball query's padding (each unit of S rows keeps a
    random count of its rows and repeats its first in the rest, so the
    pool's ties are many), the centre's rows (R / S, C) and the dense bias
    where the prologue takes them, the BN weight and bias, and dy: (R, C),
    or the pooled cotangent (R / S, C). The dense bias is f32 (the layer's
    own; the prologue rounds it to h's dtype)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((R, C), generator=g, device=device) * 3 + 1
    if pooled:
        h3 = h.view(R // S, S, C)
        keep = torch.randint(1, S + 1, (R // S, 1, 1), generator=g, device=device)
        h = torch.where(torch.arange(S, device=device)[None, :, None] >= keep, h3[:, :1], h3).view(R, C)
    h = h.to(dtype)
    corr = (torch.randn((R // S, C), generator=g, device=device) * 2).to(dtype) if prologue == "centre" else None
    dense_bias = torch.randn(C, generator=g, device=device) if prologue else None  # f32, as the layer's
    weight = torch.rand(C, generator=g, device=device) + 0.5
    bias = torch.randn(C, generator=g, device=device)
    dy = torch.randn((R // S if pooled else R, C), generator=g, device=device).to(dtype)
    return h, corr, dense_bias, weight, bias, dy


def bn_check(R, C, dtype, seed, times=True, library=True, device="cuda", prologue=None, S=1, pooled=False):
    """K1-K4 at R x C in ``dtype`` (the input's and output's) against their
    plain versions on the card, with the site's prologue ("centre": corr
    and the dense bias, units of S rows; "bias"; None) and, with
    ``pooled``, K2's pool variant and K3 and K4 on the pooled cotangent; the
    train form's vectors from K1's sums; each kernel run twice. Returns
    ({kernel: [ok, err, kernel ms, plain ms, library ms or None]}, the
    message of each gate that failed, all gates' readings); err the largest
    absolute difference from the plain version. K2 and K4 are held bit for
    bit (the pool's maxima and counts too), K1 and K3 within BN_SUM_TOL of
    each channel's sum of |terms| and within BN_F64_ULPS of torch's f64 sum
    of the same terms (plus BN_F64_FLOOR of the sum of |terms|). With
    ``times`` also "eager_ms": the eager passes each launch's fusion replaces on the same inputs (the
    prologue's two or one, and at a pooled site K2 over full rows plus
    ``torch.amax``), and with ``library`` each stage's own PyTorch call on
    the old inputs, x and a full dy (``batch_norm_stats``,
    ``batch_norm_elemt``, ``batch_norm_backward_reduce``,
    ``batch_norm_backward_elemt``), and {"whole": {"forward": ms,
    "backward": ms}} of ``F.batch_norm``'s training forward and autograd
    backward there."""
    import torch
    import torch.nn.functional as F

    from votenet_tpu_torch.ops import batchnorm as bn
    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    h, corr, db, weight, bias, dy = bn_site_inputs(R, C, dtype, seed, prologue, S, pooled, device)
    ends = hasattr(bnc, "BnChannels")  # the per-channel end and the epilogue (absent in earlier checkouts)
    pro = dict(corr=corr, dense_bias=db if ends or db is None else db.to(dtype))
    out = {}

    def twice(fn):
        a, b = fn(), fn()
        same = (all(u is v is None or torch.equal(u, v) for u, v in zip(a, b)) if isinstance(a, tuple)
                else torch.equal(a, b))
        return a, same

    def bits_equal(a, b):
        if a.dtype == torch.int32:
            return torch.equal(a, b)
        ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))

    def sum_gap(got, want, terms):  # (max abs difference, max of it over the channel's sum of |terms|)
        d = (got - want).abs()
        return float(d.max()), float((d / terms.clamp_min(1e-30)).max())

    def f64_gap(got, term, scale):  # the largest |got - f64 sum| over its allowance (<= 1 passes)
        want = sum(term(slice(i, i + (1 << 20))).sum(0) for i in range(0, R, 1 << 20))  # rows in slices: memory
        d = (got.double() - want).abs()
        return float((d / (BN_F64_ULPS * want.abs() + BN_F64_FLOOR * scale.double()).clamp_min(1e-300)).max())

    x = bn.layer_rows_plain(h, corr, pro["dense_bias"])  # the old inputs: x as the eager prologue stores it
    xf = x.float()
    (s, sq), same1 = twice(lambda: bnc.bn_stats_cuda(h, **pro))
    ps, psq = bn.bn_stats_plain(h, **pro)
    s, sq = s.float(), sq.float()  # K1's f64 sums, rounded as the op rounds them
    abs_s, abs_sq = xf.abs().sum(0), (xf * xf).sum(0)  # the channels' sums of |terms|
    (a1, e1), (b1, f1) = sum_gap(s, ps, abs_s), sum_gap(sq, psq, abs_sq)
    abs1, e1 = max(a1, b1), max(e1, f1)
    u1 = max(f64_gap(s, lambda r: x[r].double(), abs_s), f64_gap(sq, lambda r: x[r].double() ** 2, abs_sq))
    mean = s / R
    var_raw = sq / R - mean * mean
    inv = torch.rsqrt(torch.clamp(var_raw, min=0.0) + 1e-5)
    mul = inv * weight
    pool = dict(pool=S) if pooled else {}
    y, same2 = twice(lambda: bnc.bn_apply_cuda(h, mean, mul, bias, dtype, True, **pro, **pool))
    py = bn.bn_apply_plain(h, mean, mul, bias, dtype, True, **pro, **pool)
    eq2 = all(bits_equal(u, v) for u, v in zip(y, py)) if pooled else bits_equal(y, py)
    bwd = dict(pro, pooled=(y if pooled else None))
    pbwd = dict(pro, pooled=(py if pooled else None))
    (sg, sgx), same3 = twice(lambda: bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **bwd))
    psg, psgx = bn.bn_bwd_reduce_plain(h, dy, mean, mul, bias, True, **pbwd)
    gm = bn._masked(x, dy, mean, mul, bias, True, pbwd["pooled"])
    abs_g, abs_gx = gm.abs().sum(0), (gm * (xf - mean)).abs().sum(0)
    (a3, e3), (b3, f3) = sum_gap(sg, psg, abs_g), sum_gap(sgx, psgx, abs_gx)
    abs3, e3 = max(a3, b3), max(e3, f3)
    u3 = max(f64_gap(sg, lambda r: gm[r].double(), abs_g),
             f64_gap(sgx, lambda r: gm[r].double() * (xf[r] - mean).double(), abs_gx))
    a, b = bn.bn_input_coefficients(sg, sgx, mean, mul, inv, weight, var_raw, R)
    dx, same4 = twice(lambda: bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **bwd))
    pdx = bn.bn_bwd_apply_plain(h, dy, mean, mul, bias, a, b, True, **pbwd)
    eq4 = bits_equal(dx, pdx)
    e2 = 0.0 if eq2 else max(float((u.float() - v.float()).abs().max()) for u, v in zip(
        y if pooled else (y,), py if pooled else (py,)))
    e4 = float((dx.float() - pdx.float()).abs().max())
    k2, k3, k4 = ((BN_VARIANTS[k] if pooled else k) for k in ("bn_apply", "bn_bwd_reduce", "bn_bwd_apply"))
    end_gates, extra_gates, end_calls = "", {}, {}
    if ends:
        # the per-channel end: K1's and K3's last CTAs, eval's K2 and, under a data-parallel group, K2's end
        # against the torch ops it replaces, run on this device on the same sums; the running statistics moved
        # alike
        rm0 = torch.randn(C, generator=torch.Generator(device=device).manual_seed(seed + 1), device=device)
        rv0 = torch.rand(C, generator=torch.Generator(device=device).manual_seed(seed + 2), device=device) + 0.5

        def channels(update=True):
            return bnc.BnChannels(R, weight, 1e-5, 0.9, rm0.clone(), rv0.clone(), update)

        def nan_equal(u, v):  # bits equal, NaNs at the same places (a NaN's payload aside)
            nan = torch.isnan(u) if u.is_floating_point() else torch.zeros_like(u, dtype=torch.bool)
            return torch.equal(nan, torch.isnan(v) if v.is_floating_point() else nan) and bits_equal(u[~nan], v[~nan])

        ch_k, ch_p = channels(), channels()
        s64 = bnc.bn_stats_cuda(h, **pro)
        st_k = bnc.bn_stats_cuda(h, **pro, channels=ch_k)
        st_p = bn.bn_channel_stats_plain(s64, ch_p)
        eq_st = all(bits_equal(u, v) for u, v in ((st_k, st_p), (ch_k.running_mean, ch_p.running_mean),
                                                   (ch_k.running_var, ch_p.running_var)))
        cof = bnc.BnCoefficients(torch.stack([mean, mul, inv, var_raw]), weight, R, True)
        co_k = bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **bwd, coefficients=cof)
        eq_co = bits_equal(co_k, bn.bn_channel_coefficients_plain((sg, sgx), cof))
        ye = bnc.bn_apply_cuda(h, rm0, weight, bias, dtype, True, **pro, **pool, eval_var=rv0)
        pye = bn.bn_apply_plain(h, rm0, weight, bias, dtype, True, **pro, **pool, eval_var=rv0)
        eq_ev = all(bits_equal(u, v) for u, v in zip(ye, pye)) if pooled else bits_equal(ye, pye)
        end_gates = (f"; the statistics' end (K1's last CTA) bit-equal to the torch ops {eq_st}; K3's coefficients "
                     f"{eq_co}; eval K2's own mul {eq_ev}")
        if "group_sums" in inspect.signature(bnc.bn_apply_cuda).parameters and R * C <= 1 << 27:  # B=64: memory
            # K2's end from a group's sums, with var_raw < 0, a NaN and a zero among them, against the end's torch
            # ops and K2 on their mean and mul (the composition it replaces), with and without the update
            gsums = s64.clone()
            q = max(1, C // 4)
            gsums[1, :q] = gsums[0, :q] * gsums[0, :q] / R * (1 - 1e-9)  # var_raw < 0
            gsums[0, q % C], gsums[1, (q + 1) % C] = float("nan"), 0.0
            eq_g, n_neg = True, 0
            for update in (True, False):
                ch_g, ch_q = channels(update), channels(update)
                yg, st_g = bnc.bn_apply_cuda(h, None, None, bias, dtype, True, **pro, **pool, group_sums=gsums,
                                             channels=ch_g)
                st_q = bn.bn_channel_stats_plain(gsums, ch_q)
                yq = bnc.bn_apply_cuda(h, st_q[0], st_q[1], bias, dtype, True, **pro, **pool)
                eq_g &= all(nan_equal(u, v) for u, v in ((st_g, st_q), (ch_g.running_mean, ch_q.running_mean),
                                                         (ch_g.running_var, ch_q.running_var),
                                                         *zip(yg if pooled else (yg,), yq if pooled else (yq,))))
                n_neg = int((st_g[3] < 0).sum())
            eq_g &= n_neg > 0
            # an eval backward: K3 and K4 forming mul from the running statistics against the statistics' end
            # from them (its torch ops) and K3 and K4 on its mean and mul
            dye = torch.randn((R // S if pooled else R, C), generator=torch.Generator(device=device).manual_seed(seed),
                              device=device).to(dtype)
            ebwd = dict(pro, pooled=(ye if pooled else None))
            st_e = bn.bn_channel_stats_plain(None, channels(False))
            co_e = bnc.bn_bwd_reduce_cuda(h, dye, st_e[0], st_e[1], bias, True, **ebwd,
                                          coefficients=bnc.BnCoefficients(st_e, weight, R, False))
            dx_e = bnc.bn_bwd_apply_cuda(h, dye, st_e[0], st_e[1], bias, None, None, True, **ebwd)
            co_n = bnc.bn_bwd_reduce_cuda(h, dye, rm0, weight, bias, True, **ebwd, eval_var=rv0,
                                          coefficients=bnc.BnCoefficients(None, weight, R, False))
            dx_n = bnc.bn_bwd_apply_cuda(h, dye, rm0, weight, bias, None, None, True, **ebwd, eval_var=rv0)
            eq_eb = bits_equal(co_e[2:], co_n[2:]) and bits_equal(dx_e, dx_n)
            end_gates += f"; eval K3 and K4 from the running statistics {eq_eb}"
            eq_co &= eq_eb
            extra_gates["bn_apply_group"] = (
                eq_g, 0.0, f"K2's statistics' end from a group's sums ({n_neg} channels var_raw < 0, a NaN, a zero): "
                           f"st, the running statistics and y bit-equal to the torch ops and K2 on them {eq_g}")
            ch_t = channels()  # moved by every timed call alike
            end_calls["bn_apply_group"] = (
                lambda: bnc.bn_apply_cuda(h, None, None, bias, dtype, True, **pro, **pool, group_sums=s64,
                                          channels=ch_t),
                lambda: bn.bn_apply_plain(h, None, None, bias, dtype, True, **pro, **pool, group_sums=s64,
                                          channels=ch_t), None)
            del yg, yq, dye, dx_e, dx_n
        if prologue:  # K4's epilogue: the prologue's cotangents within the f64 gate of the same rounded dx
            epi = lambda: bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **bwd, sums=True)  # noqa: E731
            (dxs, dcs, dds), same5 = twice(epi)
            d = dxs.double()
            ulps = BN_F64_ULPS if dtype == torch.float32 else BN_F64_ULPS_BF16
            unit = (-d).view(-1, S, C)
            pairs = [(dds, d.sum(0), d.abs().sum(0))] + (
                [(dcs, unit.sum(1), unit.abs().sum(1))] if prologue == "centre" else [])
            u5 = max(float(((got.double() - want).abs() / (ulps * want.abs() + BN_F64_FLOOR * terms)
                            .clamp_min(1e-300)).max()) for got, want, terms in pairs)
            eq5 = bits_equal(dxs, dx)
            zero_b = float((d.sum(0).abs() / d.abs().sum(0).clamp_min(1e-300)).max())
            extra_gates["bn_bwd_apply_sums"] = (
                eq5 and u5 <= 1 and same5, 0.0,
                f"K4's epilogue: dx bit-equal {eq5}, the dense bias's and corr's cotangents at {u5:.3g} of the f64 "
                f"allowance (<= 1; |sum| / sum|terms| of the bias's <= {zero_b:.3g}), rerun equal {same5}")
            G = R // S
            end_calls["bn_bwd_apply_sums"] = (
                epi, lambda: bn.bn_bwd_apply_plain(h, dy, mean, mul, bias, a, b, True, **pbwd, sums=True),
                lambda: (dxs.sum(0), (-dxs).view(G, S, C).sum(1)) if prologue == "centre" else dxs.sum(0))
    gates = {
        "bn_stats": (e1 <= BN_SUM_TOL and u1 <= 1 and same1 and (not ends or eq_st), abs1,
                     f"K1 sums {e1:.3g} of sum|x| (<= {BN_SUM_TOL}), {u1:.3g} of the f64 sum's allowance (<= 1), "
                     f"rerun equal {same1}"),
        k2: (eq2 and same2 and (not ends or eq_ev), e2,
             f"K2{' pool' if pooled else ''} bit-equal to plain {eq2}, rerun equal {same2}"),
        k3: (e3 <= BN_SUM_TOL and u3 <= 1 and same3 and (not ends or eq_co), abs3,
             f"K3 sums {e3:.3g} of sum|terms| (<= {BN_SUM_TOL}), {u3:.3g} of the f64 sum's allowance (<= 1), "
             f"rerun equal {same3}{', coefficients ' + str(eq_co) if ends else ''}"),
        k4: (eq4 and same4, e4, f"K4 bit-equal to plain {eq4} (max diff {e4:.3g}), rerun equal {same4}{end_gates}"),
        **extra_gates,
    }
    bad = [msg for ok, _, msg in gates.values() if not ok]
    summary = "; ".join(msg for _, _, msg in gates.values())
    for k, (ok, err, _) in gates.items():
        out[k] = [ok, err, None, None, None]
    if times:
        reps = 20 if R * C <= 1 << 27 else 5
        calls = {
            "bn_stats": (lambda: bnc.bn_stats_cuda(h, **pro), lambda: bn.bn_stats_plain(h, **pro)),
            k2: (lambda: bnc.bn_apply_cuda(h, mean, mul, bias, dtype, True, **pro, **pool),
                 lambda: bn.bn_apply_plain(h, mean, mul, bias, dtype, True, **pro, **pool)),
            k3: (lambda: bnc.bn_bwd_reduce_cuda(h, dy, mean, mul, bias, True, **bwd),
                 lambda: bn.bn_bwd_reduce_plain(h, dy, mean, mul, bias, True, **pbwd)),
            k4: (lambda: bnc.bn_bwd_apply_cuda(h, dy, mean, mul, bias, a, b, True, **bwd),
                 lambda: bn.bn_bwd_apply_plain(h, dy, mean, mul, bias, a, b, True, **pbwd)),
        }
        for k, (kern, plain) in calls.items():
            out[k][2] = cuda_ms(kern, reps)
            out[k][3] = cuda_ms(plain, max(2, reps // 4))
        for k, (kern, plain, lib) in end_calls.items():  # K4 with the epilogue, K2 with the group's end
            out[k][2] = cuda_ms(kern, reps)
            out[k][3] = cuda_ms(plain, max(2, reps // 4))
            out[k][4] = None if lib is None else cuda_ms(lib, reps)  # the epilogue's: dx.sum, (-dx).sum(-2)
        pro_ms = cuda_ms(lambda: bn.layer_rows_plain(h, corr, db), reps) if prologue else 0.0
        eager = {"bn_stats": pro_ms, k3: pro_ms, k4: pro_ms}
        if pooled:
            eager[k2] = pro_ms + cuda_ms(
                lambda: torch.amax(bnc.bn_apply_cuda(x, mean, mul, bias, dtype, True).view(R // S, S, C), dim=1), reps)
        else:
            eager[k2] = pro_ms
        out["eager_ms"] = eager
        if library:  # each stage's own PyTorch call on the old (R, C) inputs, no ReLU or pool in any
            eps = 1e-5
            dy_full = (bn._slot_cotangent(bn.bn_apply_plain(x, mean, mul, bias, dtype, True), dy, *py)
                       if pooled else dy)
            count = torch.tensor([R], dtype=torch.int32, device=device)
            l_mean, l_inv = torch.batch_norm_stats(x, eps)
            l_sg, l_sgx, _, _ = torch.batch_norm_backward_reduce(dy_full, x, l_mean, l_inv, weight, True, True, True)
            library_calls = {
                "bn_stats": lambda: torch.batch_norm_stats(x, eps),
                k2: lambda: torch.batch_norm_elemt(x, weight, bias, l_mean, l_inv, eps),
                k3: lambda: torch.batch_norm_backward_reduce(dy_full, x, l_mean, l_inv, weight, True, True, True),
                k4: lambda: torch.batch_norm_backward_elemt(dy_full, x, l_mean, l_inv, weight, l_sg, l_sgx, count),
            }
            for k, call in library_calls.items():
                out[k][4] = cuda_ms(call, reps)
            # beside K1 + K2 and K3 + K4: F.batch_norm's whole training forward and its autograd backward
            rm, rv = torch.zeros(C, device=device), torch.ones(C, device=device)
            xl = x.detach().requires_grad_(True)
            wl, bl = weight.detach().requires_grad_(True), bias.detach().requires_grad_(True)
            yl = F.batch_norm(xl, rm, rv, wl, bl, training=True, eps=eps)
            whole = {"forward": cuda_ms(lambda: F.batch_norm(x, rm, rv, weight, bias, training=True, eps=eps), reps),
                     "backward": cuda_ms(lambda: torch.autograd.grad(yl, (xl, wl, bl), dy_full, retain_graph=True),
                                         reps)}
            summary += (f"; F.batch_norm whole training forward {whole['forward'] * 1e3:.1f} us against K1 + K2's "
                        f"{(out['bn_stats'][2] + out[k2][2]) * 1e3:.1f}, its backward "
                        f"{whole['backward'] * 1e3:.1f} against K3 + K4's "
                        f"{(out[k3][2] + out[k4][2]) * 1e3:.1f}")
            out["whole"] = whole
    return out, bad, summary


def phase_batchnorm(cfg, report, device="cuda"):
    """Phase 32: batch norm + ReLU's kernels (``csrc/batchnorm.cu``) with the
    layer around them against their plain versions on the card at every
    batch-norm site of a full-width forward and step, each with its
    prologue (the centred first layer, or the dense bias) and, at an SA
    layer's last width, the pool (K2's pool variant, K3 and K4 on the
    pooled cotangent), B=8 in f32 (the per-step sums) and bf16, B=1 in f32
    and bf16, and sa1's sites at B=64 in f32 and bf16: K2 and K4 bit-equal (the
    pool's maxima and counts too), K1 and K3 within BN_SUM_TOL and an f32
    ulp of torch's f64 sum (BN_F64_ULPS, BN_F64_FLOOR), every
    kernel's two runs bit-identical; device us of each kernel, of its plain
    version, of the eager passes it replaces and of its stage's own PyTorch
    call on the old inputs (x and a full dy; no ReLU, no pool), the bytes
    bound; a per-site table of K1-K4 against each site's bound; over the
    B=8 f32 sites also ``F.batch_norm``'s whole training forward and
    backward beside K1 + K2 and K3 + K4. Returns {kernel: {"ms_by_prologue",
    "eager_ms"}} of the B=8 f32 step's sums."""
    import torch

    print("phase 32: batch norm + ReLU kernels with their prologue and pool vs their plain versions on the card "
          "(CUDA events, warm L2); library: each stage's own call on the old inputs (x and a full dy), "
          "torch.batch_norm_stats, batch_norm_elemt, batch_norm_backward_reduce, batch_norm_backward_elemt "
          "(no ReLU, no pool in them)")
    print(TABLE_HEAD)
    sites = bn_sites(cfg)
    n_sites = sum(v for k, v in bn_launches(cfg, train=True).items() if k.startswith("bn_apply"))
    checks = {f"{len(sites)} sites in the layer list == bn_launches' {n_sites}": len(sites) == n_sites}
    cache = {}
    step = dict.fromkeys(("forward", "backward", "K1 + K2", "K3 + K4"), 0.0)  # B=8 f32 sums, ms
    extra = {k: {"ms_by_prologue": {"centre": 0.0, "bias": 0.0}, "eager_ms": 0.0} for k in BN_ROWS}
    pools = {}  # (kernel, dtype) -> [us, bound us] over the B=8 pooled sites
    table = []

    def run_case(B, layer, R, C, dtype, prologue, pooled, library):
        S = bn_slots(cfg, layer) if layer.startswith(("sa", "proposal")) and (pooled or prologue == "centre") else 1
        key = (R, C, dtype, prologue, S, pooled)
        if key not in cache:
            cache[key] = bn_check(R, C, dtype, seed=R + C, library=library, device=device, prologue=prologue, S=S,
                                  pooled=pooled)
            print(f"    {R}x{C} {str(dtype)[6:]} {prologue} prologue{', pooled over ' + str(S) if pooled else ''}: "
                  f"{cache[key][2]}")
            torch.cuda.empty_cache()
        res, bad, _ = cache[key]
        what = f"B={B} {layer} {R}x{C} {str(dtype)[6:]} {prologue}{' pool' if pooled else ''}"
        for msg in bad:
            checks[f"{what}: {msg}"] = False
        checks[f"{what}: every gate"] = not bad
        es = torch.tensor([], dtype=dtype).element_size()
        bounds = bn_bounds(R, C, es, es, S, prologue, pooled)
        if B == 8 and "whole" in res:
            k2, k3, k4 = ((BN_VARIANTS[k] if pooled else k) for k in ("bn_apply", "bn_bwd_reduce", "bn_bwd_apply"))
            step["forward"] += res["whole"]["forward"]
            step["backward"] += res["whole"]["backward"]
            step["K1 + K2"] += res["bn_stats"][2] + res[k2][2]
            step["K3 + K4"] += res[k3][2] + res[k4][2]
        row = [layer, f"{R}x{C}", f"{prologue}{' +pool' if pooled else ''}"]
        for k in BN_KERNELS:
            kk = BN_VARIANTS[k] if pooled and k in BN_VARIANTS else k
            ok, err, k_ms, p_ms, l_ms = res[kk]
            report(kk, layer, B, f"{R}x{C} {str(dtype)[6:]} {prologue[0]}{'p' if pooled else ''}", ok, err, k_ms,
                   p_ms, bounds[k], l_ms, total=dtype == torch.float32)
            if B == 8 and dtype == torch.float32 and k_ms is not None:
                extra[kk]["ms_by_prologue"][prologue] += k_ms
                extra[kk]["eager_ms"] += res["eager_ms"][kk]
                row += [k_ms * 1e3, max(bounds[k]) * 1e3]
            if B == 8 and pooled and kk in ("bn_apply_pool", "bn_bwd_reduce_pooled") and k_ms is not None:
                acc = pools.setdefault((kk, str(dtype)[6:]), [0.0, 0.0])
                acc[0] += k_ms * 1e3
                acc[1] += max(bounds[k]) * 1e3
        for k in BN_EXTRA:  # K4 with the epilogue, K2 with the group's statistics' end
            if k not in res:
                continue
            ok, err, k_ms, p_ms, l_ms = res[k]
            report(k, layer, B, f"{R}x{C} {str(dtype)[6:]} {prologue[0]}{'p' if pooled else ''}", ok, err, k_ms,
                   p_ms, bounds[k], l_ms, total=dtype == torch.float32)
            if B == 8 and dtype == torch.float32 and k_ms is not None:
                extra[k]["ms_by_prologue"][prologue] += k_ms
                if k == "bn_bwd_apply_sums":
                    row += [k_ms * 1e3, max(bounds[k]) * 1e3]
        if len(row) > 3:
            table.append(row)

    for B, dtypes in ((8, (torch.float32, torch.bfloat16)), (1, (torch.float32, torch.bfloat16))):
        for dtype in dtypes:
            for layer, rows, C, prologue, pooled in sites:  # every site; B=8 f32: the step's sums
                run_case(B, layer, B * rows, C, dtype, prologue, pooled, library=B == 8 and dtype == torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        for layer, rows, C, prologue, pooled in sites:
            if layer == "sa1":
                run_case(64, layer, 64 * rows, C, dtype, prologue, pooled, library=False)
                cache.clear()
                torch.cuda.empty_cache()
    print("  per site, B=8 f32, us against the bytes bound: K1 | K2 | K3 | K4 | K4 with the epilogue")
    for r in table:
        print(f"    {r[0]:<9} {r[1]:>13} {r[2]:<12} " + " | ".join(f"{k:8.1f} /{b:7.1f}" for k, b in zip(r[3::2], r[4::2])))
    print(f"  B=8 f32 step, {len(sites)} sites (us): F.batch_norm training forward {step['forward'] * 1e3:.1f} "
          f"against K1 + K2 {step['K1 + K2'] * 1e3:.1f}; its backward {step['backward'] * 1e3:.1f} against K3 + K4 "
          f"{step['K3 + K4'] * 1e3:.1f} (on the old inputs: x and a full dy)")
    for k, v in extra.items():
        print(f"  {k}: us by prologue {({p: round(ms * 1e3, 1) for p, ms in v['ms_by_prologue'].items()})}, "
              f"the eager passes it replaces {v['eager_ms'] * 1e3:.1f}")
    print("  the pool kernels over the B=8 step's pooled sites, us against the bound (half of the bound's rate: "
          "at most twice it):")
    for (k, dt), (us, bound) in sorted(pools.items()):
        print(f"    {k} {dt}: {us:.1f} against {bound:.1f} ({bound / max(us, 1e-9):.2f} of the bound; "
              f"{'within' if us <= 2 * bound else 'above'} twice it, {2 * bound:.1f})")
        extra[k][f"{dt}_us"], extra[k][f"{dt}_bound_us"] = us, bound
    finish(checks, "batch-norm kernel checks", None)
    return extra


def bn_library_sums(cfg):
    """``--bn-library``: K1 and K3 through the calls every checkout's wrappers
    take (x and dy alone: no prologue, no pool), device us at each
    batch-norm site's shape of a B=8 step under the checkout's launch plan,
    beside ``torch.batch_norm_stats`` and ``torch.batch_norm_backward_reduce``
    and the bytes bound, summed over the 23 sites. A copy of this file at the
    root of an earlier checkout times that checkout's kernels."""
    import torch

    from votenet_tpu_torch.ops.cuda import batchnorm as bnc

    g = torch.Generator(device="cuda").manual_seed(SEED)
    res, seen = {"sites": {}}, {}
    totals = dict.fromkeys(("k1", "k1_library", "k1_bound", "k3", "k3_library", "k3_bound"), 0.0)
    print("bn library: K1 and K3 (x and dy alone) beside their library calls, device us, B=8 sites; CUDA events, "
          "warm L2")
    for layer, rows, C, _, _ in bn_sites(cfg):
        R = 8 * rows
        if (R, C) not in seen:
            x = torch.randn((R, C), generator=g, device="cuda") * 3 + 1
            dy = torch.randn((R, C), generator=g, device="cuda")
            mean, mul = x.mean(0), torch.rand(C, generator=g, device="cuda") + 0.5
            bias = torch.randn(C, generator=g, device="cuda")
            lm, li = torch.batch_norm_stats(x, 1e-5)
            w = torch.ones(C, device="cuda")
            b = bn_bounds(R, C, 4, 4)
            seen[(R, C)] = {
                "k1": cuda_ms(lambda: bnc.bn_stats_cuda(x), 20) * 1e3,
                "k1_library": cuda_ms(lambda: torch.batch_norm_stats(x, 1e-5), 20) * 1e3,
                "k1_bound": max(b["bn_stats"]) * 1e3,
                "k3": cuda_ms(lambda: bnc.bn_bwd_reduce_cuda(x, dy, mean, mul, bias, True), 20) * 1e3,
                "k3_library": cuda_ms(lambda: torch.batch_norm_backward_reduce(dy, x, lm, li, w, True, True, True),
                                      20) * 1e3,
                "k3_bound": max(b["bn_bwd_reduce"]) * 1e3}
            del x, dy
        site = seen[(R, C)]
        for k, v in site.items():
            totals[k] += v
        res["sites"][f"{layer} {R}x{C}"] = site
        print(f"  {layer:<9} {R}x{C}: " + ", ".join(f"{k} {v:.1f}" for k, v in site.items()))
    res["totals"] = totals
    print("  sum over the sites: " + ", ".join(f"{k} {v:.1f}" for k, v in totals.items()))
    print(json.dumps({"bn_library": res}))


# The kernels whose SASS ``--sass`` reads (csrc/batchnorm.cu's pool kernels,
# f32 and bf16 in and out): the rows a thread takes an iteration of its
# innermost row loop, by the channels a lane (V)
SASS_ROWS = {"bn_apply_pool": {4: 4, 8: 4}, "bn_bwd_reduce_pooled": {4: 2, 8: 4}}


def sass_functions(text: str) -> dict:
    """cuobjdump -sass's text as {mangled name: [(address, instruction)]}."""
    import re

    out = {}
    for sec in text.split("Function : ")[1:]:
        name, body = sec.split("\n", 1)
        out[name.strip()] = [(int(m.group(1), 16), m.group(2).strip())
                             for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", body)]
    return out


def sass_hot_loop(ins) -> tuple[int, dict]:
    """The innermost loop (a backward branch whose range holds no other) with
    the most instructions: (its static instruction count, counts by opcode).
    Static: a branch taken rarely inside it (a unit's reload) counts too."""
    import collections
    import re

    loops = []
    for addr, text in ins:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [lp for lp in loops if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return 0, {}
    lo, hi = max(inner, key=lambda lp: lp[1] - lp[0])
    body = [t for a, t in ins if lo <= a <= hi]
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0] for t in body)
    return len(body), dict(ops)


def bn_sass(lib_path=None) -> dict:
    """``--sass``: SASS instructions an element of the pool kernels' hot row
    loops (K2's pool variant, the pooled K3; f32 and bf16, as built for this
    checkout): the innermost loop's static instructions over the elements an
    iteration takes (``SASS_ROWS`` rows x V channels), and its conversions
    (F2F: the conversion unit, 16 a clock an SM on Hopper; F2FP: the packed
    bf16 rounding). A copy of this file at the root of an earlier checkout
    reads that checkout's library."""
    import re
    import subprocess

    from votenet_tpu_torch.ops.cuda import build

    lib_path = lib_path or build()
    cuobjdump = os.path.join(os.path.dirname(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    res = {}
    for name, ins in sass_functions(text).items():
        m = re.search(r"(bn_apply_pool|bn_bwd_reduce)_kernelI(ff|13__nv_bfloat16S1_)Li(\d)E(Lb1E)?", name)
        if not m or (m.group(1) == "bn_bwd_reduce" and not m.group(4)):
            continue
        kernel = "bn_apply_pool" if m.group(1) == "bn_apply_pool" else "bn_bwd_reduce_pooled"
        V = int(m.group(3))
        if V == 1:
            continue
        n, ops = sass_hot_loop(ins)
        elements = SASS_ROWS[kernel][V] * V
        key = f"{kernel} {'f32' if m.group(2) == 'ff' else 'bf16'} V={V}"
        res[key] = {"loop_instructions": n, "elements": elements, "per_element": n / elements,
                    "f2f_per_element": sum(v for k, v in ops.items() if k.startswith("F2F.")) / elements,
                    "f2fp_per_element": sum(v for k, v in ops.items() if k.startswith("F2FP")) / elements,
                    "top": sorted(ops.items(), key=lambda kv: -kv[1])[:8]}
        print(f"  {key}: {n} instructions in the hot loop / {elements} elements = {n / elements:.2f} an element "
              f"(F2F {res[key]['f2f_per_element']:.2f}, F2FP {res[key]['f2fp_per_element']:.2f}); "
              f"top {res[key]['top']}")
    print(json.dumps({"bn_sass": res}))
    return res


def bn_eval_host_us(cfg, n=100):
    """Host us a call of the eval batch norm + ReLU, summed over the sites
    that samlp leaves to it in an f32 forward (fp1, fp2, voting, mlp2) at
    B=8, under ``torch.inference_mode``: the call as the model makes it,
    ``bn(h, relu=True, dense_bias=b)`` where ``BatchNorm.forward`` takes
    the dense bias, ``bn(x, relu=True)`` where it takes ``relu`` (the fused
    op), else ``torch.relu(bn(x))`` (earlier checkouts), beside
    the eager formula written out here, which every checkout runs alike (the
    host's speed in this run). n calls queued after a warm-up, the clock
    stopped before the sync: the enqueueing's cost."""
    import inspect

    import torch

    from votenet_tpu_torch.models.pointnet2 import BatchNorm

    res = {"model_call": 0.0, "eager_formula": 0.0}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for layer, rows, C, _, _ in bn_sites(cfg):
        if layer not in ("fp1", "fp2", "voting", "mlp2"):
            continue
        bn = BatchNorm(C).cuda()
        x = torch.randn((8, rows, C), generator=g, device="cuda")
        params = inspect.signature(bn.forward).parameters
        db = torch.zeros(C, device="cuda")
        calls = {"model_call": ((lambda: bn(x, relu=True, dense_bias=db)) if "dense_bias" in params
                                else (lambda: bn(x, relu=True)) if "relu" in params else (lambda: torch.relu(bn(x)))),
                 "eager_formula": lambda: torch.relu(
                     ((x - bn.running_mean) * (torch.rsqrt(bn.running_var + bn.eps) * bn.weight)) + bn.bias)}
        with torch.inference_mode():
            for k, call in calls.items():
                call()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                res[k] += (time.perf_counter() - t0) * 1e6 / n
                torch.cuda.synchronize()
    return res


def launch_tally(names) -> dict:
    """Device launches by short name (a kernel's function name, a memset's
    or memcpy's), most first, and their total."""
    import collections
    import re

    short = [(re.search(r"(\w+_kernel)\b", n) or re.search(r"(\w+)", n)).group(1) for n in names]
    return {"total": len(short), "by_name": dict(collections.Counter(short).most_common())}


def host_and_launches(fn, n=10):
    """One call of ``fn`` under the profiler (its device launches), then n
    calls each timed on the host clock until ``fn`` returns, before the
    device sync: (launch_tally, [host ms]). The host's cost of enqueueing."""
    import torch

    tally = launch_tally(device_kernel_names(fn))
    host = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return tally, host


def e2e_times(cfg, scenes, state_dict, reps=3):
    """``--e2e-times``: the end-to-end figures batch norm moves, through
    public names only, so that a copy of this file at the root of an
    earlier checkout times that checkout with the same code: B=8 serving
    requests and B=1 ``detect()`` (host ms), B=8 training steps in f32 and
    in phase 15's bf16 and mixed throughput presets (ms, peak device memory,
    torch.profiler's kernel time by group over 3 steps), the 16-scene eval
    at B=8 with samlp off and on (scenes/s, a profiled pass each), and the
    host us of the batch norm + ReLU calls left in eval with samlp on. Each
    through the helpers of phases 4, 7 and 10. Beside them the device
    launches (torch.profiler) and the host ms until the call returns of one
    B=8 training step in each mode (``make_train_step``) and of one B=8
    serving forward (``VoteNet`` under ``torch.inference_mode``)."""
    import torch

    from votenet_tpu_torch.config import throughput_config
    from votenet_tpu_torch.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu_torch.eval import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models import VoteNet
    from votenet_tpu_torch.predictor import VoteNetPredictor
    from votenet_tpu_torch.train import make_train_step

    res = {}
    predictor = VoteNetPredictor(cfg, device="cuda", batch_size=8, generator=torch.Generator().manual_seed(SEED))
    requests, detects = serve_times(predictor, scenes, 5 * reps)
    res["serve_b8_ms"] = [ms for ms, _, _ in requests]
    res["detect_b1_ms"] = [ms for ms, _, _ in detects]
    points = torch.as_tensor(np.stack([s["points"] for s in scenes[:8]])).cuda()
    with torch.inference_mode():
        tally, host = host_and_launches(lambda: predictor.model(points))
    res["forward_b8_host_ms"] = host
    res["forward_b8_launches"] = tally["total"]
    print(f"  a B=8 serving forward: {tally['total']} device launches, by name {tally['by_name']}")
    del predictor
    for name, tcfg in (("f32", cfg), *((m, throughput_config(**o)) for m, o in PRECISION_MODES.items())):
        trainer, batch, steps, peak_gib, _ = train_times(tcfg, scenes, 5 * reps)
        res[f"train_{name}_ms"] = [ms for ms, _ in steps]
        res[f"train_{name}_peak_gib"] = peak_gib
        step = make_train_step(tcfg)
        tally, host = host_and_launches(lambda: step(trainer.state, batch))
        res[f"train_{name}_host_ms"] = host
        res[f"train_{name}_launches"] = tally["total"]
        print(f"  a B=8 training step, {name}: {tally['total']} device launches, by name {tally['by_name']}")
        profile_device(lambda: trainer.train_epoch([batch] * 3, metrics_every=3),
                       f"3 training steps at B=8, {name} (--e2e-times)")
        del trainer
        torch.cuda.empty_cache()
    eval_scenes = synthetic_scenes(SEED, cfg, EVAL_SCENES)
    gt_all = synthetic_gt_all(eval_scenes)
    cache = DeviceSceneCache([(int(s["data_idx"]), s["points"]) for s in eval_scenes], 8, "cuda")
    ev = Evaluator(cfg, gt_all, batch_size=8)
    for samlp in ("off", "on"):
        model = VoteNet(cfg.replace(samlp=samlp))
        model.load_state_dict(state_dict)
        model.cuda()
        predict = make_packed_predict_fn(model, cfg)
        seconds, _, _ = eval_passes(ev, predict, cache, 3 * reps)
        res[f"eval_samlp_{samlp}_scenes_s"] = [EVAL_SCENES / sec for sec in seconds]
        profile_device(lambda: ev.predictions_for_scenes(predict, cache),
                       f"eval, samlp {samlp}, {EVAL_SCENES} scenes at B=8 (--e2e-times)")
    for k, us in bn_eval_host_us(cfg).items():
        res[f"eval_bn_host_us_{k}"] = us
    for k, v in res.items():
        if isinstance(v, list):
            print(f"  {k}: median {float(np.median(v)):.3f}, range {min(v):.3f}-{max(v):.3f}")
        else:
            print(f"  {k}: {v:.3f}")
    print(json.dumps({"e2e_times": res}))


def dump_outputs(cfg, scenes, state_dict, path):
    """``--outputs PATH``: what the kernels feed, through public names, saved
    with torch.save for ``--compare-outputs`` against another checkout's (a
    copy of this file at its root writes its own): in f32 and in the bf16
    and mixed throughput presets, a B=8 serving forward's end points and
    ``predict_boxes``' outputs, the keep masks among them (seed-SEED
    weights); one B=8 training step from the seed-SEED state
    (``forward_backward``): every gradient leaf, the running statistics and
    the losses, twice from a fresh state (the rerun's bits); the same f32
    step through the data-parallel path on a one-rank NCCL group (the
    batch-norm sums all-reduced, the gradient all-reduce; phase 19's); and
    the committed checkpoint's eval predictions of scenes[:8] (samlp off
    and on). Deterministic algorithms on: the scatter's and the gather's
    library backwards are atomic otherwise."""
    import torch
    import torch.distributed as dist

    from votenet_tpu_torch.config import throughput_config
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.eval import make_packed_predict_fn
    from votenet_tpu_torch.models import VoteNet, predict_boxes
    from votenet_tpu_torch.parallel import comm, make_mesh
    from votenet_tpu_torch.parallel.launch import free_port, init_process_group
    from votenet_tpu_torch.train import create_train_state, forward_backward

    out = {}
    points = torch.as_tensor(np.stack([s["points"] for s in scenes[:8]])).cuda()

    def step(c, key, group=None):
        state = create_train_state(c, 512, torch.Generator().manual_seed(SEED), device="cuda")
        losses = forward_backward(state.model, batch, c, group=group)
        comm.all_reduce_((p.grad for p in state.model.parameters()), group)
        out.update({f"{key}/loss/{k}": v.detach().cpu() for k, v in losses._asdict().items()})
        out.update({f"{key}/grad/{n}": p.grad.cpu() for n, p in state.model.named_parameters()})
        out.update({f"{key}/stats/{n}": b.cpu() for n, b in state.model.named_buffers() if "running" in n})

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, c in (("f32", cfg), *((m, throughput_config(**o)) for m, o in PRECISION_MODES.items())):
            model = VoteNet(c, torch.Generator().manual_seed(SEED)).cuda().eval()
            with torch.inference_mode():
                ep = model(points)
                head = predict_boxes(ep, c)
            out.update({f"serve_{name}/{k}": v.cpu() for k, v in ep.items() if torch.is_tensor(v)})
            out.update({f"serve_{name}/head/{k}": v.cpu() for k, v in head.items()})
            del model
            batch = next(batch_scenes(iter(scenes[:8]), 8, c.max_gt_boxes))
            for run in ("", "_rerun"):
                step(c, f"train_{name}{run}")
        init_process_group("nccl", 1, 0, free_port(), 300)
        try:
            batch = next(batch_scenes(iter(scenes[:8]), 8, cfg.max_gt_boxes))
            step(cfg, "train_dp_f32", make_mesh().group("data"))
        finally:
            dist.destroy_process_group()
        for samlp in ("off", "on"):
            model = VoteNet(cfg.replace(samlp=samlp))
            model.load_state_dict(state_dict)
            pred = make_packed_predict_fn(model.cuda(), cfg)(points)
            out.update({f"eval_samlp_{samlp}/{k}": v.cpu() for k, v in pred.items()})
    finally:
        torch.use_deterministic_algorithms(False)
    torch.save(out, path)
    print(f"  {len(out)} tensors to {path}")


def bit_equal(a, b) -> bool:
    """The same shape, dtype and bits (NaNs at the same places)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(ints)[~nan], b.view(ints)[~nan])


def compare_outputs(path_a, path_b):
    """``--compare-outputs A B``: ``--outputs`` files of two checkouts (A the
    earlier). Every tensor of A must be in B and bit-equal (serving end
    points and the head's outputs, every gradient leaf, running statistic
    and loss of each step, the data-parallel step's, the eval predictions),
    and B's rerun bit-equal to B's run; the tensors that differ are printed
    by group with their largest gaps."""
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    checks, moved = {}, {}
    for k, va in a.items():
        vb = b.get(k)
        if vb is None:
            checks[f"{k} in both"] = False
            continue
        checks[f"{k} bit-equal"] = bit_equal(va, vb)
        if not checks[f"{k} bit-equal"] and va.shape == vb.shape:
            moved[k] = float((va.double() - vb.double()).abs().max())
    for k in b:
        if "_rerun/" in k:
            checks[f"{k} rerun bit-equal"] = bit_equal(b[k], b[k.replace("_rerun/", "/")])
    groups = {}
    for k in a:
        groups.setdefault("/".join(k.split("/")[:2]), []).append(k)
    print(f"  {sum(v for v in checks.values())} of {len(checks)} checks hold; tensors compared by group: "
          f"{ {g: len(v) for g, v in groups.items()} }")
    for k in sorted(moved, key=lambda k: -moved[k])[:12]:
        print(f"    differs: {k} (max |A - B| {moved[k]:.3g})")
    finish(checks, "outputs against the other checkout", None)


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
    variants = ("samlp_bf16", "ballquery_emit_xyz", "fps_noscalar", "ballquery_fast_bf16")
    stats = {k: {"err": 0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "ops_ms": 0.0, "bytes_ms": 0.0,
                 "bound_ms": 0.0}
             for k in ("fps", "ballquery", "scatter", "samlp", "scatter_fast_bf16", "nms3d", "decode_iou", "iou3d",
                       "decode")
             + variants + BN_ROWS}
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

    if "--head-times" in sys.argv[1:]:  # the head alone, public names only: to set beside another checkout's
        state_dict = run("read checkpoint", trained_state_dict)
        if state_dict is not None:
            run("head times", lambda: head_times(cfg, scenes, state_dict))
        print(card)
        return 1 if failed else 0
    if "--e2e-times" in sys.argv[1:]:  # serving, training and eval alone, public names only
        state_dict = run("read checkpoint", trained_state_dict)
        if state_dict is not None:
            run("end-to-end times", lambda: e2e_times(cfg, scenes, state_dict))
        print(card)
        return 1 if failed else 0
    if "--bn" in sys.argv[1:]:  # phase 32 alone: batch norm's kernels, gates and times (also an earlier checkout's)
        run("batch-norm kernels", lambda: phase_batchnorm(cfg, report))
        print(json.dumps({"bn_times": {k: {"ms": stats[k]["ms"], "bound_ms": stats[k]["bound_ms"]} for k in BN_ROWS},
                          "failed": failed}))
        print(card)
        return 1 if failed else 0
    if "--outputs" in sys.argv[1:]:  # what batch norm feeds, saved for --compare-outputs
        state_dict = run("read checkpoint", trained_state_dict)
        if state_dict is not None:
            run("outputs", lambda: dump_outputs(cfg, scenes, state_dict, sys.argv[sys.argv.index("--outputs") + 1]))
        print(card)
        return 1 if failed else 0
    if "--compare-outputs" in sys.argv[1:]:
        i = sys.argv.index("--compare-outputs")
        run("compare outputs", lambda: compare_outputs(sys.argv[i + 1], sys.argv[i + 2]))
        return 1 if failed else 0
    if "--sass" in sys.argv[1:]:  # SASS instructions an element of the pool kernels' hot loops
        run("sass", bn_sass)
        print(card)
        return 1 if failed else 0
    if "--bn-library" in sys.argv[1:]:  # K1 and K3 beside their library calls, through calls every checkout takes
        run("bn library", lambda: bn_library_sums(cfg))
        print(card)
        return 1 if failed else 0
    if "--multi-device" in sys.argv[1:]:  # phases 19-21 alone: their costs in a process that ran no other phase
        run("distributed path, one NCCL rank", lambda: phase_dp_world1(cfg, scenes, profile_launches=True))
        run("two ranks on one card", lambda: phase_two_ranks(cfg, scenes))
        print(card)
        return 1 if failed else 0
    run("kernels", lambda: phase_kernels(cfg, scenes, report))
    bn_extra = {}
    if importlib.util.find_spec("votenet_tpu_torch.ops.cuda.batchnorm") is not None:  # absent in earlier checkouts
        bn_extra = run("batch-norm kernels", lambda: phase_batchnorm(cfg, report)) or {}
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
        if hasattr(bq_mod.query_ball_point_cuda, "fast_bf16"):
            run("ball query fast_bf16", lambda: phase_bq_fast(cfg, scenes, report, production_ms))
        if state_dict is not None and os.path.exists(Path(bq_mod.__file__).with_name("decode.py")):
            # the head's kernels as this file calls them (an earlier checkout: --head-times)
            if "decode_iou_cuda" in Path(bq_mod.__file__).with_name("decode.py").read_text():
                run("decode kernel", lambda: phase_decode(cfg, scenes, state_dict, report))
            run("nms kernel", lambda: phase_nms(cfg, scenes, state_dict, report, kernels_only=True))
            run("iou kernel", lambda: phase_iou(cfg, scenes, state_dict, report))
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
    # phases 19-21: multi-device training, each path's counts from 0 (phases 20-21: rank 0's)
    paths["dp_world1_nccl_step"] = run("distributed path, one NCCL rank",
                                       lambda: phase_dp_world1(cfg, scenes, profile_launches=True))
    paths.update(run("two ranks on one card", lambda: phase_two_ranks(cfg, scenes)) or {})
    # phases 31 and 22-25: the head's kernels, the fast_bf16 ball query, remat, the dead paths
    head = {}
    if state_dict is not None:
        head = run("decode kernel", lambda: phase_decode(cfg, scenes, state_dict, report)) or {}
        run("nms kernel", lambda: phase_nms(cfg, scenes, state_dict, report))
    paths.update(run("ball query fast_bf16", lambda: phase_bq_fast(
        cfg, scenes, report, production_ms, state_dict=state_dict, f32_maps=f32_maps)) or {})
    paths.update(run("remat", lambda: phase_remat(scenes, bare_step_ms)) or {})
    run("dead paths", lambda: phase_dead_paths(scenes))
    # phases 26-30: the IoU kernel, NMS past 1024 boxes, the streaming forms, bf16_hilo, steps_per_dispatch
    iou_launches = None
    if state_dict is not None:
        iou_launches = run("iou kernel", lambda: phase_iou(cfg, scenes, state_dict, report))
    run("nms past 1024 boxes", lambda: phase_nms_long(report))
    run("streaming forms", lambda: phase_streaming(cfg, scenes))
    if state_dict is not None:
        paths.update(run("bf16_hilo gather packing", lambda: phase_packing(scenes, state_dict, bare_step_ms)) or {})
    paths.update(run("steps_per_dispatch", phase_dispatch) or {})

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
    # 3 passes of 2 forwards) stand beside it for FPS and the ball query; samlp's is the
    # eval path's; launches_fit: run_train's (phase 11, 6 steps and 1 eval
    # forward); launches_paths: the paths of phases 14-15 (bf16 and mixed
    # serving, eval and training; run_train --preset=throughput) and 19-21
    # (one distributed step on a one-rank NCCL group; rank 0's dp=2 step,
    # sharded ops and sp forward over gloo). The fast
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
    kernels += [
        # the port's own kernels, for paths the JAX package runs without a
        # Pallas kernel: launches on the serving path (phase 4: 6 forwards,
        # one NMS each) and phase 23's serving forward under the mode
        {
            "name": "nms3d", "route": "cuda", "source": "votenet_tpu_torch/csrc/nms3d.cu",
            "replaces": "votenet_tpu/ops/nms3d.py:40 _jacobi_greedy (lax.while_loop, no Pallas kernel)",
            "launches": launches["nms"], "launches_eval": eval_launches["on"]["nms"],
            "launches_paths": path_launches("nms"), **measured("nms3d"), "tolerance": 0,
            "ms_is": "the greedy of one B=8 forward of the trained checkpoint",
        },
        {
            "name": "decode_iou", "route": "cuda", "source": "votenet_tpu_torch/csrc/iou3d.cu",
            "replaces": ("votenet_tpu/models/decode.py:44 decode_proposals + votenet_tpu/ops/iou3d.py:350 "
                         "box3d_iou_matrix (XLA, no Pallas kernel)"),
            "variant": "decode_iou_kernel: the decode (csrc/decode.cuh) inside the IoU self-matrix's tiles",
            "launches": launches["decode_iou"], "launches_eval": eval_launches["on"]["decode_iou"],
            "launches_paths": path_launches("decode_iou"), **measured("decode_iou"),
            "replaced_ms": head["replaced_ms"], "tolerance": 0,
            "ms_is": "the decode and the IoU self-matrix of one B=8 forward of the trained checkpoint; replaced_ms: "
                     "the decode kernel and the IoU kernel's triangle on the same end points",
        },
        {
            "name": "iou3d", "route": "cuda", "source": "votenet_tpu_torch/csrc/iou3d.cu",
            "replaces": "votenet_tpu/ops/iou3d.py:350 box3d_iou_matrix (XLA, no Pallas kernel)",
            "variant": "ops.box3d_iou_matrix alone (ops.nms3d); the head takes decode_iou",
            "launches": iou_launches, "launches_serve": launches["iou3d"], **measured("iou3d"), "tolerance": 0,
            "ms_is": "the IoU self-matrix (its triangle) of one B=8 forward of the trained checkpoint; launches: "
                     "phase 26's checks",
        },
        {
            "name": "decode", "route": "cuda", "source": "votenet_tpu_torch/csrc/decode.cu",
            "replaces": "votenet_tpu/models/decode.py:44 decode_proposals (XLA, no Pallas kernel)",
            "variant": "decode_proposals alone; the head takes decode_iou",
            "launches": head["launches"]["decode"], "launches_serve": launches["decode"], **measured("decode"),
            "tolerance": 0,
            "ms_is": "the decode of one B=8 forward of the trained checkpoint; launches: phase 31's checks",
        },
        {
            "name": "ballquery_fast_bf16", "route": "cuda", "source": "votenet_tpu_torch/csrc/ballquery.cu",
            "replaces": "votenet_tpu/ops/grouping.py:144 _query_ball_point_dense, fast_bf16 (no Pallas kernel)",
            "variant": "bq_precision=fast_bf16 (ballquery_kernel<false, true>)",
            "launches": paths["serve_bq_fast_bf16"]["ballquery_fast_bf16"],
            "launches_paths": path_launches("ballquery_fast_bf16"), **measured("ballquery_fast_bf16"),
            "production_ms": production_ms["ballquery_fast_bf16"], "tolerance": 0,
            "ms_is": "sum over the 5 main-path shapes at B=8",
        },
    ]
    # batch norm + ReLU with its prologue and pool (phase 32): launches on
    # the training path (phase 7, 3 steps), serving (phase 4, 6 forwards),
    # eval with samlp on and off (phase 10, 3 passes of 2 forwards each),
    # run_train (phase 11) and the other paths; the prologue's launches (any
    # stage) are bn_prologue_centre and bn_prologue_bias in each path's counts
    f64_tol = f"; and 2^-23 of |sum| + 2^-40 of the sum of |terms| from torch's f64 sum of the same terms"
    bn_tolerance = {"bn_stats": f"{BN_SUM_TOL} of each channel's sum of |x|{f64_tol}", "bn_apply": 0,
                    "bn_apply_pool": 0, "bn_bwd_reduce": f"{BN_SUM_TOL} of each channel's sum of |terms|{f64_tol}",
                    "bn_bwd_reduce_pooled": f"{BN_SUM_TOL} of each channel's sum of |terms|{f64_tol}",
                    "bn_bwd_apply": 0, "bn_bwd_apply_pooled": 0,
                    "bn_bwd_apply_sums": "dx 0; the prologue's cotangents 2^-23 (bf16 2^-7) of |sum| + 2^-40 of the "
                                         "sum of |terms| from torch's f64 sum of the same rounded dx",
                    "bn_apply_group": 0}
    bn_library = {"bn_stats": "torch.batch_norm_stats on x (mean and invstd)",
                  "bn_apply": "torch.batch_norm_elemt on x (no ReLU)",
                  "bn_apply_pool": "torch.batch_norm_elemt on x (no ReLU, no pool)",
                  "bn_bwd_reduce": "torch.batch_norm_backward_reduce on x and dy (no ReLU mask)",
                  "bn_bwd_reduce_pooled": "torch.batch_norm_backward_reduce on x and the full dy (no mask, no pool)",
                  "bn_bwd_apply": "torch.batch_norm_backward_elemt on x and dy (no ReLU mask)",
                  "bn_bwd_apply_pooled": "torch.batch_norm_backward_elemt on x and the full dy (no mask, no pool)",
                  "bn_bwd_apply_sums": "the two torch sums the epilogue replaces, dx.sum(0) and (-dx).sum(-2), "
                                       "beside K4 (bn_bwd_apply's ms)",
                  "bn_apply_group": "none: no one PyTorch call computes the statistics' end and the normalisation"}
    bn_variant = {"bn_apply_pool": "K2 with the max over the ball's slots and the tie counts (bn_apply_pool_kernel)",
                  "bn_bwd_reduce_pooled": "K3 on the pooled cotangent, the max and the counts",
                  "bn_bwd_apply_pooled": "K4 on the pooled cotangent, the max and the counts",
                  "bn_bwd_apply_sums": "K4 (either form) with the epilogue: corr's and the dense bias's cotangents",
                  "bn_apply_group": "K2 (either form) running the statistics' end from a data-parallel group's "
                                    "all-reduced sums, in place of the end's own one-CTA kernel (launches: phase "
                                    "19's distributed step)"}
    bn_sites_of = {k: "5 pooled" if k.endswith(("_pool", "_pooled")) else "18" if k in BN_KERNELS[1:] else "23"
                   for k in BN_ROWS}
    kernels += [
        {
            "name": k, "route": "cuda", "source": "votenet_tpu_torch/csrc/batchnorm.cu",
            "replaces": ("votenet_tpu/models/pointnet2.py:103,166 CenteredDense/nn.Dense bias + nn.BatchNorm + "
                         "nn.relu" + (" + jnp.max (:540)" if k.endswith(("_pool", "_pooled")) else "")
                         + " (flax, XLA; no Pallas kernel)"),
            **({"variant": bn_variant[k]} if k in bn_variant else {}),
            "launches": (paths["dp_world1_nccl_step"][k] if k == "bn_apply_group" else train_launches[k]),
            "launches_serve": launches[k], "launches_eval": eval_launches["on"][k],
            "launches_eval_samlp_off": eval_launches["off"][k], "launches_fit": fit_launches[k],
            "launches_paths": path_launches(k), **measured(k), "tolerance": bn_tolerance[k],
            "library_is": bn_library[k], **bn_extra.get(k, {}),
            "ms_is": (f"sum over the {bn_sites_of[k]} "
                      "batch-norm sites of a B=8 training step, f32, each with its prologue; eager_ms: the eager "
                      "passes the fusion replaces there (the prologue's, and the pool's K2 + torch.amax)"),
        }
        for k in BN_ROWS
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
