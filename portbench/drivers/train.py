"""Training steps: ``Trainer.train_epoch`` over host batches at ``fit``'s
cadence (the metrics fetched every ``metrics_every`` steps).

Traffic keys: ``batch`` (scenes a step), ``pool`` (distinct host batches,
cycled), ``metrics_every``, ``weights``, ``trace_steps``. Set-up builds one
``TrainState`` from the benchmark's weights and drives it through the
first three steps, each a ``train_epoch`` call over one batch of the pool
(rows that all differ), then ``warm_steps`` more; the window goes on with
the same trainer. The reference follows the first three steps from the
same weights on the same batches. The unit of the per-layer numbers is one
step.
"""

from __future__ import annotations

import contextlib
import sys
import time

import torch

from portbench.drivers import common
from portbench.harness import Cell, Spans, peak_bytes, program_config, sync, traced
from portbench.reference import votenet_ref
from portbench.yardstick.compare import training_numbers
from portbench.yardstick.scenes import labels, make_scenes
from portbench.yardstick.stats import rate

CHECKED_STEPS = 3


def host_batches(cell: Cell, seed: int, device):
    """The pool: ``pool`` host batches of ``batch`` scenes (numpy, as the
    input pipeline hands them over)."""
    B, P = cell.traffic["batch"], cell.traffic["pool"]
    sc = make_scenes(seed, B * P, cell.model, device)
    pts = sc["points"].cpu().numpy()
    lab = labels(sc, cell.model)
    return [dict({k: v[i * B:(i + 1) * B] for k, v in lab.items()}, points=pts[i * B:(i + 1) * B])
            for i in range(P)]


def program_steps(cell: Cell, sd, batches, device, break_batch=None, break_step=False):
    """A ``Trainer`` on the benchmark's weights, stepped through
    ``CHECKED_STEPS`` calls of ``train_epoch``: (trainer, its readings).
    ``break_batch`` / ``break_step`` plant a fault (the control's and the
    tests' use)."""
    from votenet_tpu_torch.train.loop import Trainer
    from votenet_tpu_torch.train.state import create_train_state

    cfg = program_config(cell)
    state = create_train_state(cfg, steps_per_epoch=10 ** 9, device=device)
    common.load_into(state.model, sd)
    trainer = Trainer(cfg, state)
    if break_step:
        state.optimizer.step = lambda *a, **k: None
    params = dict(state.model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    grad = None
    every = cell.traffic["metrics_every"]
    for k in range(CHECKED_STEPS):
        b = batches[k] if break_batch is None else break_batch(batches[k])
        trainer.train_epoch([b], metrics_every=every)
        if grad is None:
            grad = {n: float(torch.linalg.vector_norm(state.optimizer.state[p]["exp_avg"].double()) / 0.1)
                    if p in state.optimizer.state else 0.0 for n, p in params.items()}
    losses = list(trainer.logger.moving.buffers["total_cost"])[-CHECKED_STEPS:]
    change = {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double())) for n, p in params.items()}
    return trainer, {"losses": losses, "grad": grad, "change": change}


def reference_steps(cell: Cell, sd, batches, device, low: str = "bfloat16", tf32: bool = False) -> dict:
    """The plain model's first three steps from the same weights on the same
    batches (``low``/``tf32``: the control's precision)."""
    params = {k: v.detach().clone() for k, v in sd.items()}
    dev_batches = [{k: torch.as_tensor(v).to(device) for k, v in b.items()} for b in batches[:CHECKED_STEPS]]
    losses, first, change = votenet_ref.train_steps(params, dev_batches, cell.model,
                                                    votenet_ref.Precision(cell.layer_dtypes, low),
                                                    CHECKED_STEPS, tf32=tf32)
    return {"losses": losses, "grad": votenet_ref.leaf_norms(first), "change": votenet_ref.leaf_norms(change)}


def run(cell: Cell, args, t_start: float, device, control=None) -> dict:
    tr = cell.traffic
    B, P, every = tr["batch"], tr["pool"], tr["metrics_every"]
    sd = common.weights(cell, args.seed, device)
    batches = host_batches(cell, args.seed, device)
    spans = Spans()
    # the training logger's lines go to standard error: the result is standard output's last line
    with contextlib.redirect_stdout(sys.stderr):
        trainer, program = program_steps(cell, sd, batches, device, **(control or {}))
        trainer.train_epoch(batches[CHECKED_STEPS:CHECKED_STEPS + tr["warm_steps"]], metrics_every=every)
        sync(device)
        setup_s = time.time() - t_start

        gaps = []

        def feed(deadline, first):
            i, last = first, None
            while True:
                now = time.perf_counter()
                if last is not None:
                    gaps.append(((now - last) * 1e3, i - first))
                last = now
                if now >= deadline:
                    return
                with spans("batch_handover"):
                    b = batches[i % P]
                yield b
                i += 1

        common.settle()
        t0 = time.perf_counter()
        fed = feed(t0 + args.seconds, CHECKED_STEPS)
        trainer.train_epoch(fed, metrics_every=every)
        sync(device)
        window_s = time.perf_counter() - t0
        steps = gaps[-1][1] if gaps else 0
        obs = common.observations(cell, "train", B, train=True)
        # the gap before step k+1's batch holds step k's host work, and the metrics' fetch after every
        # ``every``-th step: those are left out
        obs.update(host_ms=[g for g, k in gaps if k % every != 0 and k < steps], units=steps, window_s=window_s,
                   peak_bytes=peak_bytes(device))
        if args.trace:
            n = tr["trace_steps"]

            def stretch():
                with spans("train_epoch"):
                    trainer.train_epoch((batches[i % P] for i in range(n)), metrics_every=every)

            obs["trace"] = dict(traced(spans, stretch), units=n)
    del trainer
    common.free_memory()
    ref = reference_steps(cell, sd, batches, device)
    obs.update(e2e={"train_scenes_per_s": rate(steps * B, window_s), "setup_s": setup_s},
               attempted=steps, failed=0, numbers=training_numbers(program, ref))
    obs["numbers"]["steps_checked"] = CHECKED_STEPS
    return obs

