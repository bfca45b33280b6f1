"""Optimizer and learning-rate schedule of the reference recipe (port of
votenet_tpu/train/optimizer.py).

Every gradient goes through ``tf.clip_by_average_norm(grad, 0.5)`` per
tensor, then Adam (b1 0.9, b2 0.999, eps 1e-8) at a piecewise-constant rate:
1e-3, 1e-4 after epoch 80, 1e-5 after epoch 120 (model.py:240-250,
run.py:113,126). ``torch.optim.Adam``'s update, ``lr * m_hat / (sqrt(v_hat)
+ eps)`` with both moments bias-corrected, is ``optax.scale_by_adam``
followed by ``optax.scale_by_learning_rate``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence, Tuple

import numpy as np
import torch

from votenet_tpu.config import Config


@torch.no_grad()
def clip_by_average_norm_(params: Iterable[torch.nn.Parameter], clip_norm: float) -> None:
    """Per-tensor ``tf.clip_by_average_norm``, in place on each ``.grad``:
    ``g *= min(1, clip_norm * numel / max(||g||_2, 1e-30))``, in f32 on the
    gradient's device (no host sync)."""
    for p in params:
        g = p.grad
        if g is None:
            continue
        l2 = torch.sqrt(torch.sum(g * g))
        scale = torch.clamp(clip_norm * g.numel() / torch.clamp(l2, min=1e-30), max=1.0)
        g.mul_(scale)


def make_lr_schedule(
    base_lr: float, epoch_schedule: Sequence[Tuple[int, float]], steps_per_epoch: int
) -> Callable[[int], float]:
    """Step (0-based, optax's count before its increment) -> learning rate.

    Tensorpack's ScheduledHyperParamSetter sets a value after its epoch
    completes, so (80, 1e-4) rules from step 80 * steps_per_epoch on. The
    rate is optax's ``piecewise_constant_schedule`` value, rounded as it
    rounds: each boundary passed multiplies the f32 rate by the f32 ratio
    ``lr / previous lr``.
    """
    prev = [base_lr] + [lr for _, lr in epoch_schedule[:-1]]
    bounds = sorted((int(e) * steps_per_epoch, lr / p) for (e, lr), p in zip(epoch_schedule, prev))

    def schedule(step: int) -> float:
        v = np.float32(base_lr)
        for threshold, scale in bounds:
            if step >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


def make_optimizer(config: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    """Adam at the reference's betas and eps. The rate is set on the param
    group before every step from the schedule (``train.loop``); the clip
    runs on the gradients before it (:func:`clip_by_average_norm_`)."""
    return torch.optim.Adam(params, lr=config.base_lr, betas=(0.9, 0.999), eps=1e-8)
