"""Train state: the model (parameters and batch-norm statistics), the
optimizer (Adam moments), the step count and the schedule (port of
votenet_tpu/train/state.py, which threads the same pieces as one pytree)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from votenet_tpu.config import Config
from votenet_tpu_torch.models.votenet import VoteNet
from votenet_tpu_torch.train.optimizer import make_lr_schedule, make_optimizer


def full_f32_matmuls() -> None:
    """Keep f32 matmuls and convolutions f32 on the card: no TF32, whose 10-bit
    mantissa would move the gradients off the JAX package's f32 ones."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class TrainState:
    model: VoteNet
    optimizer: torch.optim.Adam
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(
    config: Config,
    steps_per_epoch: int,
    generator: Optional[torch.Generator] = None,
    device: str | torch.device = "cpu",
) -> TrainState:
    """A VoteNet with weights drawn from ``generator`` (seed 0 when not
    given) on ``device``, Adam over its parameters, step 0."""
    full_f32_matmuls()
    model = VoteNet(config, generator).to(torch.device(device))
    return TrainState(
        model=model,
        optimizer=make_optimizer(config, model.parameters()),
        schedule=make_lr_schedule(config.base_lr, config.lr_schedule, steps_per_epoch),
    )
