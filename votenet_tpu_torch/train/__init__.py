"""Training: optimizer and schedule, train state, step and epoch loop."""

from votenet_tpu_torch.train.loop import Trainer, forward_backward, make_train_step, param_summary_scalars
from votenet_tpu_torch.train.optimizer import clip_by_average_norm_, make_lr_schedule, make_optimizer
from votenet_tpu_torch.train.state import TrainState, create_train_state

__all__ = [
    "clip_by_average_norm_", "make_lr_schedule", "make_optimizer",
    "TrainState", "create_train_state",
    "Trainer", "forward_backward", "make_train_step", "param_summary_scalars",
]
