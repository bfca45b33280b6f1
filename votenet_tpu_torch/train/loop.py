"""Training step and epoch loop (port of votenet_tpu/train/loop.py).

``make_train_step`` builds the step the JAX package jits: a train-mode
forward (batch statistics, running statistics updated in place), the loss,
the gradients, per-tensor average-norm clipping, then Adam at the scheduled
rate. ``Trainer.train_epoch`` runs it over an epoch's batches on one device
and fetches the metrics to the host every ``metrics_every`` steps, into the
JAX package's ``MetricLogger``. Checkpoints, resume, the eval callback and
multi-device training are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from votenet_tpu.config import Config
from votenet_tpu.utils.metrics import MetricLogger
from votenet_tpu_torch.models.convert import flax_param_path
from votenet_tpu_torch.models.losses import VoteNetLossOutput, votenet_loss
from votenet_tpu_torch.models.votenet import VoteNet
from votenet_tpu_torch.train.optimizer import clip_by_average_norm_
from votenet_tpu_torch.train.state import TrainState, full_f32_matmuls

GT_KEYS = (
    "bboxes_xyz", "bboxes_lwh", "bboxes_roty", "semantic_labels",
    "heading_labels", "heading_residuals", "size_labels", "size_residuals",
    "gt_count",
)
# metric name -> VoteNetLossOutput field, the JAX step's keys (loop.py:93-101)
METRICS = {
    "total_cost": "total", "vote_reg_loss": "vote_reg_loss",
    "obj_cls_loss": "obj_cls_loss", "box_loss": "box_loss",
    "sem_cls_loss": "sem_cls_loss", "obj_accuracy": "obj_accuracy",
    "sem_accuracy": "sem_accuracy",
}


def forward_backward(
    model: VoteNet, batch: Dict, config: Config, pad_semantics: str = "reference"
) -> VoteNetLossOutput:
    """Train-mode forward and loss, then the gradients into every
    parameter's ``.grad`` (zeros for a parameter the loss does not reach, as
    JAX differentiates every leaf). ``batch`` is a ``batch_scenes`` batch
    (numpy arrays or tensors). Returns the losses, detached."""
    device = next(model.parameters()).device
    b = {k: torch.as_tensor(batch[k]).to(device) for k in ("points",) + GT_KEYS}
    model.train()
    losses = votenet_loss(model(b["points"]), {k: b[k] for k in GT_KEYS}, config, pad_semantics)
    model.zero_grad(set_to_none=True)
    losses.total.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return VoteNetLossOutput(*(v.detach() for v in losses))


@torch.no_grad()
def param_summary_scalars(model: VoteNet) -> Dict[str, torch.Tensor]:
    """Per-leaf weight RMS (``w_rms/<flax path>``) and gradient L2 norm
    (``g_norm/<flax path>``, before clipping), plus ``g_norm/global``: the
    JAX step's summaries (loop.py:36-63), under its leaf names
    (``sa1/mlp/dense0/kernel``, ``voting/voting0_bn/scale``, ...)."""
    leaves = sorted((tuple(flax_param_path(n, model).split("/")), p) for n, p in model.named_parameters())
    out = {}
    sq_sum = None
    for path, p in leaves:
        name = "/".join(path)
        out[f"w_rms/{name}"] = torch.sqrt(torch.mean(p * p))
        leaf_sq = torch.sum(p.grad * p.grad)
        out[f"g_norm/{name}"] = torch.sqrt(leaf_sq)
        sq_sum = leaf_sq if sq_sum is None else sq_sum + leaf_sq
    out["g_norm/global"] = torch.sqrt(sq_sum)
    return out


def make_train_step(config: Config, pad_semantics: str = "reference", with_summaries: bool = False):
    """Build ``train_step(state, batch) -> metrics``.

    The step updates ``state`` in place (the model's parameters and
    batch-norm statistics, Adam's moments, ``state.step``) and returns the
    JAX step's metrics as 0-dim tensors on the model's device, without a
    host sync; ``with_summaries`` adds :func:`param_summary_scalars`. The
    rate of step t is ``state.schedule(t)``, optax's count before its
    increment. Matmuls run in full f32 (TF32 off, ``state.full_f32_matmuls``).
    """
    full_f32_matmuls()

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        losses = forward_backward(state.model, batch, config, pad_semantics)
        metrics = {k: getattr(losses, field) for k, field in METRICS.items()}
        if with_summaries:
            metrics.update(param_summary_scalars(state.model))
        clip_by_average_norm_(state.model.parameters(), config.grad_clip_avg_norm)
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step


class Trainer:
    """Epoch loop on one device (the JAX ``Trainer``'s single-device
    ``train_epoch``)."""

    def __init__(
        self,
        config: Config,
        state: TrainState,
        log_dir: Optional[str] = None,
        pad_semantics: str = "reference",
        with_summaries: bool = False,
    ):
        self.config = config
        self.state = state
        self.logger = MetricLogger(log_dir)
        self.epoch = 0
        self._train_step = make_train_step(config, pad_semantics, with_summaries)

    def train_epoch(self, batches: Iterable[Dict], metrics_every: int = 10) -> Dict[str, float]:
        """One epoch. Metrics reach the host (a device sync) only every
        ``metrics_every`` steps and after the last; the steps between are
        queued back to back. Returns the logger's moving averages."""
        step_in_epoch = 0
        metrics = None
        for batch in batches:
            metrics = self._train_step(self.state, batch)
            step_in_epoch += 1
            if step_in_epoch % metrics_every == 0:
                self.logger.log_step(self.state.step, {k: float(v) for k, v in metrics.items()})
        if metrics is not None and step_in_epoch % metrics_every != 0:
            self.logger.log_step(self.state.step, {k: float(v) for k, v in metrics.items()})
        self.epoch += 1
        return self.logger.moving.averages()
