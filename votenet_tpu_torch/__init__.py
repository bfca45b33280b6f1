"""votenet_tpu_torch: VoteNet's inference path in PyTorch, with CUDA kernels for Hopper.

A port of the JAX package :mod:`votenet_tpu`, which stays the reference the
port is tested against. The framework-free modules are reused by import, not
copied: :mod:`votenet_tpu.config` (``Config``, ``default_config``,
``tiny_config``), :mod:`votenet_tpu.data.geometry` and
:mod:`votenet_tpu.data.synthetic` import only numpy. This package imports
``torch`` and never ``jax``.

Layout (each module mirrors its JAX counterpart):

- ``ops``: pairwise distances, FPS, ball query, grouping, three_nn, IoU, NMS;
  ``ops/cuda`` builds and wraps the kernels in ``csrc/`` (FPS, ball query).
- ``models``: PointNet++ layers, VoteNet, decode, and the flax-checkpoint
  converter.
- ``predictor.VoteNetPredictor`` and ``entry.entry``: the serving entry points.
"""

from votenet_tpu.config import Config, default_config, tiny_config

__all__ = ["Config", "default_config", "tiny_config", "VoteNetPredictor"]


def __getattr__(name):
    # lazy, like votenet_tpu: `import votenet_tpu_torch` stays cheap
    if name == "VoteNetPredictor":
        from votenet_tpu_torch.predictor import VoteNetPredictor

        return VoteNetPredictor
    raise AttributeError(name)
