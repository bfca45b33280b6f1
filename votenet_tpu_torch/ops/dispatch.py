"""Process-wide kernel options of the port (after
``votenet_tpu/ops/dispatch.py:76-104,123,142-151``).

The fused SA MLP + max-pool's matmul operand precision: the eval forward
reads it at every call (``models/pointnet2.py``), as the JAX package's does.
No ``Config`` field sets it, in either package.

The ball query's distance mode: ``ops.query_ball_point`` and the
point-sharded ball query read it at every call where the caller names no
mode. ``Config.bq_precision`` sets it for a model: ``VoteNet`` hands the
Config's mode to each of its SA layers, as it does the scatter's.
"""

from __future__ import annotations

_samlp_precision: str = "f32"  # matmul operand precision: "f32" | "bf16"
_bq_precision: str = "exact"  # ball-query hit test: "exact" | "fast_bf16"


def set_samlp_precision(mode: str) -> None:
    """Matmul operand precision inside the fused SA-MLP kernel: "f32"
    (3xTF32 on the card) or "bf16" (bf16 operands, f32 accumulation)."""
    global _samlp_precision
    if mode not in ("f32", "bf16"):
        raise ValueError(f"samlp_precision must be 'f32' or 'bf16', got {mode!r}")
    _samlp_precision = mode


def samlp_precision() -> str:
    return _samlp_precision


def check_bq_mode(mode: str) -> None:
    """ValueError, with the JAX package's text, for a mode other than
    "exact" and "fast_bf16"."""
    if mode not in ("exact", "fast_bf16"):
        raise ValueError(f"bq_precision must be 'exact' or 'fast_bf16', got {mode!r}")


def set_bq_precision(mode: str) -> None:
    """The ball query's distance mode: "exact" (difference form, the
    reference's hits) or "fast_bf16" (``ops.common.pairwise_sqdist_fast_bf16``)."""
    global _bq_precision
    check_bq_mode(mode)
    _bq_precision = mode


def bq_precision() -> str:
    """The current ball-query distance mode (read at every call)."""
    return _bq_precision
