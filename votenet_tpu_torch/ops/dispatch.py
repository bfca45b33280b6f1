"""Process-wide kernel options of the port (after
``votenet_tpu/ops/dispatch.py:123,142-151``).

Only the fused SA MLP + max-pool's matmul operand precision lives here: the
eval forward reads it at every call (``models/pointnet2.py``), as the JAX
package's does. No ``Config`` field sets it, in either package.
"""

from __future__ import annotations

_samlp_precision: str = "f32"  # matmul operand precision: "f32" | "bf16"


def set_samlp_precision(mode: str) -> None:
    """Matmul operand precision inside the fused SA-MLP kernel: "f32"
    (3xTF32 on the card) or "bf16" (bf16 operands, f32 accumulation)."""
    global _samlp_precision
    if mode not in ("f32", "bf16"):
        raise ValueError(f"samlp_precision must be 'f32' or 'bf16', got {mode!r}")
    _samlp_precision = mode


def samlp_precision() -> str:
    return _samlp_precision
