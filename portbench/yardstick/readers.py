"""The per-layer metrics, read from a run's observations.

``obs`` (built by a driver) holds the unit of work (``kind``: eval or
train; ``unit_scenes``), the plain stretch's ``host_ms`` (one reading a
unit), ``units`` and ``window_s``, ``peak_bytes``, the FLOPs and the kernel
families' least ms a unit, and ``trace`` (``yardstick.trace``'s reduction of
the traced stretch, with the ``units`` it ran). Each reader returns None
where its cell is of another kind or the trace holds nothing for it.
"""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.yardstick.bounds import PEAK_FLOPS


def _mine(obs: dict, kind: str) -> bool:
    return obs.get("kind") == kind


def host_ms(obs: dict, kind: str) -> Optional[float]:
    """The median host ms a unit: from the call into the entry until it
    returns (eval), or between the loop's requests for consecutive
    batches at steps that fetch no metrics (train)."""
    if not _mine(obs, kind) or not obs.get("host_ms"):
        return None
    return statistics.median(obs["host_ms"])


def launches(obs: dict, kind: str) -> Optional[float]:
    """Device launches (kernels, copies, fills) a unit in the traced
    stretch."""
    tr = obs.get("trace")
    if not _mine(obs, kind) or not tr or not tr.get("units"):
        return None
    return tr["launches"] / tr["units"]


def kernel_roofline(obs: dict, kind: str) -> Optional[float]:
    """% : the least ms of the port's own kernel families found in the trace
    (their bounds a unit times the units traced) over those kernels' device
    ms."""
    tr = obs.get("trace")
    if not _mine(obs, kind) or not tr:
        return None
    fams = [f for f, s in tr.get("family_s", {}).items() if s > 0 and f in obs["bounds_per_unit"]]
    spent = sum(tr["family_s"][f] for f in fams)
    if not fams or spent <= 0:
        return None
    least = sum(obs["bounds_per_unit"][f] for f in fams) * 1e-3 * tr["units"]
    return 100.0 * least / spent


def mfu(obs: dict, kind: str) -> Optional[float]:
    """% : the model's matmul FLOPs of the window's units, as the least
    seconds at each dtype's peak, over the window's seconds."""
    if not _mine(obs, kind) or not obs.get("units") or not obs.get("window_s"):
        return None
    least = sum(f / PEAK_FLOPS[dt] for dt, f in obs["flops_per_unit"].items()) * obs["units"]
    return 100.0 * least / obs["window_s"]


def idle_share(obs: dict, kind: str) -> Optional[float]:
    """% of the traced stretch with no device event running."""
    tr = obs.get("trace")
    if not _mine(obs, kind) or not tr or tr.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def peak_gib(obs: dict, kind: str) -> Optional[float]:
    """``torch.cuda.max_memory_allocated()`` up to the window's close, GiB."""
    if not _mine(obs, kind) or "peak_bytes" not in obs:
        return None
    return obs["peak_bytes"] / 2 ** 30
