"""Reduction of a ``torch.profiler`` trace to the per-layer numbers.

The traced stretch is the benchmark's own span ``portbench.traced_stretch``
(host clock, the profiler's time base). Device events are the kernels,
copies and fills the trace records on the card; user annotations (the
device-side shadows of the host spans) are not device work. Busy time is
the union of the device events' intervals within the stretch, so work on
two streams at once counts once; the idle gaps are the rest of the stretch,
each named by what the host was doing at its middle: the innermost
benchmark span (``portbench.*``) and the innermost host event inside it.
"""

from __future__ import annotations

import collections
import functools
import json
import re
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

STRETCH = "portbench.traced_stretch"


@functools.lru_cache(maxsize=None)
def families() -> Dict[str, List[str]]:
    """{family: name substrings} of ``kernel_families.json``."""
    table = json.loads((Path(__file__).parent / "kernel_families.json").read_text())
    return {k: v for k, v in table.items() if not k.startswith("_")}


def short_name(name: str) -> str:
    """A kernel's function name without its namespaces and arguments
    (``bn_apply_kernel``, ``sm80_xmma_gemm_...``, ``DeviceRadixSortOnesweepKernel``),
    or a copy's or fill's words before its parenthesis (``Memcpy DtoH``)."""
    m = re.search(r"(\w+_kernel)\b", name)
    if m:
        return m.group(1)
    full = name[5:] if name.startswith("void ") else name
    bare = re.split(r"[<(]", full, maxsplit=1)[0].split("::")[-1].strip()
    arg = re.match(r"[^<(]*<\s*([\w:]+)", full)
    if re.fullmatch(r"Kernel\d*", bare) and arg:  # a template that cuBLAS instantiates: name it by its argument
        return arg.group(1).split("::")[-1]
    return bare or name


def family_of(name: str):
    for fam, pats in families().items():
        if any(p in name for p in pats):
            return fam
    return None


def union_length(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(length of the union, the union's disjoint intervals in order)."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def gaps_within(merged: List[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The parts of [t0, t1] that no interval of ``merged`` covers."""
    out, at = [], t0
    for a, b in merged:
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(a, b) for a, b in out if b > a]


def reduce_events(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]]) -> Dict:
    """From device events (name, start us, end us) and host events (name,
    start us, end us), the stretch's numbers: ``window_s``, ``busy_s``,
    ``launches``, ``family_s`` ({family: device seconds}), ``device_ops``
    and ``idle_gaps`` (at most 10 [name, seconds] each, largest first)."""
    stretch = [(a, b) for n, a, b in host if n == STRETCH]
    if not stretch:
        return {}
    t0, t1 = stretch[0]
    inside = [(n, max(a, t0), min(b, t1)) for n, a, b in device if b > t0 and a < t1]
    busy, merged = union_length([(a, b) for _, a, b in inside])
    by_op: Dict[str, float] = collections.defaultdict(float)
    by_family: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in inside:
        by_op[short_name(n)] += (b - a) * 1e-6
        fam = family_of(n)
        if fam:
            by_family[fam] += (b - a) * 1e-6
    gaps = sorted(gaps_within(merged, t0, t1), key=lambda g: g[0] - g[1])[:500]
    names = _host_at([0.5 * (a + b) for a, b in gaps], host)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (a, b), n in zip(gaps, names):
        idle[n] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6, "launches": len(inside),
            "family_s": dict(by_family), "device_ops": top(by_op), "idle_gaps": top(idle)}


def _host_at(times: List[float], host: List[Tuple[str, float, float]]) -> List[str]:
    """For each time, "<innermost benchmark span>/<innermost host event>"."""
    if not times:
        return []
    ev = [(n, a, b) for n, a, b in host if n != STRETCH]
    names = np.array([n for n, _, _ in ev] or [""], dtype=object)
    start = np.array([a for _, a, _ in ev] or [0.0])
    end = np.array([b for _, _, b in ev] or [0.0])
    dur = end - start
    ours = np.array([n.startswith("portbench.") for n in names])
    out = []
    for t in times:
        cover = (start <= t) & (end >= t)
        parts = []
        for sel in (cover & ours, cover & ~ours):
            if sel.any():
                i = np.flatnonzero(sel)[np.argmin(dur[sel])]
                parts.append(str(names[i]))
        out.append("/".join(parts) if parts else "host: no event")
    return out


def profiler_events(prof):
    """(device events, host events) of a finished ``torch.profiler.profile``
    as (name, start us, end us) triples."""
    from torch.autograd import DeviceType

    host_names = set()
    host, device = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            host.append((e.name, e.time_range.start, e.time_range.end))
            host_names.add(e.name)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
                and e.name not in host_names:
            device.append((e.name, e.time_range.start, e.time_range.end))
    return device, host
