"""What every run shares: the cell's files found by name, the device check,
the spans, the per-layer readers, the import check and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. The configuration's file (``configs[].file``) holds the model's
sizes as run and each layer's dtype; the traffic's file
(``portbench/traffic/<traffic>.json``) names its driver
(``portbench/drivers/<entry>.py``) and that driver's parameters; the
limits of the comparison that decides ``correct`` are
``portbench/limits/<workload>.json``; a per-layer metric ``<base>.<kind>``
is read by ``portbench/metrics/<base>.<kind>.py``'s ``read(obs, kind)``, or
where that file is absent by ``portbench/metrics/<base>.py``'s, the kind
(``eval``, ``train``) naming the cells whose end-to-end metric it moves. A
later cell, mix, driver or metric is a new file and a new entry: nothing
here names one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "votenet_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    """One cell with its files read: the workload entry, the configuration's
    file (``model`` holds the model's sizes as run), the traffic mix, the
    limits, and the benchmark's metric entries."""

    workload: dict
    config: dict
    traffic: dict
    limits: dict
    bench: dict

    @property
    def model(self) -> dict:
        return self.config["config"]

    @property
    def layer_dtypes(self) -> Dict[str, str]:
        return self.config["layer_dtypes"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(wl)}")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(w, load_json(root / conf["file"]), load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                load_json(BENCH / "limits" / f"{name}.json"), bench)


def program_config(cell: Cell):
    """The program's ``Config`` holding every value of the configuration's
    file (lists as tuples); raises where the program would run another."""
    from votenet_tpu_torch.config import default_config

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    cfg = default_config(**{k: tup(v) for k, v in cell.model.items()})
    for k, v in cell.model.items():
        if getattr(cfg, k) != tup(v):
            raise ValueError(f"the program's Config.{k} is {getattr(cfg, k)!r}, the configuration states {v!r}")
    return cfg


def devices_or_exit(chips: int):
    """The card, or exit 3 with no result where CUDA is absent or has fewer
    devices than the cell asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        raise SystemExit(3)
    return torch.device("cuda", 0)


def sync(device) -> None:
    """Wait for the device's queue (nothing to wait for on the CPU, where the
    tests drive a run)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


class Spans:
    """The benchmark's own ``record_function`` spans around its calls into
    the program, entered only while a trace records (``active``)."""

    def __init__(self):
        self.active = False

    def __call__(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(f"portbench.{name}")


def traced(spans: Spans, run):
    """Run ``run()`` under the profiler inside the stretch's span; returns
    the reduced trace (``yardstick.trace.reduce_events``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.yardstick.trace import STRETCH, profiler_events, reduce_events

    torch.cuda.synchronize()
    spans.active = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(STRETCH):
                run()
                torch.cuda.synchronize()
    finally:
        spans.active = False
    return reduce_events(*profiler_events(prof))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``votenet_tpu_torch`` is not
    ``votenet_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _reader(name: str):
    """The metric's ``read`` and the kind it is called with."""
    base, _, kind = name.rpartition(".")
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and base:
        path = BENCH / "metrics" / f"{base}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read, kind or None


def _applies(entry: dict, cell: Cell) -> bool:
    return "workloads" not in entry or cell.workload["name"] in entry["workloads"]


def per_layer(cell: Cell, obs: dict) -> Dict[str, dict]:
    """Every per-layer metric this cell lists (or that names no cells and
    moves an end-to-end metric the cell reports), from its reader; a reader
    that finds nothing returns None and the metric is left out."""
    e2e = {m["name"] for m in cell.bench["end_to_end"] if _applies(m, cell)}
    out = {}
    for m in cell.bench["per_layer"]:
        if "workloads" in m and cell.workload["name"] not in m["workloads"]:
            continue
        if "workloads" not in m and m["moves"] not in e2e:
            continue
        read, kind = _reader(m["name"])
        v = read(obs, kind)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def end_to_end(cell: Cell, obs: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.bench["end_to_end"]:
        if _applies(m, cell):
            out[m["name"]] = {"value": obs["e2e"][m["name"]], "unit": m["unit"]}
    return out


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit, last on standard error; the
    result line (with ``checks`` as its last key) last on standard output."""
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(dict(result, checks=checks)), flush=True)


def import_driver(entry: str):
    return importlib.import_module(f"portbench.drivers.{entry}")

