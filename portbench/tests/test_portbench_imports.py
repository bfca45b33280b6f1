"""What the benchmark imports, checked in fresh interpreters, and that a
cell, configuration, traffic mix or metric added as files is found by name.

No module the harness or the reference loads may have the top-level name
``jax``, ``jaxlib``, ``flax`` or ``votenet_tpu`` (compared whole: the
port, ``votenet_tpu_torch``, is another name); the reference also loads
nothing of ``votenet_tpu_torch``.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "votenet_tpu"}

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for m in {mods!r}:
    __import__(m)
print(json.dumps(sorted({{k.split(".")[0] for k in sys.modules}})))
"""


def top_level_modules(*mods: str, root: Path = ROOT) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(root), mods=list(mods))],
                         capture_output=True, text=True, check=True, cwd=str(root))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


HARNESS = ["portbench.harness", "portbench.drivers.common", "portbench.drivers.eval", "portbench.drivers.train",
           "portbench.control", "portbench.yardstick.readers",
           "portbench.yardstick.trace", "portbench.yardstick.compare", "portbench.yardstick.bounds"]
REFERENCE = ["portbench.reference.votenet_ref", "portbench.reference.head_ref", "portbench.reference.weights",
             "portbench.reference.msgpack_reader"]


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    # the drivers load the port inside run(); load what they call too
    mods = top_level_modules(*HARNESS, "votenet_tpu_torch.eval.evaluator", "votenet_tpu_torch.train.loop",
                             "votenet_tpu_torch.train.state")
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert "votenet_tpu_torch" in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = top_level_modules(*REFERENCE)
    assert not mods & (FORBIDDEN | {"votenet_tpu_torch"}), mods & (FORBIDDEN | {"votenet_tpu_torch"})


def test_the_run_compares_whole_top_level_names():
    code = f"""
import sys, types, json
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
before = harness.forbidden_modules()
sys.modules["votenet_tpu_torch_x.ops"] = types.ModuleType("x")
sys.modules["jaxtyping"] = types.ModuleType("y")
middle = harness.forbidden_modules()
sys.modules["votenet_tpu.ops"] = types.ModuleType("z")
sys.modules["jax.numpy"] = types.ModuleType("w")
print(json.dumps([before, middle, harness.forbidden_modules()]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], [], ["jax", "votenet_tpu"]]


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark's files (BENCHMARK.json and portbench/) and the
    configuration files, in a temporary checkout."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_a_new_cell_is_found_by_name_without_editing_a_file(copy):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    conf = json.loads((copy / "portbench/configs/votenet_sunrgbd_f32.json").read_text())
    conf["name"] = "votenet_sunrgbd_f32_samlp"
    conf["config"]["samlp"] = "on"
    (copy / "portbench/configs/votenet_sunrgbd_f32_samlp.json").write_text(json.dumps(conf))
    (copy / "portbench/traffic/eval_b32_cache512.json").write_text(json.dumps(
        {"entry": "eval", "batch": 32, "scenes": 512, "pipeline_depth": 4, "weights": "seeded", "sample_batches": 1,
         "trace_passes": 1}))
    (copy / "portbench/limits/eval_f32_b32_samlp.json").write_text(json.dumps(
        {"tau": 1e-4, "checks": {"det_gap_p90": {"limit": 1e-3}}}))
    (copy / "portbench/metrics/samlp_roofline.py").write_text(
        "def read(obs, kind):\n    return 42.0 if kind == obs['kind'] == 'eval' else None\n")
    bench["configs"].append({"name": "votenet_sunrgbd_f32_samlp", "source": "x", "reduced": [], "why": "x",
                             "file": "portbench/configs/votenet_sunrgbd_f32_samlp.json"})
    bench["workloads"].append({"name": "eval_f32_b32_samlp", "config": "votenet_sunrgbd_f32_samlp",
                               "traffic": "eval_b32_cache512", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("eval_f32_b32_samlp")
    for m in bench["per_layer"]:
        if m["name"].endswith(".eval"):
            m["workloads"].append("eval_f32_b32_samlp")
    bench["per_layer"].append({"name": "samlp_roofline.eval", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "Kernels", "moves": "eval_scenes_per_s",
                               "workloads": ["eval_f32_b32_samlp"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys
sys.path.insert(0, {str(copy)!r})
from portbench import harness
cell = harness.load_cell("eval_f32_b32_samlp")
obs = {{"kind": "eval", "host_ms": [1.0, 3.0], "units": 2, "window_s": 1.0, "flops_per_unit": {{"float32": 1e9}},
       "peak_bytes": 2 ** 30, "e2e": {{"eval_scenes_per_s": 1.0, "setup_s": 2.0}}}}
print(json.dumps([cell.config["config"]["samlp"], cell.traffic["batch"], cell.limits["checks"],
                  harness.per_layer(cell, obs), harness.end_to_end(cell, obs),
                  harness.import_driver(cell.traffic["entry"]).__name__]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(copy))
    samlp, batch, checks, layer, e2e, driver = json.loads(out.stdout.strip().splitlines()[-1])
    assert (samlp, batch, driver) == ("on", 32, "portbench.drivers.eval")
    assert checks == {"det_gap_p90": {"limit": 1e-3}}
    assert layer["samlp_roofline.eval"]["value"] == 42.0
    assert layer["host_ms.eval"]["value"] == 2.0 and layer["peak_gib.eval"]["value"] == 1.0
    assert set(e2e) == {"eval_scenes_per_s", "setup_s"}
    for p, data in before.items():  # the benchmark's own files, as they were
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p


def test_a_checkout_of_the_benchmark_alone_exits_without_a_result(copy):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "eval_f32_b64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=str(copy))
    assert res.returncode != 0
    assert '"correct"' not in res.stdout
