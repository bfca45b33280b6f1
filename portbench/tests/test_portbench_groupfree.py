"""The Group-Free 3D cell (``eval_gf3d_l6o256_b64``) on the CPU: its driver
at tiny widths (the port's plain kernels), its FLOPs and bounds at the
published widths, its three per-layer readers on synthetic traces, what its
reference loads, and that a copy of the benchmark finds it by name.

Run: ``python -m pytest portbench/tests -q``.
"""

import dataclasses
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.yardstick import bounds, gf_bounds, gf_flops, spans, trace  # noqa: E402
from portbench.yardstick.compare import judge  # noqa: E402

CELL = "eval_gf3d_l6o256_b64"
CPU = torch.device("cpu")
NEW = ("device_ms.decoder.eval", "span_ms.decoder.eval", "attention_roofline.eval")


def lst(v):
    return [lst(x) for x in v] if isinstance(v, tuple) else v


def tiny(**traffic):
    """The cell at ``tiny_groupfree_config()``'s widths."""
    from votenet_tpu_torch.models.groupfree import tiny_groupfree_config

    cell = harness.load_cell(CELL)
    g = tiny_groupfree_config()
    model = {k: lst(getattr(g.base, k) if k in g.base.__dataclass_fields__ else getattr(g, k)) for k in cell.model}
    return dataclasses.replace(cell, config=dict(cell.config, config=model), traffic=dict(cell.traffic, **traffic))


def drive(cell, trace_on=0, control=None, seed=2 ** 31 + 77):
    args = types.SimpleNamespace(seed=seed, seconds=0.01, trace=trace_on)
    return harness.import_driver(cell.traffic["entry"]).run(cell, args, 0.0, CPU, control=control)


def full():
    return harness.load_cell(CELL).model


# ---------------------------------------------------------------- the driver

def test_the_driver_runs_the_cell_at_tiny_widths_and_reads_its_metrics():
    cell = tiny(batch=4, scenes=8, trace_passes=1)
    obs = drive(cell, trace_on=1)
    ok, checks = judge(obs["numbers"], cell.limits)
    assert ok and obs["numbers"]["ref_kept"] > 0, obs["numbers"]
    assert obs["units"] >= 2 and obs["attempted"] == 8 * obs["units"] // 2
    got = harness.per_layer(cell, obs)
    assert {"host_ms.eval", "launches.eval", "mfu.eval", "idle_share.eval", "peak_gib.eval"} <= set(got)
    assert got["device_ms.decoder.eval"]["value"] == 0.0  # the CPU launches nothing on a device
    assert got["span_ms.decoder.eval"]["value"] > 0
    assert "attention_roofline.eval" not in got  # no attention kernel ran
    counts = {k: v["count"] for k, v in obs["trace"]["program_spans"].items()}
    assert counts["votenet.gf.decoder"] == 2 and counts["votenet.gf.layer"] == 2 * 2
    assert set(harness.end_to_end(cell, obs)) == {"eval_scenes_per_s", "setup_s"}


def test_an_altered_answer_is_not_correct():
    def moved(predict):
        def run(pts):
            out = dict(predict(pts))
            out["packed"] = out["packed"].clone()
            out["packed"][:, :, :24] += 0.05  # every scene's boxes moved by 5 cm
            return out
        return run

    obs = drive(tiny(batch=4, scenes=8), control=moved)
    assert obs["numbers"]["ref_kept"] > 0 and not judge(obs["numbers"], tiny().limits)[0], obs["numbers"]


def test_every_box_moved_a_few_millimetres_is_not_correct():
    """A fault under tau = 1 cm and the p90 limit: every scene's boxes moved
    by 5 mm; ``det_gap_p50`` (1 mm) alone refuses it."""
    def moved(predict):
        def run(pts):
            out = dict(predict(pts))
            out["packed"] = out["packed"].clone()
            out["packed"][:, :, :24] += 0.005
            return out
        return run

    cell = tiny(batch=4, scenes=8)
    obs = drive(cell, control=moved)
    ok, checks = judge(obs["numbers"], cell.limits)
    assert obs["numbers"]["ref_kept"] > 0 and not ok, checks
    assert [k for k, c in checks.items() if c["value"] > c["limit"]] == ["det_gap_p50"], checks


def test_the_comparison_adds_the_median_gap():
    """``det_gap_p50`` is the median of the gaps ``det_gap_p90`` is the 90th
    percentile of: a detection's largest corner or score difference to the
    nearest reference proposal of its class."""
    from portbench.drivers.eval_groupfree import comparison
    from portbench.yardstick.compare import CLASSES

    corners = np.zeros((1, 3, 8, 3))
    corners[0, 1] += 1.0
    corners[0, 2] += 5.0
    ref = {"bboxes": corners, "class": np.array([[0, 0, 1]]), "score": np.array([[0.9, 0.8, 0.7]]),
           "keep": np.array([[True, True, True]])}
    dets = [[(CLASSES[0], corners[0, 0] + 0.002, 0.9), (CLASSES[0], corners[0, 1] + 0.004, 0.8),
             (CLASSES[1], corners[0, 2] + 0.03, 0.7)]]
    got = comparison(dets, ref, 1e-2)
    assert got["det_gap_p50"] == pytest.approx(0.004) and got["det_off_share"] == pytest.approx(2 / 3)
    assert got["det_gap_p90"] == pytest.approx(np.percentile([0.002, 0.004, 0.03], 90))
    assert comparison([[]], ref, 1e-2)["det_gap_p50"] == 0.0


def test_the_witness_runs_at_tiny_widths():
    """``witness_detections``: the reference against itself in float64 and
    the one-scene fault, each scene in turn."""
    from portbench.drivers.eval_groupfree import witness_detections

    cell = tiny(batch=4, scenes=8)
    got = witness_detections(cell, 2 ** 31 + 77, CPU)
    assert got["fault_scenes"] == 4 and 0 <= got["fault_scenes_passed"] <= 4
    assert got["det_gap_p90"] < 1e-4 and got["det_off_share"] == 0.0, got


def test_the_configuration_file_is_what_the_program_runs():
    from portbench.drivers.eval_groupfree import program_config
    from votenet_tpu_torch.models.groupfree import groupfree_config

    cell = harness.load_cell(CELL)
    assert program_config(cell) == groupfree_config()
    bad = dataclasses.replace(cell, config=dict(cell.config, config=dict(cell.model, nhead=4)))
    assert program_config(bad).nhead == 4
    with pytest.raises(ValueError, match="no setting"):
        program_config(dataclasses.replace(cell, config=dict(cell.config, config=dict(cell.model, heads=8))))


def test_the_height_channel_is_above_the_scenes_floor():
    from portbench.drivers.eval_groupfree import FLOOR_PERCENTILE, scenes

    pts = scenes(2 ** 31 + 3, 3, dict(full(), point_num=4000), CPU)
    assert pts.shape == (3, 4000, 4)
    import numpy as np

    for s in range(3):
        y = pts[s, :, 1].double().numpy()
        np.testing.assert_allclose(pts[s, :, 3].numpy(), y - np.percentile(y, FLOOR_PERCENTILE), atol=1e-5)
        assert 0.005 < float((pts[s, :, 3] < 0).float().mean()) < 0.015


# ---------------------------------------------------------------- counts

def test_flops_at_the_published_widths():
    f = gf_flops.forward_flops(full())
    assert f["sa1"] == 2048 * 64 * 2 * (4 * 64 + 64 * 64 + 64 * 128)
    assert f["sa2"] == 1024 * 32 * 2 * (131 * 128 + 128 * 128 + 128 * 256)
    assert f["sa3"] == 512 * 16 * 2 * (259 * 128 + 128 * 128 + 128 * 256)
    assert f["fp2"] == 1024 * 2 * (512 * 256 + 256 * 288)
    backbone = sum(f[k] for k in ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2"))
    assert backbone / 1e9 == pytest.approx(10.3, abs=0.05)
    per_layer = f["decoder"] / 6
    assert per_layer / 1e9 == pytest.approx(1.887, abs=0.001)
    # the two products of the attentions: 4 Lq Lk D a head, over 8 heads of 36
    assert gf_flops.attention_flops(full(), 256, 1024) == 4 * 256 * 1024 * 36 * 8
    assert f["sampling"] / 1e9 == pytest.approx(0.65, abs=0.01)
    assert f["decoder"] / sum(f.values()) == pytest.approx(0.51, abs=0.005)


def test_bounds_at_the_published_widths():
    cfg = full()
    got = gf_bounds.unit_bounds(cfg, 64)
    assert set(got) == {"fps", "ballquery", "batchnorm", "head"}
    assert got["fps"] == pytest.approx(sum(max(bounds.fps_bound(64, n, m)) for n, m in
                                           [(20000, 2048), (2048, 1024), (1024, 512), (512, 256)]))
    sites = gf_bounds.bn_sites(cfg)
    assert len(sites) == 12 + 4 + 4 + 4 * 6
    assert sum(1 for s in sites if s[5]) == 4 and sum(1 for s in sites if s[3] == "centre") == 4
    # cross-attention at B=64: 19.3 GFLOP at 67 TFLOP/s, above its 189 MB at 3.35 TB/s
    cross = 64 * 4 * 256 * 1024 * 288 / bounds.PEAK_F32_FLOPS * 1e3
    self_ = 64 * 4 * 256 * 256 * 288 / bounds.PEAK_F32_FLOPS * 1e3
    assert gf_bounds.attention_bound_ms(cfg, 64) == pytest.approx(6 * (cross + self_))


# ---------------------------------------------------------------- the readers

def synthetic(kind=CELL):
    """A reduced trace with the decoder's spans and the attention kernel."""
    return {"kind": "eval", "attention_bound_ms": 2.0,
            "trace": {"units": 4, "kernel_s": {"attention": 0.016},
                      "program_spans": {"votenet.gf.decoder": {"count": 4, "device_ms": 80.0}}},
            "recorded_spans": [("votenet.gf.decoder", -1, u, 0, ms * 1_000_000) for u, ms in enumerate((3, 5, 9))]}


def reader(name):
    return harness._reader(name)[0]


def test_the_new_readers_read_a_synthetic_trace():
    obs = synthetic()
    assert reader("device_ms.decoder.eval")(obs, "eval") == pytest.approx(20.0)
    assert reader("span_ms.decoder.eval")(obs, "eval") == pytest.approx(5.0)
    assert reader("attention_roofline.eval")(obs, "eval") == pytest.approx(100.0 * 2.0 * 4 / 16.0)


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_find_nothing_in_other_cells(name):
    read = reader(name)
    other = {"kind": "eval", "trace": {"units": 16, "launches": 100, "family_s": {"fps": 0.1},
                                       "program_spans": {"votenet.eval.predict": {"count": 16, "device_ms": 9.0}}},
             "recorded_spans": [("votenet.eval.predict", -1, 0, 0, 10)], "bounds_per_unit": {"fps": 1.0}}
    assert read(other, "eval") is None  # VoteNet's eval cell: no decoder span, no attention kernel
    assert read(dict(synthetic(), kind="train"), "eval") is None and read(synthetic(), "train") is None
    assert read({"kind": "eval"}, "eval") is None


def test_the_attention_kernel_is_found_by_its_own_name():
    """``traced``'s sum over the kernel's device events, without
    ``kernel_families.json``: the kernel is in no family there."""
    from portbench.drivers.eval_groupfree import ATTENTION_KERNEL

    assert trace.family_of(f"void (anonymous namespace)::{ATTENTION_KERNEL}<36>(...)") is None
    assert trace.short_name(f"void (anonymous namespace)::{ATTENTION_KERNEL}<36>(float const*)") == ATTENTION_KERNEL
    assert ATTENTION_KERNEL in (ROOT / "votenet_tpu_torch/csrc/attention.cu").read_text()
    assert spans.PREFIX + "gf.decoder" == "votenet.gf.decoder"


# ---------------------------------------------------------------- imports and the harness

def test_the_reference_and_the_driver_load_neither_jax_nor_the_program_where_they_must_not():
    from test_portbench_imports import FORBIDDEN, top_level_modules

    ref = top_level_modules("portbench.reference.groupfree_ref", "portbench.reference.groupfree_weights")
    assert not ref & (FORBIDDEN | {"votenet_tpu_torch"}), ref & (FORBIDDEN | {"votenet_tpu_torch"})
    drv = top_level_modules("portbench.drivers.eval_groupfree", "portbench.control_groupfree",
                            "votenet_tpu_torch.models.groupfree", "votenet_tpu_torch.eval.evaluator")
    assert not drv & FORBIDDEN, drv & FORBIDDEN


def test_a_copy_of_the_benchmark_finds_the_cell_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    code = f"""
import json, sys
sys.path.insert(0, {str(tmp_path)!r})
from portbench import harness
cell = harness.load_cell({CELL!r})
obs = {{"kind": "eval", "host_ms": [1.0, 3.0], "units": 2, "window_s": 1.0, "flops_per_unit": {{"float32": 1e9}},
       "peak_bytes": 2 ** 30, "e2e": {{"eval_scenes_per_s": 1.0, "setup_s": 2.0}}, "attention_bound_ms": 1.0,
       "trace": {{"units": 2, "launches": 10, "busy_s": 0.5, "window_s": 1.0, "family_s": {{}},
                 "kernel_s": {{"attention": 0.004}},
                 "program_spans": {{"votenet.gf.decoder": {{"count": 2, "device_ms": 6.0}}}}}},
       "recorded_spans": [["votenet.gf.decoder", -1, 0, 0, 2000000]]}}
print(json.dumps([cell.config["name"], cell.traffic["entry"], sorted(cell.limits["checks"]),
                  harness.per_layer(cell, obs), harness.end_to_end(cell, obs),
                  harness.import_driver(cell.traffic["entry"]).__name__]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=str(tmp_path))
    name, entry, checks, layer, e2e, driver = json.loads(out.stdout.strip().splitlines()[-1])
    assert (name, entry, driver) == ("groupfree3d_sunrgbd_l6o256", "eval_groupfree", "portbench.drivers.eval_groupfree")
    assert checks == ["det_gap_p50", "det_gap_p90", "det_off_share"]
    assert layer["device_ms.decoder.eval"]["value"] == 3.0 and layer["span_ms.decoder.eval"]["value"] == 2.0
    assert layer["attention_roofline.eval"]["value"] == pytest.approx(50.0)
    assert layer["launches.eval"]["value"] == 5.0 and layer["idle_share.eval"]["value"] == 50.0
    assert set(e2e) == {"eval_scenes_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_the_benchmark_adds_only_to_what_it_had():
    """The cell, its configuration and its three metrics are new entries at
    the ends of their lists; the accepted entries changed only by the cell's
    name appended to their ``workloads``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert bench["workloads"][-1]["name"] == CELL and bench["workloads"][-1]["chips"] == 1
    assert bench["configs"][-1]["name"] == "groupfree3d_sunrgbd_l6o256" and bench["configs"][-1]["reduced"] == []
    assert [m["name"] for m in bench["per_layer"][-3:]] == list(NEW)
    for m in bench["per_layer"][:-3] + bench["end_to_end"]:
        if CELL in m.get("workloads", []):
            assert m["workloads"][-1] == CELL and m["name"].endswith(".eval") or m["name"] == "eval_scenes_per_s"
