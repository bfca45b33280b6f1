"""The benchmark's arithmetic on the CPU: the FLOP count, the trace's busy
and idle time, the rates, and each copied bound against
``chip_smoke.py``'s on the same inputs.

Run: ``python -m pytest portbench/tests -q``.
"""

import importlib.util
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.yardstick import bounds, flops, readers, stats, trace  # noqa: E402


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_counts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_forward_flops_at_the_published_widths():
    f = flops.forward_flops(config("votenet_sunrgbd_f32")["config"])
    # 2 * in * out a row: sa1 over 2048 x 64 rows from 6 inputs (centred xyz and xyz as features)
    assert f["sa1"] == 2048 * 64 * 2 * (6 * 64 + 64 * 64 + 64 * 128)
    assert f["sa2"] == 1024 * 64 * 2 * (131 * 128 + 128 * 128 + 128 * 256)
    assert f["sa3"] == 512 * 64 * 2 * (259 * 128 + 128 * 128 + 128 * 256)
    assert f["sa4"] == 256 * 64 * 2 * (259 * 128 + 128 * 128 + 128 * 256)
    assert f["fp1"] == 512 * 2 * (512 * 256 + 256 * 256)
    assert f["fp2"] == 1024 * 2 * (512 * 256 + 256 * 256)
    assert f["voting"] == 1024 * 2 * (259 * 256 + 256 * 256 + 256 * 259)
    assert f["proposal"] == 256 * 64 * 2 * (259 * 128 + 128 * 128 + 128 * 128)
    assert f["head"] == 256 * 2 * (128 * 128 + 128 * 128 + 128 * 79)
    assert sum(f.values()) / 1e9 == pytest.approx(23.24, abs=0.005)
    # with sa1 on 3 inputs the sum is 23.19 GFLOP
    assert (sum(f.values()) - 2048 * 64 * 2 * 3 * 64) / 1e9 == pytest.approx(23.19, abs=0.005)


def test_mixed_precision_splits_the_count_by_layer_dtype():
    f32 = config("votenet_sunrgbd_f32")
    mixed = config("votenet_sunrgbd_mixed")
    per = flops.forward_flops(mixed["config"])
    split = flops.flops_by_dtype(mixed["config"], mixed["layer_dtypes"], train=False)
    assert split["bfloat16"] == per["sa2"] + per["sa3"] + per["sa4"]
    assert split["float32"] == sum(per.values()) - split["bfloat16"]
    assert split["bfloat16"] / 1e9 == pytest.approx(16.73, abs=0.01)
    train = flops.flops_by_dtype(mixed["config"], mixed["layer_dtypes"], train=True)
    assert train == {k: 3 * v for k, v in split.items()}
    assert flops.flops_by_dtype(f32["config"], f32["layer_dtypes"], train=False) == {"float32": sum(per.values())}


def test_busy_time_is_the_union_of_device_intervals():
    host = [(trace.STRETCH, 0.0, 100.0), ("portbench.entry_call", 0.0, 30.0), ("aten::mm", 5.0, 9.0),
            ("aten::item", 60.0, 95.0)]
    # two overlapping kernels on two streams count once; a copy; one kernel past the stretch's end
    device = [("void fps_cluster_kernel<4>(float)", 10.0, 40.0), ("sm90_xmma_gemm_f32", 20.0, 50.0),
              ("Memcpy DtoH (Device -> Pageable)", 70.0, 80.0), ("void bn_apply_kernel<float>", 90.0, 130.0)]
    r = trace.reduce_events(device, host)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx((40 + 10 + 10) * 1e-6)  # [10, 50], [70, 80], [90, 100]
    assert r["launches"] == 4
    assert r["family_s"] == pytest.approx({"fps": 30e-6, "batchnorm": 10e-6})
    gaps = dict(r["idle_gaps"])
    assert gaps["portbench.entry_call/aten::mm"] == pytest.approx(10e-6)  # [0, 10] while the host ran mm
    assert gaps["aten::item"] == pytest.approx(30e-6)  # [50, 70] and [80, 90]
    share = readers.idle_share({"kind": "eval", "trace": r}, "eval")
    assert share == pytest.approx(40.0)
    assert readers.idle_share({"kind": "eval", "trace": r}, "train") is None
    # a naive sum of kernel times over the wall counts the overlap twice
    assert sum(b - a for _, a, b in device[:3]) > 50
    assert dict(r["device_ops"]) == pytest.approx({"fps_cluster_kernel": 30e-6, "sm90_xmma_gemm_f32": 30e-6,
                                                   "Memcpy DtoH": 10e-6, "bn_apply_kernel": 10e-6})
    assert trace.short_name("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int, 4>(int*)") == \
        "DeviceRadixSortOnesweepKernel"
    assert trace.short_name("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_nn_align8>"
                            "(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_nn_align8::Params)") == \
        "cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_nn_align8"


def test_rates_and_mfu_are_over_the_whole_window():
    assert stats.rate(16 * 1024, 20.5) == 16 * 1024 / 20.5
    cfg = config("votenet_sunrgbd_f32")
    f = flops.flops_by_dtype(cfg["config"], cfg["layer_dtypes"], train=True)
    obs = {"kind": "train", "units": 200, "window_s": 20.0, "flops_per_unit": {k: v * 8 for k, v in f.items()},
           "host_ms": [50.0, 60.0, 70.0]}
    least = 200 * 8 * 3 * 23.24e9 / 67e12
    assert readers.mfu(obs, "train") == pytest.approx(100 * least / 20.0, rel=1e-3)
    assert readers.host_ms(obs, "train") == 60.0
    assert readers.mfu(obs, "eval") is None


def test_kernel_roofline_counts_only_families_found():
    obs = {"kind": "eval", "bounds_per_unit": {"fps": 0.2, "batchnorm": 1.0, "head": 0.01},
           "trace": {"units": 4, "family_s": {"fps": 0.008, "batchnorm": 0.004}}}
    assert readers.kernel_roofline(obs, "eval") == pytest.approx(100 * (1.2 * 4e-3) / 0.012)
    assert readers.kernel_roofline(dict(obs, trace={"units": 4, "family_s": {}}), "eval") is None


def test_bound_copies_equal_chip_smoke(smoke):
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, 300, 3), generator=g)
    q = xyz[:, :40]
    idx = torch.randint(0, 300, (2, 40, 16), generator=g, dtype=torch.int32)
    cnt = torch.randint(0, 20, (2, 40), generator=g, dtype=torch.int32)
    assert bounds.ballquery_bound(xyz, q, 16, idx, cnt) == smoke.ballquery_bound(xyz, q, 16, idx, cnt)
    gg = torch.rand((2, 640, 24), generator=g)
    sidx = torch.randint(-1, 301, (2, 640), generator=g)
    assert bounds.scatter_bound(gg, sidx, 300) == smoke.scatter_bound(gg, sidx, 300)
    full = torch.randint(0, 300, (2, 640), generator=g)
    assert bounds.scatter_shape_bound(2, 640, 24, 300) == smoke.scatter_bound(gg, full, 300)
    for args in ((8, 20480, 2048), (64, 2048, 1024), (1, 512, 256)):
        assert bounds.fps_bound(*args) == smoke.fps_bound(*args)
    assert bounds.nms_bound(8, 256, 12345) == smoke.nms_bound(8, 256, 12345)
    h_all = torch.rand((2, 300, 64), generator=g)
    layers = [(torch.rand((64, 64), generator=g), torch.rand(64, generator=g), torch.rand(64, generator=g)),
              (torch.rand((64, 128), generator=g), torch.rand(128, generator=g), torch.rand(128, generator=g))]
    s0, sh0 = torch.rand(64, generator=g), torch.rand((2, 40, 64), generator=g)
    for prec in ("f32", "bf16"):
        assert bounds.samlp_bound(h_all, idx, sh0, s0, layers, prec) == smoke.samlp_bound(h_all, idx, sh0, s0,
                                                                                          layers, prec)
    assert bounds.decode_bound(8, 256, 79, 12, 10, 10) == smoke.decode_bound(8, 256, 79, 12, 10, 10)
    assert bounds.decode_iou_bound(64, 256, 79, 12, 10, 10) == smoke.decode_iou_bound(64, 256, 79, 12, 10, 10)
    for sm in (False, True):
        assert bounds.iou_bound(8, 256, 256, sm) == smoke.iou_bound(8, 256, 256, sm)
    for args in ((65536, 128, 4, 4, 64, "centre", True), (8192, 256, 2, 2, 1, "bias", False),
                 (1000, 64, 4, 2, 1, None, False)):
        assert bounds.bn_bounds(*args) == smoke.bn_bounds(*args)
    assert bounds.split_bounds(65536, 64, 128, 2) == smoke.split_bounds(65536, 64, 128, 2)
    from votenet_tpu_torch.config import default_config

    cfg = config("votenet_sunrgbd_f32")["config"]
    assert bounds.bn_sites(cfg) == smoke.bn_sites(default_config())
    for layer in ("sa1", "sa4", "proposal"):
        assert bounds.bn_slots(cfg, layer) == smoke.bn_slots(default_config(), layer)


def test_unit_bounds_cover_each_path():
    f32, mixed = config("votenet_sunrgbd_f32"), config("votenet_sunrgbd_mixed")
    ev = bounds.unit_bounds(f32["config"], f32["layer_dtypes"], 64, train=False)
    assert set(ev) == {"fps", "ballquery", "batchnorm", "head"}
    tr = bounds.unit_bounds(mixed["config"], mixed["layer_dtypes"], 32, train=True)
    assert set(tr) == {"fps", "ballquery", "batchnorm", "scatter", "cast"}
    # FPS at B=8: sa1's bound (20480 points, 2048 centres) is the operations'
    assert bounds.unit_bounds(f32["config"], f32["layer_dtypes"], 8, train=False)["fps"] == pytest.approx(
        sum(max(bounds.fps_bound(8, n, m)) for n, m in ((20480, 2048), (2048, 1024), (1024, 512), (512, 256),
                                                         (1024, 256))))
