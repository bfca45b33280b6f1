"""The port's copies of the JAX package's framework-free modules equal their
originals: config, data (geometry, synthetic scenes, SUN RGB-D reading,
batching), the AP math, gt_dict_from_labels, MetricLogger and the native
host library. Each pair gets the same inputs and must give the same output,
bit for bit."""

import ctypes
import dataclasses
import fcntl
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

import votenet_tpu.config as jax_config
import votenet_tpu.data.dataflow as jax_dataflow
import votenet_tpu.data.geometry as jax_geometry
import votenet_tpu.data.sunrgbd as jax_sunrgbd
import votenet_tpu.data.synthetic as jax_synthetic
import votenet_tpu.eval.ap as jax_ap
import votenet_tpu.native as jax_native
import votenet_tpu.utils.metrics as jax_metrics
import votenet_tpu_torch.config as port_config
import votenet_tpu_torch.data.dataflow as port_dataflow
import votenet_tpu_torch.data.geometry as port_geometry
import votenet_tpu_torch.data.sunrgbd as port_sunrgbd
import votenet_tpu_torch.data.synthetic as port_synthetic
import votenet_tpu_torch.eval.ap as port_ap
import votenet_tpu_torch.native as port_native
import votenet_tpu_torch.utils.metrics as port_metrics
from votenet_tpu.data.mini_fixture import make_fake_sunrgbd
from votenet_tpu.eval.evaluator import gt_dict_from_labels as jax_gt_dict
from votenet_tpu_torch.eval import gt_dict_from_labels as port_gt_dict


def assert_same(a, b, path="root"):
    """Deep equality: same types of containers, arrays equal in dtype, shape
    and bytes, floats and other leaves equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), f"{path}: {a!r} != {b!r}"


# --- config ---

@pytest.mark.parametrize("preset", ["default_config", "tiny_config", "throughput_config"])
def test_config_presets_equal(preset):
    assert dataclasses.asdict(getattr(port_config, preset)()) == dataclasses.asdict(getattr(jax_config, preset)())
    over = {"samlp": "on", "max_gt_boxes": 16}
    assert dataclasses.asdict(getattr(port_config, preset)(**over)) == dataclasses.asdict(
        getattr(jax_config, preset)(**over))


def test_config_fields_and_channels_equal():
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(port_config.Config)] == [
        (f.name, f.type, f.default) for f in dataclasses.fields(jax_config.Config)]
    assert port_config.Config().num_proposal_channels == jax_config.Config().num_proposal_channels


@pytest.mark.parametrize("argv", [
    [],
    ["--samlp=on", "--batch_size=8"],
    ["--sa_radii=0.1,0.2,0.3,0.4", "--mixed_precision=true", "--nms_iou=0.3"],
    ["--train_idx_range=5051,5101", "--mesh_shape=2,4", "--reject_mode=in_box"],
])
@pytest.mark.parametrize("base", [None, "tiny_config"])
def test_config_from_args_equal(argv, base):
    pb = getattr(port_config, base)() if base else None
    jb = getattr(jax_config, base)() if base else None
    assert dataclasses.asdict(port_config.config_from_args(argv, pb)) == dataclasses.asdict(
        jax_config.config_from_args(argv, jb))


def test_config_from_args_rejects_the_same_typo():
    for mod in (port_config, jax_config):
        with pytest.raises(SystemExit):
            mod.config_from_args(["--use_palas=false"])


# --- geometry ---

def test_geometry_constants_equal():
    for name in ("TYPE2CLASS", "CLASS2TYPE", "TYPE_WHITELIST", "TYPE_MEAN_SIZE", "CLASS_MEAN_SIZE"):
        assert_same(getattr(port_geometry, name), getattr(jax_geometry, name), name)


def test_geometry_helpers_equal():
    rng = np.random.RandomState(0)
    for t in rng.uniform(-7, 7, 5):
        for fn in ("rotx", "roty", "rotz"):
            assert_same(getattr(port_geometry, fn)(t), getattr(jax_geometry, fn)(t))
        assert port_geometry.angle2class(t, 12) == jax_geometry.angle2class(t, 12)
        assert port_geometry.class2angle(3, t / 10, 12) == jax_geometry.class2angle(3, t / 10, 12)
    size, heading, center = rng.uniform(0.2, 2, (4, 3)), rng.uniform(-3, 3, 4), rng.uniform(-3, 3, (4, 3))
    assert_same(port_geometry.box_corners_votenet(size, heading, center),
                jax_geometry.box_corners_votenet(size, heading, center))
    assert_same(port_geometry.get_3d_box(size[0], heading[0], center[0]),
                jax_geometry.get_3d_box(size[0], heading[0], center[0]))
    assert_same(port_geometry.size2class(size[0], "chair"), jax_geometry.size2class(size[0], "chair"))
    pc = rng.uniform(-1, 1, (50, 3))
    box = jax_geometry.get_3d_box((1.0, 1.2, 0.8), 0.3, (0.1, 0.0, 0.2))
    assert_same(port_geometry.extract_pc_in_box3d(pc, box), jax_geometry.extract_pc_in_box3d(pc, box))
    assert_same(port_geometry.flip_axis_to_camera(pc), jax_geometry.flip_axis_to_camera(pc))
    assert_same(port_geometry.flip_axis_to_depth(pc), jax_geometry.flip_axis_to_depth(pc))


# --- synthetic scenes and batching ---

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_scenes_byte_equal(seed):
    for preset in ("tiny_config", "default_config"):
        port = port_synthetic.synthetic_scenes(seed, getattr(port_config, preset)(), 3)
        ref = jax_synthetic.synthetic_scenes(seed, getattr(jax_config, preset)(), 3)
        assert_same(port, ref)
        assert_same(port_synthetic.synthetic_gt_all(port), jax_synthetic.synthetic_gt_all(ref))


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_scenes_equal(drop_remainder):
    cfg = port_config.tiny_config()
    scenes = port_synthetic.synthetic_scenes(3, cfg, 5)
    port = list(port_dataflow.batch_scenes(iter(scenes), 2, cfg.max_gt_boxes, drop_remainder))
    ref = list(jax_dataflow.batch_scenes(iter(scenes), 2, cfg.max_gt_boxes, drop_remainder))
    assert len(port) == (2 if drop_remainder else 3)
    assert_same(port, ref)
    with pytest.raises(port_dataflow.GTOverflowError):
        list(port_dataflow.batch_scenes(iter(scenes), 2, 1))
    assert_same(port_dataflow.scan_gt_counts(iter(scenes)), jax_dataflow.scan_gt_counts(iter(scenes)))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("reject_mode", ["frustum", "in_box"])
def test_sunrgbd_dataflow_equal(tmp_path, training, reject_mode):
    """Both dataflows over one on-disk fixture (the JAX package's fake SUN
    RGB-D writer) give the same scenes, with and without their cache."""
    make_fake_sunrgbd(str(tmp_path / "root"), [1, 2, 3], np.random.RandomState(0))
    cfg = port_config.tiny_config(reject_mode=reject_mode)
    jcfg = jax_config.tiny_config(reject_mode=reject_mode)
    for cache in (None, "cache"):
        kw = dict(idx_list=[1, 2, 3], seed=7)
        port = list(port_dataflow.SunRGBDDataFlow(
            str(tmp_path / "root"), "training", training, cfg,
            cache_dir=str(tmp_path / f"port_{cache}") if cache else None, **kw))
        ref = list(jax_dataflow.SunRGBDDataFlow(
            str(tmp_path / "root"), "training", training, jcfg,
            cache_dir=str(tmp_path / f"jax_{cache}") if cache else None, **kw))
        assert len(port) == 3
        assert_same(port, ref)


def test_sunrgbd_readers_equal(tmp_path):
    make_fake_sunrgbd(str(tmp_path), [4], np.random.RandomState(1))
    port = port_sunrgbd.SunRGBDObjectDataset(str(tmp_path), "training", [4])
    ref = jax_sunrgbd.SunRGBDObjectDataset(str(tmp_path), "training", [4])
    assert_same(port.get_depth(4), ref.get_depth(4))
    calib_p, calib_j = port.get_calibration(4), ref.get_calibration(4)
    for po, jo in zip(port.get_label_objects(4), ref.get_label_objects(4)):
        assert_same(vars(po), vars(jo))
        assert_same(port_sunrgbd.compute_box_3d(po, calib_p), jax_sunrgbd.compute_box_3d(jo, calib_j))


# --- evaluation ---

def fixed_detections():
    """Three scenes of GT labels and detections: boxes near the GT, some off,
    one class without GT, one scene without detections."""
    rng = np.random.RandomState(5)
    labels, pred = {}, {}
    for img in (11, 12, 13):
        n = 4
        lab = {
            "bboxes_xyz": rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            "bboxes_lwh": rng.uniform(0.4, 1.5, (n, 3)).astype(np.float32),
            "bboxes_roty": rng.uniform(-3, 3, n).astype(np.float32),
            "semantic_labels": rng.randint(0, 4, n).astype(np.int32),
        }
        labels[img] = lab
        if img == 13:
            pred[img] = []
            continue
        dets = []
        for j in range(n + 3):
            k = j % n
            jitter = rng.normal(0, 0.05 if j < n else 0.5, 3)
            corners = jax_geometry.box_corners_votenet(
                lab["bboxes_lwh"][k], lab["bboxes_roty"][k] + jitter[0], lab["bboxes_xyz"][k] + jitter)
            cls = jax_geometry.CLASS2TYPE[int(lab["semantic_labels"][k]) if j != n + 2 else 9]
            dets.append((cls, corners.astype(np.float32), float(rng.uniform())))
        pred[img] = dets
    return labels, pred


def test_gt_dict_from_labels_equal():
    labels, _ = fixed_detections()
    assert_same(port_gt_dict(labels), jax_gt_dict(labels))


@pytest.mark.parametrize("ovthresh", [0.25, 0.5])
def test_eval_det_equal(ovthresh):
    labels, pred = fixed_detections()
    gt_all = jax_gt_dict(labels)
    port = port_ap.eval_det(pred, gt_all, ovthresh)
    ref = jax_ap.eval_det(pred, gt_all, ovthresh)
    assert_same(port, ref)
    assert any(v > 0 for v in port[2].values())  # something matched
    rec, prec = np.linspace(0, 1, 7), np.linspace(1, 0.3, 7)
    for use_07 in (False, True):
        assert port_ap.voc_ap(rec, prec, use_07) == jax_ap.voc_ap(rec, prec, use_07)


# --- metrics ---

def test_metric_logger_stat_json_equal(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    runs = {}
    for name, mod in (("port", port_metrics), ("jax", jax_metrics)):
        log = mod.MetricLogger(str(tmp_path / name), print_every=2)
        for step in range(5):
            log.log_step(step, {"loss": 1.0 / (step + 1), "w_rms/a": float(step)})
        log.log_epoch(0, {"lr": 1e-3})
        log.log_step(5, {"loss": 0.1})
        log.log_epoch(1, {"lr": 1e-4})
        runs[name] = ((tmp_path / name / "stat.json").read_text(), capsys.readouterr().out)
    assert runs["port"] == runs["jax"]
    assert len(json.loads(runs["port"][0])) == 2


# --- native host library ---

def random_boxes(rng, n):
    return jax_geometry.box_corners_votenet(
        rng.uniform(0.3, 2.0, (n, 3)), rng.uniform(-3, 3, n), rng.uniform(-1, 1, (n, 3))).astype(np.float32)


def test_native_library_builds_into_the_port():
    assert port_native.available()
    assert port_native.library_path().parent == port_native.BUILD_DIR
    assert port_native.BUILD_DIR.parent.name == "votenet_tpu_torch"


def _load_error(path) -> str:
    try:
        ctypes.CDLL(str(path))
        return "loads now"
    except OSError as e:
        return str(e)


@pytest.fixture
def jax_native_lib(monkeypatch):
    """The JAX package's native library, loaded whichever process built it.

    ``votenet_tpu.native`` runs ``make`` once per process where the library
    is missing and latches any failure to load. Under pytest-xdist every
    worker imports ``tests/test_native.py``, whose ``skipif`` calls
    ``native.available()`` while collecting: the workers build at once, g++
    writes ``libvotenet_native.so`` in place, and a worker that loads it
    while another is still writing it gets "file too short" and keeps that
    failure for the session. After such a latched failure, this runs
    ``make`` again under a lock (every worker has collected by the time a
    test runs, so the file is whole), re-arms the latch and loads again; a
    file still broken is rebuilt once (``make -B``)."""
    if jax_native.available():
        return jax_native
    native_dir = os.path.dirname(jax_native._SO)
    first = _load_error(jax_native._SO)
    runs = []
    with open(Path(tempfile.gettempdir()) / "votenet_tpu_native_make.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for force in ([], ["-B"]):
            res = subprocess.run(["make", "-C", native_dir, "-s", *force], capture_output=True, text=True, timeout=300)
            runs.append(f"make {' '.join(['-C', native_dir, '-s', *force])}: exit {res.returncode} {res.stdout}{res.stderr}")
            monkeypatch.setattr(jax_native, "_tried", False)
            monkeypatch.setattr(jax_native, "_lib", None)
            if jax_native.available():
                return jax_native
    pytest.fail(f"votenet_tpu.native did not load: first {first}; then {'; '.join(runs)}; "
                f"now {_load_error(jax_native._SO)}")


def test_native_iou_matcher_nms_equal(jax_native_lib):
    assert port_native.available(), f"votenet_tpu_torch.native did not build: {port_native._error}"
    jax_native = jax_native_lib
    rng = np.random.RandomState(2)
    dets, gts = random_boxes(rng, 40), random_boxes(rng, 12)
    iou = port_native.iou3d_matrix(dets, gts)
    assert_same(iou, jax_native.iou3d_matrix(dets, gts))
    assert (iou > 0).any()
    for th in (0.05, 0.25):
        assert_same(port_native.greedy_match(iou, th), jax_native.greedy_match(iou, th))
    scores = rng.uniform(size=40).astype(np.float32)
    obj = rng.normal(size=(40, 2)).astype(np.float32)
    for th in (0.0, 0.25):
        assert_same(port_native.nms3d_host(dets, scores, obj, th), jax_native.nms3d_host(dets, scores, obj, th))
    text = " ".join(f"{v:.6f}" for v in rng.normal(size=300)) + "\n1e-3 -2.5\t7"
    assert_same(port_native.parse_floats(text), jax_native.parse_floats(text))


def test_native_raises_when_it_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_error", None)
    monkeypatch.setattr(port_native, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not port_native.available()
    with pytest.raises(RuntimeError, match="could not be built"):
        port_native.iou3d_matrix(np.zeros((1, 8, 3)), np.zeros((1, 8, 3)))
