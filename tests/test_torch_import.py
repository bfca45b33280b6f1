"""The port's boundaries: no JAX and nothing of the JAX package inside it,
and no hidden fallback in its kernel wrappers (a CPU tensor takes the plain
version; a kernel wrapper given anything but a CUDA tensor raises before it
computes or builds)."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from votenet_tpu_torch.config import tiny_config
from votenet_tpu_torch import ops
from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
from votenet_tpu_torch.ops.cuda import batchnorm as bn_mod
from votenet_tpu_torch.ops.cuda import decode as decode_mod
from votenet_tpu_torch.ops.cuda import fps as fps_mod
from votenet_tpu_torch.ops.cuda import iou3d as iou_mod
from votenet_tpu_torch.ops.cuda import nms3d as nms_mod
from votenet_tpu_torch.ops.cuda import samlp as samlp_mod
from votenet_tpu_torch.ops.cuda import scatter as scatter_mod

REPO = Path(__file__).resolve().parents[1]


PORT_FILES = sorted((REPO / "votenet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_jax_module():
    """Importing every module of the port loads no JAX module and no module
    of the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES if p.parent != REPO
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'votenet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def imported_modules(tree: ast.AST):
    """Every module an import statement names, in function bodies too."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_the_jax_package(path):
    """No import statement of the port or of chip_smoke.py, at any depth,
    names ``votenet_tpu``, ``jax`` or ``flax``."""
    bad = sorted({m for m in imported_modules(ast.parse(path.read_text()))
                  if m.split(".")[0] in ("votenet_tpu", "jax", "jaxlib", "flax", "optax")})
    assert bad == []


def test_import_scan_sees_function_bodies():
    tree = ast.parse("def f():\n    from votenet_tpu import native\n    import votenet_tpu.config as c\n")
    assert {"votenet_tpu", "votenet_tpu.native", "votenet_tpu.config"} <= set(imported_modules(tree))


def test_cpu_tensors_launch_no_kernel():
    def counts():
        return (fps_mod.farthest_point_sample_cuda.launches, bq_mod.query_ball_point_cuda.launches,
                bq_mod.query_ball_point_cuda.fast_bf16.launches, nms_mod.nms3d_greedy_cuda.launches,
                iou_mod.box3d_iou_matrix_cuda.launches, decode_mod.decode_proposals_cuda.launches,
                bn_mod.bn_apply_cuda.launches, decode_mod.decode_iou_cuda.launches)

    before = counts()
    xyz = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 3).astype(np.float32))
    ops.farthest_point_sample(8, xyz)
    ops.query_ball_point(0.4, 4, xyz, xyz[:, :8].contiguous())
    ops.query_ball_point(0.4, 4, xyz, xyz[:, :8].contiguous(), "fast_bf16")
    from votenet_tpu_torch.predictor import VoteNetPredictor

    VoteNetPredictor(tiny_config(), device="cpu", batch_size=1).detect(xyz[0].numpy())
    assert counts() == before == (0, 0, 0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("kernel", ["fps", "ballquery", "scatter", "samlp", "ballquery_fast_bf16", "nms3d", "iou3d",
                                    "decode", "decode_iou", "bn_stats", "bn_stats_no_rows", "bn_apply",
                                    "bn_apply_group", "bn_bwd_reduce", "bn_bwd_reduce_eval", "bn_bwd_apply",
                                    "bn_bwd_apply_eval"])
def test_kernel_wrapper_raises_without_a_card(monkeypatch, kernel):
    """Given a CPU tensor, the wrapper raises: it neither computes the plain
    version nor builds the library."""

    def no_build():
        raise AssertionError("the wrapper tried to build or load the kernels")

    monkeypatch.setattr(fps_mod, "library", no_build)
    monkeypatch.setattr(bq_mod, "library", no_build)
    monkeypatch.setattr(scatter_mod, "library", no_build)
    monkeypatch.setattr(samlp_mod, "library", no_build)
    monkeypatch.setattr(nms_mod, "library", no_build)
    monkeypatch.setattr(iou_mod, "library", no_build)
    monkeypatch.setattr(decode_mod, "library", no_build)
    monkeypatch.setattr(bn_mod, "library", no_build)
    xyz = torch.zeros(1, 16, 3)
    rows, v = torch.zeros(8, 4), torch.zeros(4)
    channels = bn_mod.BnChannels(8, v, 1e-5, 0.9, v.clone(), v.clone(), True)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        if kernel == "fps":
            fps_mod.farthest_point_sample_cuda(4, xyz)
        elif kernel == "ballquery":
            bq_mod.query_ball_point_cuda(0.2, 4, xyz, xyz)
        elif kernel == "ballquery_fast_bf16":
            bq_mod.query_ball_point_cuda(0.2, 4, xyz, xyz, mode="fast_bf16")
        elif kernel == "nms3d":
            nms_mod.nms3d_greedy_cuda(torch.zeros(1, 16, 16), torch.zeros(1, 16), torch.zeros(1, 16, 2), 0.25)
        elif kernel == "decode":
            decode_mod.decode_proposals_cuda(torch.zeros(1, 16, 79), xyz, torch.zeros(10, 3), 12, 10, 10)
        elif kernel == "decode_iou":
            decode_mod.decode_iou_cuda(torch.zeros(1, 16, 79), xyz, torch.zeros(10, 3), 12, 10, 10)
        elif kernel == "iou3d":
            iou_mod.box3d_iou_matrix_cuda(torch.zeros(1, 4, 8, 3), torch.zeros(1, 5, 8, 3))
        elif kernel == "scatter":
            scatter_mod.scatter_add_cuda(xyz, torch.zeros(1, 16, dtype=torch.int32), 4)
        elif kernel == "bn_stats":
            bn_mod.bn_stats_cuda(rows)
        elif kernel == "bn_stats_no_rows":
            bn_mod.bn_stats_cuda(rows[:0], channels=channels)
        elif kernel == "bn_apply":
            bn_mod.bn_apply_cuda(rows, v, v, v, torch.float32, True)
        elif kernel == "bn_apply_group":
            bn_mod.bn_apply_cuda(rows, None, None, v, torch.float32, True, group_sums=torch.zeros(2, 4).double(),
                                 channels=channels)
        elif kernel == "bn_bwd_reduce":
            bn_mod.bn_bwd_reduce_cuda(rows, rows, v, v, v, True)
        elif kernel == "bn_bwd_reduce_eval":
            bn_mod.bn_bwd_reduce_cuda(rows, rows, v, v, v, True, eval_var=v.clone(),
                                      coefficients=bn_mod.BnCoefficients(None, v, 8, False))
        elif kernel == "bn_bwd_apply":
            bn_mod.bn_bwd_apply_cuda(rows, rows, v, v, v, v, v, True)
        elif kernel == "bn_bwd_apply_eval":
            bn_mod.bn_bwd_apply_cuda(rows, rows, v, v, v, None, None, True, eval_var=v.clone())
        else:
            layer = (torch.zeros(3, 5), torch.ones(5), torch.zeros(5))
            samlp_mod.fused_sa_mlp_pool_cuda(
                xyz, torch.zeros(1, 4, 8, dtype=torch.int32), torch.zeros(1, 4, 3), torch.ones(3), [layer]
            )
    assert fps_mod.farthest_point_sample_cuda.launches == 0
    assert bq_mod.query_ball_point_cuda.launches == 0
    assert scatter_mod.scatter_add_cuda.launches == 0
    assert samlp_mod.fused_sa_mlp_pool_cuda.launches == 0
    assert bq_mod.query_ball_point_cuda.fast_bf16.launches == nms_mod.nms3d_greedy_cuda.launches == 0
    assert iou_mod.box3d_iou_matrix_cuda.launches == decode_mod.decode_proposals_cuda.launches == 0
    assert decode_mod.decode_iou_cuda.launches == 0
    assert [getattr(bn_mod, f"bn_{k}_cuda").launches for k in ("stats", "apply", "bwd_reduce", "bwd_apply")] == [0] * 4
    assert bn_mod.bn_apply_cuda.group.launches == 0


def test_cpu_eval_launches_no_kernel():
    """An evaluation on the CPU with samlp on runs the plain versions: no
    kernel counter moves."""
    from votenet_tpu_torch.data.synthetic import synthetic_gt_all, synthetic_scenes
    from votenet_tpu_torch.eval import DeviceSceneCache, Evaluator, make_packed_predict_fn
    from votenet_tpu_torch.models import VoteNet

    cfg = tiny_config(samlp="on")
    scenes = synthetic_scenes(0, cfg, 3)
    pairs = [(int(s["data_idx"]), s["points"]) for s in scenes]
    calls = []
    plain = samlp_mod.fused_sa_mlp_pool_plain

    def counted(*a):
        calls.append(1)
        return plain(*a)

    import votenet_tpu_torch.ops.samlp as samlp_op

    samlp_op.fused_sa_mlp_pool_plain, saved = counted, samlp_op.fused_sa_mlp_pool_plain
    try:
        Evaluator(cfg, synthetic_gt_all(scenes), batch_size=2).evaluate(
            make_packed_predict_fn(VoteNet(cfg), cfg), DeviceSceneCache(pairs, 2, "cpu"))
    finally:
        samlp_op.fused_sa_mlp_pool_plain = saved
    assert len(calls) == 10  # 2 batches, 5 fused calls each, all plain
    counters = (fps_mod.farthest_point_sample_cuda, bq_mod.query_ball_point_cuda, samlp_mod.fused_sa_mlp_pool_cuda)
    assert [c.launches for c in counters] == [0, 0, 0]


def test_cpu_training_step_launches_no_kernel():
    """A training step on the CPU runs the plain versions: the backward's
    scatter too, and all three launch counters stay at 0."""
    from votenet_tpu_torch.data.dataflow import batch_scenes
    from votenet_tpu_torch.data.synthetic import synthetic_scenes
    from votenet_tpu_torch.train import create_train_state, make_train_step

    cfg = tiny_config()
    batch = next(batch_scenes(iter(synthetic_scenes(0, cfg, 2)), 2, cfg.max_gt_boxes))
    state = create_train_state(cfg, 10, device="cpu")
    calls = []
    plain = scatter_mod.scatter_add_plain

    def counted(*a):
        calls.append(a[0].shape)
        return plain(*a)

    import votenet_tpu_torch.ops.grouping as grouping

    grouping.scatter_add_plain, saved = counted, grouping.scatter_add_plain
    try:
        make_train_step(cfg)(state, batch)
    finally:
        grouping.scatter_add_plain = saved
    # sa2, sa3 and sa4 scatter their features (the coordinates skipped), the
    # proposal layer votes and features; sa1's input carries no gradient
    widths = sorted(c[-1] for c in calls)
    assert widths == sorted([cfg.sa_mlps[0][-1], cfg.sa_mlps[1][-1], cfg.sa_mlps[2][-1], 3 + cfg.fp_mlps[1][-1]])
    counters = (fps_mod.farthest_point_sample_cuda, bq_mod.query_ball_point_cuda, scatter_mod.scatter_add_cuda)
    assert [c.launches for c in counters] == [0, 0, 0]


def test_scatter_scratch_stays_within_budget():
    """The sort's chunk: 2048 indices where the counts scratch is small,
    doubled for wide destination sets until a batch row's counts fit
    SCRATCH_COUNTS; the scratch shapes follow from it."""
    assert scatter_mod.scatter_chunk(65536, 2048) == 2048
    assert scatter_mod.scatter_chunk(5, 70) == 2048
    assert scatter_mod.scatter_scratch_shapes(8, 65536, 2048) == {
        "counts": (8, 32, 2048), "seg": (8, 2049), "perm": (8, 65536), "order": (8 * 2048 + 2,)}
    # the threshold: 2048 chunks of N = 2048 fit exactly, one more doubles
    assert scatter_mod.scatter_chunk(2048 * 2048, 2048) == 2048
    assert scatter_mod.scatter_chunk(2048 * 2048 + 1, 2048) == 4096
    for K, N in [(1, 1), (1000, 131072), (10**6, 10**6), (65536, 2048), (16384, 10**7)]:
        chunk = scatter_mod.scatter_chunk(K, N)
        assert chunk % 256 == 0 and chunk >= scatter_mod.SCATTER_CHUNK
        assert -(-K // chunk) * N <= scatter_mod.SCRATCH_COUNTS or chunk >= K
        assert scatter_mod.scatter_scratch_shapes(2, K, N)["counts"] == (2, -(-K // chunk), N)


def sorted_segment_model(g, idx, N, chunk):
    """The kernel's algorithm in numpy: histogram per chunk, the exclusive
    scan over (destination, chunk), the stable placement, the segment adds."""
    B, K, C = g.shape
    chunks = -(-K // chunk)
    out = np.zeros((B, N, C), np.float32)
    for b in range(B):
        counts = np.zeros((chunks, N), np.int64)
        for k, n in enumerate(idx[b]):
            if 0 <= n < N:
                counts[k // chunk, n] += 1
        flat = counts.T.reshape(-1)  # (destination, chunk) order
        offsets = (np.cumsum(flat) - flat).reshape(N, chunks).T.copy()
        seg = np.append(offsets[0], flat.sum())
        perm = np.full(K, -1)
        for k, n in enumerate(idx[b]):  # ascending k within each chunk
            if 0 <= n < N:
                perm[offsets[k // chunk, n]] = k
                offsets[k // chunk, n] += 1
        for n in range(N):
            for k in perm[seg[n]:seg[n + 1]]:
                out[b, n] += g[b, k]
    return out


@pytest.mark.parametrize("B,K,N,C,chunk", [(2, 700, 40, 3, 256), (1, 5, 7, 131, 256), (3, 1024, 9, 2, 512)])
def test_sorted_segment_design_matches_sequential_adds(B, K, N, C, chunk):
    """The design of csrc/scatter.cu, run as numpy, is bit-equal to a
    sequential np.add.at: one destination taking most indices, empty rows,
    out-of-range indices dropped, K not a multiple of the chunk."""
    rng = np.random.RandomState(K)
    idx = rng.randint(-2, N + 2, (B, K)).astype(np.int32)
    idx[0, : K // 2] = 1
    g = rng.randn(B, K, C).astype(np.float32)
    want = np.zeros((B, N, C), np.float32)
    for b in range(B):
        ok = (idx[b] >= 0) & (idx[b] < N)
        np.add.at(want[b], idx[b][ok], g[b][ok])
    got = sorted_segment_model(g, idx, N, chunk)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("N,cs", [(1, 1), (2560, 1), (2561, 2), (5120, 2), (5121, 4), (10240, 4),
                                  (10241, 8), (20480, 8), (20481, 16), (10**6, 16)])
def test_fps_cluster_size_by_points(N, cs):
    """A row is split so that each CTA owns at most 2560 points, into at
    most 16 CTAs: both sides of every threshold."""
    assert fps_mod.fps_cluster_size(1, N, lambda c: 132 // c) == cs
    assert fps_mod.fps_cluster_size(8, N, lambda c: 132 // c) == cs


def test_fps_cluster_size_keeps_all_clusters_resident():
    """The cluster halves while B clusters would not all fit the card at
    once: at 40960 points, B=8 takes 16 CTAs a row where 8 clusters of 16
    fit, 8 where only 7 do; B=9 takes 8, B=64 takes 2."""
    full = lambda c: 132 // c  # noqa: E731
    assert fps_mod.fps_cluster_size(8, 40960, full) == 16
    assert fps_mod.fps_cluster_size(8, 40960, lambda c: 7 if c == 16 else full(c)) == 8
    assert fps_mod.fps_cluster_size(9, 40960, full) == 8
    assert fps_mod.fps_cluster_size(64, 40960, full) == 2
    assert fps_mod.fps_cluster_size(200, 40960, full) == 1
    assert fps_mod.fps_cluster_size(1, 40960, lambda c: 0 if c > 1 else 132) == 1


@pytest.mark.parametrize("N,cs,ppt", [(20480, 16, 5), (20480, 8, 10), (20480, 4, 20), (2048, 1, 8), (1024, 1, 4),
                                      (512, 1, 2), (100, 1, 1), (256, 1, 1), (257, 1, 2), (1281, 1, 8),
                                      (70000, 16, 20), (81921, 16, 32), (131072, 16, 32), (131073, 16, 0),
                                      (200000, 16, 0), (8192, 1, 32), (8193, 1, 0)])
def test_fps_points_per_thread(N, cs, ppt):
    """Registers hold a CTA's slice while 32 points a thread cover it; past
    that the global-scratch variant (0) takes the row."""
    assert fps_mod.fps_points_per_thread(N, cs) == ppt
    if ppt:
        assert fps_mod.FPS_THREADS * ppt * cs >= N


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import votenet_tpu_torch.ops.cuda as cuda

    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()


def test_build_flags_target_hopper_without_fma():
    import votenet_tpu_torch.ops.cuda as cuda

    flags = " ".join(cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    for src in ("fps.cu", "ballquery.cu"):
        text = (cuda.CSRC_DIR / src).read_text()
        assert "__fmul_rn" in text and "__fadd_rn" in text


# --- the public names: every __all__ of the JAX package has its counterpart

# The TPU-only names the port leaves out (ROADMAP.md, "Leave these out"):
# the Pallas switches (a tensor's device chooses the route) and the
# jax.sharding objects (``shard_batch`` and ``host_local_slice`` do their
# work). The module-level TPU constants (the VMEM caps, the 16 GB budget)
# and ``scatter_add_mxu`` are in no __all__.
LEFT_OUT = {
    ("votenet_tpu.ops", "use_pallas"), ("votenet_tpu.ops", "set_use_pallas"), ("votenet_tpu.ops", "pallas_disabled"),
    ("votenet_tpu.parallel", "batch_sharding"), ("votenet_tpu.parallel", "replicated_sharding"),
}
# votenet_tpu.ops.pallas, the Pallas kernels, has its counterpart in
# votenet_tpu_torch.ops.cuda, the CUDA kernels, under other names
RENAMED = {
    ("votenet_tpu.ops.pallas", "farthest_point_sample_pallas"): ("votenet_tpu_torch.ops.cuda.fps",
                                                                "farthest_point_sample_cuda"),
    ("votenet_tpu.ops.pallas", "tpu_available"): ("torch.cuda", "is_available"),
}


def jax_public_names():
    """(package, name) of every name in an ``__all__`` of votenet_tpu and its
    subpackages, read from the sources (no JAX import)."""
    out = []
    for init in sorted((REPO / "votenet_tpu").rglob("__init__.py")):
        package = ".".join(init.relative_to(REPO).parent.parts)
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
                out += [(package, name) for name in ast.literal_eval(node.value)]
    return out


def test_every_jax_public_name_has_a_counterpart():
    import importlib

    names = jax_public_names()
    packages = {p for p, _ in names}
    assert {"votenet_tpu", "votenet_tpu.ops", "votenet_tpu.models", "votenet_tpu.train", "votenet_tpu.eval",
            "votenet_tpu.data", "votenet_tpu.parallel", "votenet_tpu.ops.pallas"} <= packages and len(names) > 70
    assert LEFT_OUT <= set(names) and set(RENAMED) <= set(names)  # the lists name real entries
    missing = []
    for package, name in names:
        if (package, name) in LEFT_OUT:
            continue
        if (package, name) in RENAMED:
            module, attr = RENAMED[package, name]
            if not callable(getattr(importlib.import_module(module), attr, None)):
                missing.append(f"{package}.{name} -> {module}.{attr}")
            continue
        port = importlib.import_module(package.replace("votenet_tpu", "votenet_tpu_torch", 1))
        if name not in getattr(port, "__all__", ()) or not hasattr(port, name):
            missing.append(f"{package}.{name}")
    assert missing == []


def test_the_left_out_names_are_absent():
    """The left-out names are not half-ported under the JAX names."""
    import importlib

    for package, name in LEFT_OUT:
        assert not hasattr(importlib.import_module(package.replace("votenet_tpu", "votenet_tpu_torch", 1)), name)
