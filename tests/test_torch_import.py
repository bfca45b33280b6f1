"""The port's boundaries: no JAX inside it, and no hidden fallback in its
kernel wrappers (a CPU tensor takes the plain version; a kernel wrapper
given anything but a CUDA tensor raises before it computes or builds)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from votenet_tpu.config import tiny_config
from votenet_tpu_torch import ops
from votenet_tpu_torch.ops.cuda import ballquery as bq_mod
from votenet_tpu_torch.ops.cuda import fps as fps_mod

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax_module():
    code = (
        "import sys\n"
        "import votenet_tpu_torch, votenet_tpu_torch.ops, votenet_tpu_torch.models\n"
        "import votenet_tpu_torch.predictor, votenet_tpu_torch.entry, votenet_tpu_torch.ops.cuda\n"
        "from votenet_tpu.data import synthetic\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cpu_tensors_launch_no_kernel():
    before = (fps_mod.farthest_point_sample_cuda.launches, bq_mod.query_ball_point_cuda.launches)
    xyz = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 3).astype(np.float32))
    ops.farthest_point_sample(8, xyz)
    ops.query_ball_point(0.4, 4, xyz, xyz[:, :8].contiguous())
    from votenet_tpu_torch.predictor import VoteNetPredictor

    VoteNetPredictor(tiny_config(), device="cpu", batch_size=1).detect(xyz[0].numpy())
    after = (fps_mod.farthest_point_sample_cuda.launches, bq_mod.query_ball_point_cuda.launches)
    assert after == before == (0, 0)


@pytest.mark.parametrize("kernel", ["fps", "ballquery"])
def test_kernel_wrapper_raises_without_a_card(monkeypatch, kernel):
    """Given a CPU tensor, the wrapper raises: it neither computes the plain
    version nor builds the library."""

    def no_build():
        raise AssertionError("the wrapper tried to build or load the kernels")

    monkeypatch.setattr(fps_mod, "library", no_build)
    monkeypatch.setattr(bq_mod, "library", no_build)
    xyz = torch.zeros(1, 16, 3)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        if kernel == "fps":
            fps_mod.farthest_point_sample_cuda(4, xyz)
        else:
            bq_mod.query_ball_point_cuda(0.2, 4, xyz, xyz)
    assert fps_mod.farthest_point_sample_cuda.launches == 0
    assert bq_mod.query_ball_point_cuda.launches == 0


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
