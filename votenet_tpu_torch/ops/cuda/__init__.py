"""Build and load the port's hand-written CUDA kernels.

``votenet_tpu_torch/csrc/*.cu`` (and the ``*.cuh`` headers they include) are
compiled on first use into one shared library with a plain C interface,
``build/libvotenet_kernels_<hash>.so`` inside the package, and loaded with
:mod:`ctypes`. The hash covers the sources, the headers and the flags, so an edited source builds anew and an unchanged one
is loaded as built. Nothing here runs at import time: this module is
imported on machines without ``nvcc`` or a GPU, where only the plain PyTorch
versions of the kernels run.

A failed build raises. There is no fallback to the plain versions for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# -fmad=false: no contraction of a*b+c into an FMA anywhere in the kernels
# (the distance sums and samlp's affine steps are also written with
# __fmul_rn/__fadd_rn; samlp's matmuls run on wgmma, which the flag does not
# touch); see the notes in csrc/fps.cu, csrc/ballquery.cu, csrc/samlp.cu,
# csrc/iou3d.cu, csrc/decode.cu and csrc/batchnorm.cu.
# -Xptxas=-v puts each kernel's registers, shared memory and spills into the
# build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of votenet_tpu_torch cannot be built")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvotenet_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.

    Returns the library's path; the compiler's output (``-Xptxas=-v``) is
    kept beside it as ``.log``. Raises RuntimeError if nvcc fails.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {res.returncode}:\n{res.stdout}{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.votenet_fps.argtypes = [ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
            lib.votenet_fps.restype = i32
            lib.votenet_fps_max_clusters.argtypes = [i32, i32]
            lib.votenet_fps_max_clusters.restype = i32
            lib.votenet_ball_query.argtypes = [
                ptr, ptr, i32, i32, i32, f32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr
            ]
            lib.votenet_ball_query.restype = i32
            lib.votenet_scatter_add.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr]
            lib.votenet_scatter_add.restype = i32
            ptrs, ints = ctypes.POINTER(ptr), ctypes.POINTER(i32)
            lib.votenet_samlp.argtypes = [
                ptr, ptr, ptr, ptr, ptrs, ptrs, ptrs, ints, ints, ints,
                i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr,
            ]
            lib.votenet_samlp.restype = i32
            i64 = ctypes.c_int64
            lib.votenet_nms3d.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, f32, ptr, ptr, ptr]
            lib.votenet_nms3d.restype = i32
            lib.votenet_nms3d_workspace_words.argtypes = [i32, i32]
            lib.votenet_nms3d_workspace_words.restype = i64
            lib.votenet_iou3d.argtypes = [ptr, ptr, i32, i32, i32, ptr, ptr]
            lib.votenet_iou3d.restype = i32
            lib.votenet_decode.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, ptr, ptr, ptr, ptr, ptr, ptr,
                                           ptr, ptr]
            lib.votenet_decode.restype = i32
            lib.votenet_decode_iou.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, i32, ctypes.c_longlong,
                                               ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
            lib.votenet_decode_iou.restype = i32
            # R, C, vec, W, ctas, tiles, units a CTA (after the prologue's corr, dense bias and S)
            bn_plan = [i64, i32, i32, i32, i32, i32, i64]
            bn_pro = [ptr, ptr, i32]
            # the statistics' end: st, weight, running mean and var, update, 1 / count, eps, momentum, 1 - momentum
            bn_stats_end = [ptr, ptr, ptr, ptr, i32, f32, f32, f32, f32]
            lib.votenet_bn_stats.argtypes = [ptr, i32, *bn_pro, *bn_plan, i32, ptr, ptr, ptr, ptr, *bn_stats_end, ptr]
            # ..., mean, mul, bias, eval_var, eps, relu, the group's sums and the statistics' end
            lib.votenet_bn_apply.argtypes = [ptr, i32, *bn_pro, ptr, i32, ptr, *bn_plan, ptr, ptr, ptr, ptr, f32, i32,
                                             ptr, *bn_stats_end, ptr]
            bn_dy = [ptr, i32, ptr, ptr]  # dy, its bf16 flag, the pool's maxima and counts
            # ..., mean, mul, bias, eval_var, eps, relu, the workspace, tickets, sums, the coefficients' end (out,
            # st, weight, 1 / count, training)
            lib.votenet_bn_bwd_reduce.argtypes = [ptr, i32, *bn_pro, *bn_dy, *bn_plan, i32, ptr, ptr, ptr, ptr, f32,
                                                  i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, f32, i32, ptr]
            # ..., mean, mul, bias, eval_var, eps, a, b, relu, the epilogue (0, 1 or 2), its d_corr and
            # d_dense_bias, its tree's workspace, tickets and fan-in
            lib.votenet_bn_bwd_apply.argtypes = [ptr, i32, *bn_pro, *bn_dy, ptr, *bn_plan, ptr, ptr, ptr, ptr, f32,
                                                 ptr, ptr, i32, i32, ptr, ptr, ptr, ptr, i32, ptr]
            for fn in (lib.votenet_bn_stats, lib.votenet_bn_apply, lib.votenet_bn_bwd_reduce, lib.votenet_bn_bwd_apply):
                fn.restype = i32
            lib.votenet_error_string.argtypes = [i32]
            lib.votenet_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_launch(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().votenet_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err} ({msg})")


def require_cuda(name: str, t, ndim: int, last: int | None = None) -> None:
    """Check that ``t`` is what a kernel takes: a contiguous f32 CUDA tensor
    of rank ``ndim`` (and last dimension ``last``)."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise RuntimeError(f"{name}: the CUDA kernel needs a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if t.dtype != torch.float32 or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of rank {ndim}, "
            f"got {t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name}: last dimension must be {last}, got {tuple(t.shape)}")
