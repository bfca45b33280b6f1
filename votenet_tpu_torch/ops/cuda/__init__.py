"""Build and load the port's hand-written CUDA kernels.

``votenet_tpu_torch/csrc/*.cu`` are compiled on first use into one shared
library with a plain C interface, ``build/libvotenet_kernels_<hash>.so``
inside the package, and loaded with :mod:`ctypes`. The hash covers the
sources and the flags, so an edited source builds anew and an unchanged one
is loaded as built. Nothing here runs at import time: this module is
imported on machines without ``nvcc`` or a GPU, where only the plain PyTorch
versions of the kernels run.

A failed build raises. There is no fallback to the plain versions for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
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
# (the distance sums are also written with __fmul_rn/__fadd_rn); see the
# notes in csrc/fps.cu and csrc/ballquery.cu. -Xptxas=-v puts each kernel's
# registers, shared memory and spills into the build log.
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
    for src in sorted(CSRC_DIR.glob("*.cu")):
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
            lib.votenet_fps.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr]
            lib.votenet_fps.restype = i32
            lib.votenet_fps_smem_limit.argtypes = []
            lib.votenet_fps_smem_limit.restype = i32
            lib.votenet_ball_query.argtypes = [
                ptr, ptr, i32, i32, i32, f32, i32, ptr, ptr, ptr
            ]
            lib.votenet_ball_query.restype = i32
            lib.votenet_error_string.argtypes = [i32]
            lib.votenet_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


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
