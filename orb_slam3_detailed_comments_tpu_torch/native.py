"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``csrc/`` have a plain C interface. On first use each is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``
and the objects are linked into ``build/torch_kernels/libslamkernels.so``
at the repository root, which is loaded with ctypes. A library newer than
every source is reused. Kernels launch on PyTorch's current stream; each C
entry returns ``cudaGetLastError()``, and ``check`` raises if it is not 0.

``launches`` holds one count per kernel (``utils.counters.Counts``: safe
to add to from several threads). A wrapper adds one where it launches its
kernel, and nowhere else; the CPU path never touches it.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

from .utils.counters import Counts

REPO_ROOT = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libslamkernels.so"
SOURCES = ("topk.cu", "patches.cu", "hamming.cu", "frontend.cu",
           "pose_gn.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = Counts("cell_topk", "gather_patches", "hamming_best2",
                  "hamming_best2_windowed", "dense_frontend", "pose_gn")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "slam_cell_topk_levels": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                              _I, _P],
    "slam_gather_patches_levels": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P,
                                   _P],
    "slam_hamming_best2": [_P, _I, _P, _P, _I, _P, _P, _P, _P],
    "slam_hamming_best2_windowed": [_P, _P, _P, _P, _P, _P, _P, _I,
                                    _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "slam_dense_frontend_levels": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "slam_frontend_umax": [_P],
    "slam_best2_lanes": [_P],
    "slam_pose_gn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P,
                     _P, _P, _P],
}

_lib = None
build_log = ""
n_builds = 0          # nvcc builds run by this process


def reset_launches() -> None:
    launches.reset()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile the sources (in parallel) and link the shared library."""
    global build_log, n_builds
    srcs = [CSRC / s for s in SOURCES]
    if (not force and LIB_PATH.exists() and LIB_PATH.stat().st_mtime
            >= max(s.stat().st_mtime for s in srcs)):
        return LIB_PATH
    nvcc = _nvcc()
    n_builds += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / (s.stem + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    build_log = "".join(logs)
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = LIB_PATH.with_suffix(".so.tmp")
    link = subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


@functools.lru_cache(maxsize=64)
def int_array(values: tuple):
    """A C int array of the values, made once for each tuple: the level
    tables that the multi-level entries copy into their by-value tables."""
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=64)
def float_array(values: tuple):
    """A C float array of the values, made once for each tuple: a camera's
    parameters for the pose solve."""
    return (ctypes.c_float * len(values))(*values)


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Wrapper-side argument checks before a raw pointer is handed over."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
