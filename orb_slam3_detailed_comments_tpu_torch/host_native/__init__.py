"""The port's host library: map bookkeeping and PNG row unfiltering in C++.

``slam_host.cpp`` holds the map helpers (``update_point_stats``,
``replace_point``, ``build_incidence_bits``, ``covis_counts``,
``observers_of``, ``observation_counts``) and ``png_unfilter.cpp`` the
PNG decoder's row filters. Both are host code: ``MapStore`` and
``utils/png`` call them on every device, the card's and the CPU's. Each
entry has a numpy twin of the same signature in ``plain``, which the tests
hold it to and nothing else calls.

On first use g++ builds ``build/torch_host/libslam_host.so`` at the
repository root (``-O3 -std=c++17 -shared -fPIC``, no PyTorch header) and
ctypes loads it; a library newer than both sources is reused. Each build
writes a name of its own and moves it into place with ``os.replace``, so
processes that build at once leave one whole library. A failed build
raises: there is no quiet numpy fallback.

Descriptors are the port's int32 words; the wrappers hand them over as
uint32 views, which changes no bit.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import uuid
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO_ROOT = HERE.parent.parent
SOURCES = (HERE / "slam_host.cpp", HERE / "png_unfilter.cpp")
BUILD_DIR = REPO_ROOT / "build" / "torch_host"
LIB_PATH = BUILD_DIR / "libslam_host.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "update_point_stats": ([_I] * 5 + [_P] * 14, ctypes.c_int),
    "replace_point": ([_I, _I, _P, _P, ctypes.c_int32, ctypes.c_int32],
                      ctypes.c_int),
    "build_incidence_bits": ([_I, _I, _I, _P, _P, _P], None),
    "covis_counts": ([_I, _I, _P, _P, _I, _P, _P], None),
    "observers_of": ([_I, _I, _P, _P, _P, _P], None),
    "observation_counts": ([_I, _I, _I, _P, _P, _P], None),
    "png_unfilter": ([_I, _I, _I, _P, _P], ctypes.c_int),
}

_lib = None
_lock = threading.Lock()
n_builds = 0          # g++ builds run by this process


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library, unless a library newer
    than both is in place. Raises RuntimeError if g++ fails."""
    global n_builds
    newest = max(s.stat().st_mtime for s in SOURCES)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libslam_host.{os.getpid()}.{uuid.uuid4().hex}.so"
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, *map(str, SOURCES), "-o",
                              str(tmp)], capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {LIB_PATH.name}:\n"
                           f"{out.stdout}{out.stderr}")
    n_builds += 1
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                handle = ctypes.CDLL(str(build()))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(handle, name)
                    fn.argtypes, fn.restype = argtypes, restype
                _lib = handle
    return _lib


def _ptr(a: np.ndarray, dtype) -> int:
    if a.dtype != np.dtype(dtype) or not a.flags["C_CONTIGUOUS"]:
        raise TypeError(f"expected a C-contiguous {np.dtype(dtype)} array, "
                        f"got {a.dtype} (contiguous: "
                        f"{a.flags['C_CONTIGUOUS']})")
    return a.ctypes.data


def _words(a: np.ndarray) -> np.ndarray:
    """A descriptor array's uint32 view (int32 or uint32 words)."""
    if a.dtype not in (np.dtype(np.int32), np.dtype(np.uint32)):
        raise TypeError(f"descriptor words must be int32 or uint32, not "
                        f"{a.dtype}")
    return a.view(np.uint32)


def update_point_stats(kf_valid, kf_feat_point, kf_feat_desc, kf_feat_level,
                       kf_R, kf_t, pt_xyz, pt_ref_kf, pids, scale_factors,
                       pt_desc, pt_normal, pt_min_dist, pt_max_dist) -> int:
    """Representative descriptor, viewing normal and scale range of the
    points ``pids``, written in place into ``pt_desc``, ``pt_normal``,
    ``pt_min_dist``, ``pt_max_dist`` (and ``pt_ref_kf`` where the
    reference keyframe no longer observes the point). Returns the number
    of points that have an observation."""
    K, N = kf_feat_point.shape
    pids = np.ascontiguousarray(pids, np.int64)
    sf = np.ascontiguousarray(scale_factors, np.float32)
    return lib().update_point_stats(
        K, N, pt_xyz.shape[0], len(pids), len(sf),
        _ptr(kf_valid, bool), _ptr(kf_feat_point, np.int32),
        _ptr(_words(kf_feat_desc), np.uint32),
        _ptr(kf_feat_level, np.int32), _ptr(kf_R, np.float32),
        _ptr(kf_t, np.float32), _ptr(pt_xyz, np.float32),
        _ptr(pt_ref_kf, np.int32), _ptr(pids, np.int64),
        _ptr(sf, np.float32), _ptr(_words(pt_desc), np.uint32),
        _ptr(pt_normal, np.float32), _ptr(pt_min_dist, np.float32),
        _ptr(pt_max_dist, np.float32))


def replace_point(kf_valid, kf_feat_point, old_id: int, new_id: int) -> int:
    """Relink live keyframes' observations of old_id to new_id in place; a
    keyframe that already observes new_id drops the old link. Returns the
    number of relinked observations."""
    K, N = kf_feat_point.shape
    return lib().replace_point(K, N, _ptr(kf_valid, bool),
                               _ptr(kf_feat_point, np.int32), int(old_id),
                               int(new_id))


def build_incidence_bits(kf_valid, kf_feat_point, P: int) -> np.ndarray:
    """[K, ceil(P/64)] uint64 bitsets: bit p & 63 of word p >> 6 of row k
    is set iff live keyframe k observes point p."""
    K, N = kf_feat_point.shape
    bits = np.empty((K, (P + 63) // 64), np.uint64)
    lib().build_incidence_bits(K, N, P, _ptr(kf_valid, bool),
                               _ptr(kf_feat_point, np.int32),
                               _ptr(bits, np.uint64))
    return bits


def covis_counts(bits, kf_valid, ks) -> np.ndarray:
    """[M, K] int32 shared-point counts of the query keyframes ks against
    every keyframe (0 against dead ones)."""
    K, Pw = bits.shape
    ks = np.ascontiguousarray(ks, np.int64)
    out = np.empty((len(ks), K), np.int32)
    lib().covis_counts(K, Pw, _ptr(bits, np.uint64), _ptr(kf_valid, bool),
                       len(ks), _ptr(ks, np.int64), _ptr(out, np.int32))
    return out


def observers_of(bits, kf_valid, pt_ids, P: int) -> np.ndarray:
    """[K] bool: live keyframes that observe any of pt_ids."""
    K, Pw = bits.shape
    pt_bits = np.zeros(Pw, np.uint64)
    ids = np.asarray(pt_ids, np.int64)
    np.bitwise_or.at(pt_bits, ids >> 6,
                     np.uint64(1) << (ids & 63).astype(np.uint64))
    out = np.empty(K, np.uint8)
    lib().observers_of(K, Pw, _ptr(bits, np.uint64), _ptr(kf_valid, bool),
                       _ptr(pt_bits, np.uint64), _ptr(out, np.uint8))
    return out.astype(bool)


def observation_counts(kf_valid, kf_feat_point, P: int) -> np.ndarray:
    """[P] int32: the number of live keyframes observing each point."""
    K, N = kf_feat_point.shape
    out = np.empty(P, np.int32)
    lib().observation_counts(K, N, P, _ptr(kf_valid, bool),
                             _ptr(kf_feat_point, np.int32),
                             _ptr(out, np.int32))
    return out


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw is the inflated stream, height
    rows of (filter byte + stride bytes); returns [height, stride] uint8.
    bpp is the bytes per pixel (at least 1). Raises ValueError on a filter
    byte outside 0-4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"the image data holds {raw.size} bytes, not "
                         f"{height} rows of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    rc = lib().png_unfilter(height, stride, max(1, int(bpp)),
                            _ptr(raw, np.uint8), _ptr(out, np.uint8))
    if rc != 0:
        raise ValueError(f"row {-rc - 1} has filter type "
                         f"{raw[(-rc - 1) * (stride + 1)]}, not 0-4")
    return out
