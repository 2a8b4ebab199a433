"""Per-stage pipeline timing (the reference's REGISTER_TIMES subsystem).

Counterpart of ``utils/timing.py`` of the JAX package: the std::chrono
spans around each pipeline stage (reference: Tracking.cc:2059-2068,
LocalMapping.cc:111-158, dumped by Tracking::PrintTimeStats,
Tracking.cc:288) as a host-side registry with the same stage names. A span
measures host time: device work it queues but does not wait for falls
outside it. Spans nest; a steady frame's, each opened with ``span``:

  ORB extraction              the frame's, or the pair queued ahead
    host sync                 each image's upload
    Stereo matching
  Track total
    pose prediction
      track inputs            seed walk, ids, packed upload, map view
        host sync
      projection search, pose GN           stage 1
      local keyframes
      projection search, pose GN           stage 2
      host sync               the packed fetch
    New KF decision
      host sync               a new keyframe's features
  KF insertion, MP culling, MP creation, local BA, KF culling,
  PR detection                the keyframe event, host syncs inside

"host sync" wraps each blocking transfer or wait the port issues there,
one synchronizing CUDA call a span.

``frame`` sets the calling thread's current frame id. Where the process
has CUDA, every span is also an NVTX range named by its stage, inside a
range ``frame <id>`` for the frame it belongs to, so that a profiler that
reads NVTX (nsys) lays the spans and frames over the kernels' timeline;
without CUDA nothing touches ``torch.cuda.nvtx``. The registry keeps the
bare stage names: ``stats`` has one row per stage. ``enable(False)`` turns
spans, frames and their ranges off.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

_STAGES = defaultdict(list)
_ENABLED = True
# torch.cuda.nvtx where the process has CUDA, False without: looked up on
# the first span or frame
_NVTX = None


class _Thread(threading.local):
    def __init__(self):
        self.frame = None         # the thread's current frame id
        self.ranged = None        # the id of its open NVTX range "frame <id>"
        self.depth = 0            # spans open on the thread


_THREAD = _Thread()


def _nvtx():
    global _NVTX
    if _NVTX is None:
        import torch
        _NVTX = torch.cuda.nvtx if torch.cuda.is_available() else False
    return _NVTX


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    _STAGES.clear()


def frame(fid) -> None:
    """Make fid the calling thread's current frame (None: no frame). The
    NVTX range of the last frame closes and one named ``frame <fid>``
    opens; called inside an open span, the ranges change at the next call
    made outside every span."""
    if not _ENABLED:
        return
    th = _THREAD
    th.frame = fid
    nvtx = _nvtx()
    if not nvtx or th.depth or fid == th.ranged:
        return
    if th.ranged is not None:
        nvtx.range_pop()
    th.ranged = fid
    if fid is not None:
        nvtx.range_push(f"frame {fid}")


def current_frame():
    """The calling thread's current frame id (None before ``frame``)."""
    return _THREAD.frame


@contextmanager
def span(stage: str):
    """Time a pipeline stage: ``with timing.span("MP culling"): ...``"""
    if not _ENABLED:
        yield
        return
    nvtx = _nvtx()
    th = _THREAD
    if nvtx:
        nvtx.range_push(stage)
    th.depth += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGES[stage].append(time.perf_counter() - t0)
        th.depth -= 1
        if nvtx:
            nvtx.range_pop()


def samples(stage: str) -> list:
    """The seconds recorded for one stage so far, oldest first."""
    return list(_STAGES.get(stage, ()))


def stats() -> dict:
    """{stage: (mean_ms, std_ms, median_ms, n)} like PrintTimeStats."""
    out = {}
    for k, v in _STAGES.items():
        a = np.asarray(v) * 1e3
        out[k] = (float(a.mean()), float(a.std()), float(np.median(a)), len(a))
    return out


def print_time_stats(file=None):
    """(reference: Tracking::PrintTimeStats, Tracking.cc:288)"""
    rows = stats()
    lines = ["%-28s %8s %8s %8s %6s" % ("stage", "mean ms", "std", "median",
                                        "n")]
    for k in sorted(rows):
        m, s, med, n = rows[k]
        lines.append("%-28s %8.2f %8.2f %8.2f %6d" % (k, m, s, med, n))
    text = "\n".join(lines)
    print(text, file=file)
    return text
