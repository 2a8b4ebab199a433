"""Per-stage pipeline timing (the reference's REGISTER_TIMES subsystem).

Counterpart of ``utils/timing.py`` of the JAX package: the std::chrono
spans around each pipeline stage (reference: Tracking.cc:2059-2068,
LocalMapping.cc:111-158, dumped by Tracking::PrintTimeStats,
Tracking.cc:288) as a host-side registry with the same stage names. A span
measures host time: device work it queues but does not wait for falls
outside it.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np

_STAGES = defaultdict(list)
_ENABLED = True


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def reset():
    _STAGES.clear()


@contextmanager
def span(stage: str):
    """Time a pipeline stage: ``with timing.span("MP culling"): ...``"""
    if not _ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _STAGES[stage].append(time.perf_counter() - t0)


def record(stage: str, seconds: float):
    if _ENABLED:
        _STAGES[stage].append(seconds)


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
