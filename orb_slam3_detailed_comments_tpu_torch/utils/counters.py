"""Counts that several threads add to.

The tracker, the mapping worker and the global-BA thread all launch
kernels and issue searches; a plain ``d[name] += 1`` from two Python
threads is a read, an add and a write, and one of two racing updates can
be lost. ``Counts.bump`` makes the three one step under a lock.
"""
from __future__ import annotations

import threading


class Counts(dict):
    """A dict of integer counts, one per name, read like any dict."""

    def __init__(self, *names: str):
        super().__init__((name, 0) for name in names)
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self[name] += n

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0
