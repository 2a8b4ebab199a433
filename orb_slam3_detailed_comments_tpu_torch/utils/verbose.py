"""Leveled logging (reference: the Verbose class, include/System.h:47-72).

Counterpart of ``utils/verbose.py`` of the JAX package.
"""
from __future__ import annotations

VERBOSITY_QUIET = 0
VERBOSITY_NORMAL = 1
VERBOSITY_VERBOSE = 2
VERBOSITY_VERY_VERBOSE = 3
VERBOSITY_DEBUG = 4

_level = VERBOSITY_NORMAL


def set_verbosity(level: int):
    """(reference: Verbose::SetTh)"""
    global _level
    _level = level


def print_mess(msg: str, level: int = VERBOSITY_NORMAL):
    """(reference: Verbose::PrintMess)"""
    if level <= _level:
        print(msg, flush=True)
