"""Leveled logger (ORB-SLAM3's `Verbose::PrintMess`); the port's own copy
of `orbslam3_tpu/utils/verbose.py`.

Five levels QUIET..DEBUG with a process-global threshold, same semantics as
the reference's static gate (messages print when their level <= threshold).
"""

from __future__ import annotations

import sys

VERBOSITY_QUIET = 0
VERBOSITY_NORMAL = 1
VERBOSITY_VERBOSE = 2
VERBOSITY_VERY_VERBOSE = 3
VERBOSITY_DEBUG = 4

_th = VERBOSITY_NORMAL


def set_verbosity(level: int):
    global _th
    _th = int(level)


def get_verbosity() -> int:
    return _th


def print_mess(msg: str, level: int = VERBOSITY_NORMAL, file=None):
    if level <= _th:
        print(msg, file=file or sys.stdout)


def debug(msg: str):
    print_mess(msg, VERBOSITY_DEBUG)


def verbose(msg: str):
    print_mess(msg, VERBOSITY_VERBOSE)


def normal(msg: str):
    print_mess(msg, VERBOSITY_NORMAL)
