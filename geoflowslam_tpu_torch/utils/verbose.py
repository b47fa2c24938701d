"""Verbosity-levelled logging (port of geoflowslam_tpu/utils/verbose.py: the
reference's Verbose, include/System.h:49-67)."""
from __future__ import annotations

import sys


class Verbose:
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4

    level = QUIET

    @classmethod
    def set_level(cls, level: int):
        cls.level = level

    @classmethod
    def print(cls, msg: str, level: int = 1):
        if level <= cls.level:
            print(msg, file=sys.stderr, flush=True)


def warn(msg: str):
    """Always-visible runtime warning (the reference's cerr guards)."""
    print(f"[geoflowslam-tpu] WARNING: {msg}", file=sys.stderr, flush=True)
