"""Per-stage wall-time statistics (port of geoflowslam_tpu/utils/timers.py
without its file writers).

The façade fills `Track_total` around each frame and `New_KF` around a
keyframe's mapping step. Each sample is host wall time in milliseconds; a
stage that ends in a read from the device (the mapping step does) includes
the device work queued before that read.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List

import numpy as np


class StageTimers:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextmanager
    def time(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[stage].append((time.perf_counter() - t0) * 1000.0)

    def add(self, stage: str, ms: float):
        self.samples[stage].append(ms)

    def mean(self, stage: str) -> float:
        v = self.samples.get(stage, [])
        return float(np.mean(v)) if v else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {"mean": float(a.mean()), "std": float(a.std()),
                      "min": float(a.min()), "max": float(a.max()),
                      "n": len(v)}
        return out
