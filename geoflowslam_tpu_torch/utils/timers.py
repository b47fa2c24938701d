"""Per-stage wall-time statistics (port of geoflowslam_tpu/utils/timers.py).

The façade fills `Track_total` around each frame, `New_KF` around a
keyframe's mapping step and `LBA` around the staged KF step's local BA or
VI-BA. Each sample is host wall time in milliseconds; a stage that ends in
a read from the device (the mapping step does) includes the device work
queued before that read. `write_all` writes the reference's REGISTER_TIMES
files (ExecTimeMean.txt, LocalMapTimeStats.txt, LBA_Stats.txt,
TrackTimeCost.txt, SessionInfo.txt) in the JAX package's layout.
"""
from __future__ import annotations

import os
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

    # -- reference-format outputs ------------------------------------------

    TRACK_STAGES = ["ORB_extract", "IMU_integration", "Pose_pred",
                    "LM_track", "New_KF", "Track_total"]
    MAP_STAGES = ["KF_insert", "MP_culling", "MP_creation", "LBA",
                  "KF_culling", "LM_total"]

    def write_exec_time_mean(self, out_dir: str):
        """ExecTimeMean.txt: `stage mean_ms` lines (PrintTimeStats layout)."""
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "ExecTimeMean.txt"), "w") as f:
            f.write("#stage mean_ms std_ms n\n")
            for k in self.TRACK_STAGES + self.MAP_STAGES:
                if k in self.samples:
                    a = np.asarray(self.samples[k])
                    f.write(f"{k} {a.mean():.4f} {a.std():.4f} {len(a)}\n")
            for k in sorted(self.samples):
                if k not in self.TRACK_STAGES + self.MAP_STAGES:
                    a = np.asarray(self.samples[k])
                    f.write(f"{k} {a.mean():.4f} {a.std():.4f} {len(a)}\n")

    def write_local_map_stats(self, out_dir: str):
        with open(os.path.join(out_dir, "LocalMapTimeStats.txt"), "w") as f:
            f.write("#KF_insert MP_culling MP_creation LBA KF_culling total\n")
            n = max((len(self.samples.get(k, [])) for k in self.MAP_STAGES),
                    default=0)
            for i in range(n):
                row = [self.samples.get(k, [])[i]
                       if i < len(self.samples.get(k, [])) else 0.0
                       for k in self.MAP_STAGES]
                f.write(" ".join(f"{v:.4f}" for v in row) + "\n")

    def write_lba_stats(self, out_dir: str, edges=None, kfs=None, mps=None):
        with open(os.path.join(out_dir, "LBA_Stats.txt"), "w") as f:
            f.write("#LBA_ms n_edges n_KFs n_MPs\n")
            lba = self.samples.get("LBA", [])
            for i, ms in enumerate(lba):
                e = edges[i] if edges and i < len(edges) else 0
                k = kfs[i] if kfs and i < len(kfs) else 0
                m = mps[i] if mps and i < len(mps) else 0
                f.write(f"{ms:.4f} {e} {k} {m}\n")

    def write_session_info(self, out_dir: str, info: dict):
        with open(os.path.join(out_dir, "SessionInfo.txt"), "w") as f:
            for k, v in info.items():
                f.write(f"{k}: {v}\n")

    def write_track_time_cost(self, out_dir: str):
        """SaveTrackTimeCost analogue: per-frame total tracking wall time."""
        with open(os.path.join(out_dir, "TrackTimeCost.txt"), "w") as f:
            for v in self.samples.get("Track_total", []):
                f.write(f"{v:.4f}\n")

    def write_all(self, out_dir: str, session_info: dict | None = None):
        self.write_exec_time_mean(out_dir)
        self.write_local_map_stats(out_dir)
        self.write_lba_stats(out_dir)
        self.write_track_time_cost(out_dir)
        self.write_session_info(out_dir, session_info or {})
