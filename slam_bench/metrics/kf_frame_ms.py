"""kf_frame_ms: the mean latency of the traced window's clean frames (as
frame_ms_p50) that added a keyframe (the system's keyframe generation
counter read after each frame)."""
import numpy as np


def read(run):
    if run.kf_added is None:
        return None
    ms = [m for m, kf in zip(run.frame_ms, run.kf_added) if kf]
    return float(np.mean(ms)) if ms else None
