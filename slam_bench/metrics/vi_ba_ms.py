"""vi_ba_ms: the mean of the benchmark's synchronised spans around
pipeline/local_mapping.py's vi_ba_step in the traced window's sync
stretch. For an inertial cell (g1_vi_geoflow); no listed cell has one."""
import numpy as np


def read(run):
    ms = run.span_ms.get("vi_ba") if run.span_ms else None
    return float(np.mean(ms)) if ms else None
