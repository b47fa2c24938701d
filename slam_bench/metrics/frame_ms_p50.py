"""frame_ms_p50: the median of the frame latencies (host clock around
each track call) of the traced window's clean frames, which run as an
untraced window runs them: no profiler, no sync debugging, no benchmark
span."""
import numpy as np


def read(run):
    if not run.frame_ms:
        return None
    return float(np.median(run.frame_ms))
