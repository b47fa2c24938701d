"""device_launches_per_frame: CUDA kernel launches in the profiled window
(the profiler's kernel events) over the frames it holds: the host's launch
cost that sets the pace."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    n = sum(1 for op in run.trace.ops if op[3] == "kernel")
    return n / run.trace.frames
