"""frames_per_s.host: the traced window's clean frames (no profiler, no
sync debugging, no benchmark span) over the host-clock time their track
calls took. Paced by one host core today, whose speed moved from run to
run on the card's machines by more than an end-to-end bound can hold
(PERF.md §2)."""


def read(run):
    if not run.frame_ms:
        return None
    return 1e3 * len(run.frame_ms) / sum(run.frame_ms)
