"""host_syncs_per_frame: synchronising calls counted under CUDA sync
debugging over the traced window's sync stretch (at most SYNC_FRAMES frames
after the profiled ones), a frame (the pose's own read included)."""


def read(run):
    if run.syncs is None or not run.sync_frames:
        return None
    return run.syncs / run.sync_frames
