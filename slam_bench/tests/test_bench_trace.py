"""A traced run (--trace 1) on the CPU at the small size: its window runs
the clean frames first, whose latencies the latency readers read, then the
profiled frames, then the sync stretch (no CUDA here, so no sync count),
and its line carries the traced fields and every latency reader's number."""
from slam_bench import cell as C
from slam_bench.tests.small import small_run


def test_traced_window_stretches_and_line():
    out = small_run("tum1_rgbd.handheld", trace=True, seconds=24.0)
    info, line = out["info"], out["line"]
    assert line["correct"] is True
    clean = info["frame_ms_samples"]
    assert clean >= 1
    assert info["profiled_frames"] == C.PROFILED_FRAMES
    assert info["sync_frames"] >= 1, info
    assert clean + C.PROFILED_FRAMES + info["sync_frames"] <= info["frames"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name in ("frame_ms_p50", "frames_per_s.host", "kf_frame_ms"):
        assert line["metrics"][name]["value"] > 0, name
    assert list(line)[-1] == "checks"
