"""The generator and the harness's data-driven parts on tiny inputs: the
traffic's gaps, the images each entry point takes, the entry dispatch and
the warm-up rule."""
import types

import numpy as np
import pytest

from slam_bench import cell as C
from slam_bench.gen import traffic as TR

TRAFFIC = {
    "room_half_extent_m": [2.0, 1.5, 2.0], "texture_seed": 7,
    "texture_scale_m": 0.35, "fps": 10.0,
    "trajectory": {"position": {"amp": [0.3, 0.1, 0.2],
                                "freq": [0.5, 0.5, 0.5],
                                "phase": [0.0, 1.0, 0.0]},
                   "rotation": {"amp": [0.1, 0.1, 0.05],
                                "freq": [0.5, 0.5, 0.5],
                                "phase": [0.0, 0.5, 0.0]},
                   "t0_range": [3.0, 4.0]},
    "gaps": {"first_s": 0.5, "every_s": 1.0, "frames": [1, 3],
             "image": "flat", "settle_frames": 2},
    "warmup": {"attr": "_gen_counter", "at_least": 2, "min_frames": 2,
               "max_frames": 4},
    "max_window_fps": 5.0,
}


def _config(entry, imu=False):
    return {"entry": entry,
            "system": {"fx": 40.0, "fy": 40.0, "cx": 16.0, "cy": 12.0,
                       "bf": 4.0, "frame": {"orb": {"width": 32,
                                                    "height": 24}},
                       "imu": {"max_samples_per_frame": 8} if imu else None},
            "sensor": {"depth_unit_m": 0.001, "imu_rate": 200.0,
                       "odometry": imu}}


def test_gaps_are_seeded_and_not_judged():
    gap, judged = TR.gap_frames(TRAFFIC, 11, 40)
    again, _ = TR.gap_frames(TRAFFIC, 11, 40)
    assert (gap == again).all()
    starts = np.flatnonzero(np.diff(np.r_[0, gap.astype(int)]) == 1)
    assert starts.tolist() == [5, 15, 25, 35]
    for s in starts:
        n = int(np.argmin(gap[s:])) if not gap[s:].all() else len(gap) - s
        assert 1 <= n <= 3
        assert not judged[s:s + n + 2].any()
    assert judged[~gap].sum() == judged.sum()
    others = {tuple(TR.gap_frames(TRAFFIC, s, 40)[0]) for s in range(20)}
    assert len(others) > 1


@pytest.mark.parametrize("entry", ["track_rgbd", "track_stereo",
                                   "track_monocular"])
def test_stream_images_by_entry(entry):
    s = TR.make_stream(TRAFFIC, _config(entry), 5, 12, "cpu")
    kind = TR.images_of(entry)
    assert s.gray.shape == (12, 24, 32) and s.gray.dtype == np.uint8
    assert (s.depth is not None) == (kind == "rgbd")
    assert (s.gray_r is not None) == (kind == "stereo")
    gap, judged = TR.gap_frames(TRAFFIC, 5, 12)
    assert (s.judged == judged).all()
    assert (s.gray[gap] == TR.GAP_GRAY).all()
    assert s.gray[~gap].std() > 5
    if kind == "rgbd":
        assert (s.depth[gap] == 0).all() and (s.depth[~gap] > 0).all()
    if kind == "stereo":
        assert (s.gray_r[~gap] != s.gray[~gap]).any()


def test_fisheye_is_refused():
    with pytest.raises(ValueError):
        TR.images_of("track_stereo_fisheye")


class _Fake:
    """Records the entry points called and the odometry queued."""

    def __init__(self):
        self.calls, self._gen_counter = [], 0
        self.imu = types.SimpleNamespace(initialized=False)

    def set_odom(self, v, odom_frame):
        self.calls.append(("odom", odom_frame))

    def map_stats(self):
        self.calls.append(("map_stats",))

    def __getattr__(self, name):
        if not name.startswith("track_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, len(args)))
            self._gen_counter += 1
            return np.eye(4)
        return call


def test_entry_dispatch_inertial():
    s = TR.make_stream(TRAFFIC, _config("track_rgbd_inertial", imu=True),
                       5, 3, "cpu")
    slam = _Fake()
    track = C.tracker(slam, {"entry": "track_rgbd_inertial"}, s)
    track(0)
    track(1)
    assert slam.calls == [("odom", False), ("track_rgbd", 3),
                          ("odom", False), ("track_rgbd_inertial", 6)]


def test_warm_up_rule_from_data():
    slam = _Fake()
    calls = []
    first = C.warm_up(slam, lambda i: (calls.append(i),
                                       slam.__getattr__("track_x")()),
                      {"attr": "_gen_counter", "at_least": 3,
                       "min_frames": 1, "max_frames": 5})
    assert first == 3 and calls == [0, 1, 2]
    with pytest.raises(RuntimeError):
        C.warm_up(_Fake(), lambda i: None,
                  {"attr": "imu.initialized", "at_least": 1,
                   "min_frames": 1, "max_frames": 2})
