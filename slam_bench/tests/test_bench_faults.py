"""A run with the timed path broken underneath reads `correct` false, once
for each fault a cell can have (the look for a card skipped: the run is on
the CPU at a small size, tests/small.py): the system's step returning its
state unchanged; half of the frame build's keypoints left out; an answer
altered where it is produced (a K2 result, a returned pose); and, where
the flow runs, its pyramid made wrong. A cell runs on one card, so there
is no exchange between chips to leave out."""
import numpy as np
import pytest

from slam_bench.tests.small import CELLS, small_run


def state_unchanged(stage, slam):
    """From the window on, every frame returns the last pose and tracks
    nothing."""
    if stage == "window":
        pose = slam.current_pose_wc()
        slam.track_rgbd = lambda *a, **k: pose
        slam.track_rgbd_inertial = lambda *a, **k: pose


def half_the_keypoints(monkeypatch):
    import geoflowslam_tpu_torch.state.frame as FR
    extract = FR.extract

    def half(*a, **k):
        out = extract(*a, **k)
        n = out.valid.shape[0] // 2
        return out._replace(valid=out.valid.clone().index_fill_(
            0, __import__("torch").arange(n, out.valid.shape[0]), False))
    monkeypatch.setattr(FR, "extract", half)


def k2_answer_altered(monkeypatch):
    import geoflowslam_tpu_torch.ops.matching as MA
    gated = MA.gated_hamming

    def altered(*a, **k):
        best, second, idx = gated(*a, **k)
        idx = idx.clone()
        idx[0] = idx[0] + 1
        return best, second, idx
    monkeypatch.setattr(MA, "gated_hamming", altered)


def pose_altered(stage, slam):
    """The window's second frame returns its pose 20 cm off."""
    if stage == "window":
        count = [0]
        for name in ("track_rgbd", "track_rgbd_inertial"):
            entry = getattr(slam, name)

            def moved(*a, _entry=entry, **k):
                pose = _entry(*a, **k).copy()
                count[0] += 1
                if count[0] == 2:
                    pose[0, 3] += 0.2
                return pose
            setattr(slam, name, moved)


def lk_pyramid_altered(monkeypatch):
    import geoflowslam_tpu_torch.ops.klt as KL
    build = KL.build_lk_pyramid

    def altered(img, n_levels):
        levels = build(img, n_levels)
        return [levels[0]] + [lv * 1.01 for lv in levels[1:]]
    monkeypatch.setattr(KL, "build_lk_pyramid", altered)


def _failed(out, names):
    rows = {n: (v, lim) for n, v, lim in out["rows"]}
    assert out["line"]["correct"] is False
    assert any(rows[n][0] is None or rows[n][0] > rows[n][1]
               for n in names if n in rows), rows


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged(cell):
    out = small_run(cell, faults=[state_unchanged])
    _failed(out, ["features", "k2_rows", "step_cm", "pose_cm"])


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_keypoints(cell, monkeypatch):
    half_the_keypoints(monkeypatch)
    out = small_run(cell)
    _failed(out, ["features"])


@pytest.mark.parametrize("cell", CELLS)
def test_k2_answer_altered(cell, monkeypatch):
    k2_answer_altered(monkeypatch)
    out = small_run(cell)
    _failed(out, ["k2_rows"])


@pytest.mark.parametrize("cell", CELLS)
def test_pose_altered(cell):
    out = small_run(cell, faults=[pose_altered])
    _failed(out, ["step_cm", "pose_cm"])


def test_lk_pyramid_altered(monkeypatch):
    """The flow's pyramid is rebuilt from the stream's images, so a wrong
    pyramid fails k3_pyramid even where the track through it is sound."""
    lk_pyramid_altered(monkeypatch)
    out = small_run("g1_vi_geoflow.walk")
    _failed(out, ["k3_pyramid"])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_reads_exact(cell):
    """Without a fault the frame build, the searches and the flow equal the
    references exactly on the CPU (the port's plain versions run there)."""
    out = small_run(cell)
    rows = {n: v for n, v, _ in out["rows"]}
    nums = out["info"]["numbers"]
    assert rows["features"] == 0.0 and rows["k2_rows"] == 0.0
    if "k3_px" in nums:
        assert nums["k3_px"] == 0.0 and nums["k3_status"] == 0.0
        assert nums["k3_pyramid"] == 0.0
    assert nums["pose_cm"] is not None and np.isfinite(nums["pose_cm"])
