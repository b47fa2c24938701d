"""The time guard of the visual fused path against the JAX SlamSystem: an
RGB-D frame whose timestamp is older than the previous one, arriving while
the reference would run its fused frame step (tracking OK, no IMU, no
record_reproj_err), resets the active map and is dropped: it is not
tracked, not counted, records no pose and leaves last_time, so that the
next frame starts the new map. Both systems run tests/test_torch_slice.py's
scenario (320x240, 400 features, 10 fps; the reference with
pkt_max_pending=0) over six frames, then an older stamp, then four frames:
the same stamps in `trajectory`, the same n_frames, the same frame
initializing the new map, one more map, and the warning. A staged frame
(track_stereo) keeps resetting and starting the new map on itself, as the
reference's staged step does."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.pipeline.system import SlamSystem as JSlam

from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from tests.test_torch_slice import FPS, FX, H, W, _configs

torch.set_num_threads(2)

STAMPS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.25, 0.6, 0.7, 0.8, 0.9]


@pytest.fixture(scope="module")
def seq():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    return SyntheticSequence(SyntheticWorld(cam), fps=FPS)


@pytest.fixture(scope="module")
def frames(seq):
    return [(t, *(np.array(x) for x in seq.frame(t)[:2])) for t in STAMPS]


def _drive(slam, frames):
    """Track every frame; returns (states after each frame, the map count
    after each frame)."""
    states, maps = [], []
    for t, g, d in frames:
        slam.track_rgbd(g, d, t)
        states.append(slam.state.name)
        maps.append(int(slam.map_stats()["n_maps"]))
    return states, maps


def test_older_stamp_on_the_fused_path_is_dropped(frames):
    jcfg, tcfg = _configs()
    ref = JSlam(jcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_states, ref_maps = _drive(ref, frames)
    port = SlamSystem(tcfg, device="cpu")
    older = STAMPS.index(0.25)
    with pytest.warns(UserWarning, match="older than the previous frame"):
        states, maps = _drive(port, frames)
    # the older frame resets (one more map, NOT_INITIALIZED) and the next
    # frame initializes the new map, in both packages
    assert states == ref_states
    assert maps == ref_maps
    assert states[older] == "NOT_INITIALIZED"
    assert states[older + 1] == "OK"
    assert maps[older] == maps[older - 1] + 1
    assert port.n_frames == ref.n_frames == len(STAMPS) - 1
    assert port.last_time == ref.last_time == STAMPS[-1]
    stamps = [t for t, _ in port.trajectory]
    assert stamps == [t for t, _ in ref.trajectory]
    assert 0.25 not in stamps and 0.6 in stamps


def test_older_stamp_on_a_staged_frame_starts_the_new_map(seq):
    """track_stereo runs staged: the reset, then the frame initializes the
    new map on itself, counted, its pose recorded (a rectified pair with
    the right camera bf / fx = 0.1 m to the right)."""
    _, tcfg = _configs()
    port = SlamSystem(tcfg, device="cpu")
    base = jnp.array([-tcfg.bf / tcfg.fx, 0.0, 0.0])

    def pair(t):
        rot_cw, t_cw = seq.pose_cw(t)
        return (np.array(seq._render(rot_cw, t_cw)[0]),
                np.array(seq._render(rot_cw, t_cw + base)[0]))
    for t in STAMPS[:6]:
        port.track_stereo(*pair(t), t)
    assert port.state.name == "OK"
    n, n_maps = port.n_frames, port.map_stats()["n_maps"]
    with pytest.warns(UserWarning, match="older than the previous frame"):
        port.track_stereo(*pair(0.25), 0.25)
    assert port.state.name == "OK"
    assert port.map_stats()["n_maps"] == n_maps + 1
    assert port.n_frames == n + 1 and port.last_time == 0.25
    assert port.trajectory[-1][0] == 0.25
