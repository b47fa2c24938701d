"""Port parity of pipeline/tracking.fused_track_step, the one-call visual hot
path (build_frame + motion model + local map) that bench.py times, on the
map of tests/test_torch_tracking.py's helper (320x240, 400 features, 12
frames of the test_e2e_rgbd scenario; built once per session and shared by
the xdist workers, tests/test_torch_shared.py) and its 13th frame.

Each case feeds the same inputs, raw gray/depth or the m12 buffer of the
same images, with the window's masks given or computed inside (no mp_mask,
the JAX `local_masks=None` branch), to JAX's fused_track_step and to the
port's. Tolerances: obs_mp equal on at least 99% of the keypoints, the pose
within 1e-4 m and 1e-4 rad, n_inliers within 1%. The port's one call equals
its own three calls (build_frame, track_with_motion_model with the last
octaves at 0, track_local_map on the input map) exactly, and, once the
per-device constants exist, makes no host read (utils/sync_audit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.pipeline import tracking as JT

from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.io.feed_codec import pack_m12
from geoflowslam_tpu_torch.pipeline import tracking as TT
from geoflowslam_tpu_torch.state.frame import build_frame
from geoflowslam_tpu_torch.utils.sync_audit import audit
from test_torch_shared import shared_result
from test_torch_tracking import CPU, built  # noqa: F401 (the fixture)

torch.set_num_threads(2)

CASES = [("raw", True), ("raw", False), ("m12", True), ("m12", False)]
IDS = [f"{feed}-{'masks' if m else 'window'}" for feed, m in CASES]


def _images(b, feed):
    if feed == "raw":
        return b["gray"], b["depth"]
    buf = pack_m12(np.asarray(b["gray"]), np.asarray(b["depth"]),
                   b["jcfg"].frame.depth_map_factor)
    return buf, np.zeros((1, 1), np.float32)


def _jax_step(b, feed, with_masks):
    g, d = _images(b, feed)
    _, res, ms2 = JT.fused_track_step(
        jnp.asarray(g), jnp.asarray(d), b["ms"], b["last_obs"], *b["pred"],
        jnp.int32(b["ref"]), b["jcfg"].track_cfg(), b["jcfg"].frame,
        local_masks=b["masks"] if with_masks else None)
    return dict(rot=res.rot, t=res.t, obs=res.obs_mp, n=res.n_inliers,
                visible=ms2.mp_visible)


def _port_inputs(b, feed, with_masks):
    T = lambda a: convert.to_tensor(a, CPU)
    g, d = _images(b, feed)
    masks = None
    if with_masks:
        masks = tuple(T(x) for x in b["masks"])
        masks = (masks[0], masks[1], masks[2].long())
    return (T(g), T(d), convert.map_state(b["ms"], CPU), T(b["last_obs"]),
            T(b["pred"][0]), T(b["pred"][1]), b["ref"],
            b["tcfg"].track_cfg(), b["tcfg"].frame), masks


def _angle(ra, rb):
    """The angle of ra rb^T in radians, from both its cosine and its sine:
    arccos of the trace alone cannot read below ~3e-4 rad on float32
    rotations."""
    m = np.asarray(ra, np.float64) @ np.asarray(rb, np.float64).T
    w = 0.5 * np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0],
                        m[1, 0] - m[0, 1]])
    return float(np.arctan2(np.linalg.norm(w), (np.trace(m) - 1.0) / 2.0))


@pytest.mark.parametrize("feed,with_masks", CASES, ids=IDS)
def test_fused_track_step_matches_jax(built, tmp_path_factory, feed,
                                      with_masks):
    ref = shared_result(tmp_path_factory, f"fused_track_{feed}_{with_masks}",
                        lambda: _jax_step(built, feed, with_masks))
    args, masks = _port_inputs(built, feed, with_masks)
    _, res, ms2 = TT.fused_track_step(*args, local_masks=masks)
    n_ref = int(ref["n"])
    assert n_ref >= 100, n_ref
    assert abs(int(res.n_inliers) - n_ref) <= 0.01 * n_ref, \
        (int(res.n_inliers), n_ref)
    assert np.mean(res.obs_mp.numpy() == np.asarray(ref["obs"])) >= 0.99
    assert np.abs(res.t.numpy() - np.asarray(ref["t"])).max() <= 1e-4
    assert _angle(res.rot.numpy(), ref["rot"]) <= 1e-4
    np.testing.assert_allclose(ms2.mp_visible.numpy(),
                               np.asarray(ref["visible"]), atol=2.0)


@pytest.mark.parametrize("feed,with_masks", CASES, ids=IDS)
def test_fused_track_step_equals_its_three_calls(built, feed, with_masks):
    args, masks = _port_inputs(built, feed, with_masks)
    gray, depth, ms, last_obs, pr, pt, ref_kf, tcfg, fcfg = args
    TT.fused_track_step(*args, local_masks=masks)   # fills the per-device
    with audit(sites=True) as hits:                 # constant caches
        frame1, res1, ms1 = TT.fused_track_step(*args, local_masks=masks)
    assert hits == [], hits

    frame = build_frame(gray, depth, fcfg, tcfg.fx, tcfg.fy, tcfg.cx,
                        tcfg.cy)
    zeros = torch.zeros((frame.feat.capacity,), dtype=torch.int32)
    r = TT.track_with_motion_model(ms, frame, last_obs, pr, pt, tcfg, zeros)
    ms2, res2 = TT.track_local_map(ms, frame, r.obs_mp, r.rot, r.t, tcfg,
                                   masks, ref_kf=ref_kf)
    assert torch.equal(frame1.feat.uv, frame.feat.uv)
    assert torch.equal(res1.obs_mp, res2.obs_mp)
    assert torch.equal(res1.rot, res2.rot) and torch.equal(res1.t, res2.t)
    assert int(res1.n_inliers) == int(res2.n_inliers) > 100
    assert torch.equal(ms1.mp_visible, ms2.mp_visible)
    assert torch.equal(ms1.mp_found, ms2.mp_found)


def test_track_local_map_without_masks_needs_a_reference(built):
    args, _ = _port_inputs(built, "raw", False)
    gray, depth, ms, last_obs, pr, pt, _, tcfg, fcfg = args
    frame = build_frame(gray, depth, fcfg, tcfg.fx, tcfg.fy, tcfg.cx,
                        tcfg.cy)
    with pytest.raises(ValueError):
        TT.track_local_map(ms, frame, last_obs, pr, pt, tcfg)
