"""The port's hard-mode sequence and m12 feed against the JAX package on the
same inputs:

* hard_trajectory's five outputs at 50 times in [0, 80] s, within 1e-5;
  contrast_schedule equal;
* HardSyntheticSequence.frame at 320x240 at t = 0, 10 (the contrast floor,
  0.12) and 13.3, within test_torch_math.py's tolerances for frames (gray
  1e-2 grey levels, depth 1e-4 m, pose 1e-6);
* imu_between within 1e-5 (acc 1e-4 m/s^2);
* pack_m12 and unpack_m12_np bit-equal to the JAX package's numpy branch,
  and a round trip within half a step;
* the device pack bit-equal to the body of the JAX hard-mode script's
  render_packed on the same render;
* build_frame on an m12 buffer against the JAX build_frame on the same
  buffer, to test_torch_frontend.py's keypoint tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import feed_codec as JFC
from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.io import feed_codec as TFC
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.state.frame import build_frame as t_build_frame

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def sequences():
    cam_j = JS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    cam_t = TS.Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    return (JS.HardSyntheticSequence(JS.SyntheticWorld(cam_j)),
            TS.HardSyntheticSequence(TS.SyntheticWorld(cam_t,
                                                       device="cpu")))


@pytest.fixture
def numpy_packer(monkeypatch):
    """The JAX package's pack_m12 on its numpy branch (no native packer)."""
    monkeypatch.setattr(JFC, "_lib", 0)
    return JFC.pack_m12


def test_hard_trajectory_and_contrast():
    ts = np.linspace(0.0, 80.0, 50).astype(np.float32)
    for a, b in zip(JS.hard_trajectory(jnp.asarray(ts)),
                    TS.hard_trajectory(torch.from_numpy(ts))):
        _close(a, b, 1e-5)
    for t in list(ts) + [10.0, 4.0, 16.0, 13.3]:
        assert JS.contrast_schedule(t) == TS.contrast_schedule(t)
    assert TS.contrast_schedule(10.0) == pytest.approx(0.12)


@pytest.mark.parametrize("t", [0.0, 10.0, 13.3])
def test_hard_frame(sequences, t):
    seq_j, seq_t = sequences
    gj, dj, (rj, tj) = seq_j.frame(t)
    gt, dt, (rt, tt) = seq_t.frame(t)
    _close(rj, rt, 1e-6)
    _close(tj, tt, 1e-6)
    _close(gj, gt, 1e-2)
    _close(dj, dt, 1e-4)
    if t == 10.0:   # the contrast floor: grey levels pulled towards 110
        assert float(gt.max() - gt.min()) < 0.13 * 215.0 + 1.0


def test_imu_between(sequences):
    seq_j, seq_t = sequences
    for t0, t1, s in ((1.0, 1.0 + 1 / 30, 16), (12.5, 12.6, 32)):
        aj, wj, dj = seq_j.imu_between(t0, t1, s)
        at, wt, dt = seq_t.imu_between(t0, t1, s)
        _close(aj, at, 1e-4)
        _close(wj, wt, 1e-5)
        np.testing.assert_array_equal(np.asarray(dj), dt.numpy())


def test_pack_and_unpack_m12(numpy_packer):
    rs = np.random.RandomState(3)
    gray = (rs.rand(H, W) * 300 - 20).astype(np.float32)
    depth = (rs.rand(H, W) * 20.0 - 1.0).astype(np.float32)
    depth[:3, :5] = [0.002, 0.006, 0.01, 16.38, np.nan][:5]  # ties, range
    depth[5, :4] = [0.0, -0.5, 16.5, 1e9]
    for unit in (1.0, 0.001, 0.0002):
        d = depth / unit if unit != 1.0 else depth
        want = numpy_packer(gray, np.nan_to_num(d), unit)
        got = TFC.pack_m12(gray, np.nan_to_num(d), unit)
        assert got.dtype == np.uint8
        assert got.shape == (TFC.packed_size(H, W),)
        np.testing.assert_array_equal(got, want)
        for a, b in zip(JFC.unpack_m12_np(want, H, W),
                        TFC.unpack_m12_np(got, H, W)):
            np.testing.assert_array_equal(a, b)
    g_u8 = (rs.rand(H, W) * 255).astype(np.uint8)
    d_m = (rs.rand(H, W) * 15.0).astype(np.float32)
    g2, q = TFC.unpack_m12_np(TFC.pack_m12(g_u8, d_m, 1.0), H, W)
    np.testing.assert_array_equal(g2, g_u8)
    assert np.abs(q * TFC.M12_STEP_M - d_m).max() <= 0.002 + 1e-6


def test_device_pack_matches_render_packed(sequences):
    """pack_m12_torch against the body of the JAX hard-mode script's
    render_packed (examples/run_hardmode.py), contrast blend included, on
    the same render."""
    seq_j, _ = sequences

    @jax.jit
    def packed(g, d, c):
        g = 110.0 + (g - 110.0) * c
        gq = jnp.clip(jnp.round(g), 0, 255).astype(jnp.uint8)
        q = jnp.clip(jnp.round(d / 0.004), 0, 4095).astype(jnp.uint32)
        a, b = q[:, 0::2], q[:, 1::2]
        p = jnp.stack([a & 0xFF, (a >> 8) | ((b & 0xF) << 4), b >> 4],
                      -1).astype(jnp.uint8)
        return jnp.concatenate([gq.reshape(-1), p.reshape(-1)])

    render = jax.jit(seq_j.world.render)
    for t in (0.0, 10.0, 33.3):
        rot, tc = seq_j.pose_cw(t)
        c = np.float32(JS.contrast_schedule(t))
        g, d = render(rot, tc)
        want = np.asarray(packed(g, d, c))
        got = TFC.pack_m12_torch(
            110.0 + (torch.from_numpy(np.array(g)) - 110.0) * float(c),
            torch.from_numpy(np.array(d)))
        np.testing.assert_array_equal(got.numpy(), want)
    # batched: the leading axes carry through
    gd = [torch.stack([torch.from_numpy(np.array(x))] * 2) for x in (g, d)]
    both = TFC.pack_m12_torch(110.0 + (gd[0] - 110.0) * float(c), gd[1])
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())


def test_build_frame_on_m12(sequences, numpy_packer):
    """>= 95% of level-0 keypoints shared, depth per keypoint and cloud
    equal where the keypoints are, LK pyramid within 1e-3 (the tolerances of
    test_torch_frontend.py's test_build_frame)."""
    seq_j, _ = sequences
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              feed_codec="m12")
    jcfg = JFrame(orb=JOrb(**orb), **fc)
    tcfg = C.FrameConfig(orb=C.OrbConfig(**orb), **fc)
    jbf = jax.jit(lambda b: j_build_frame(b, None, jcfg, FX, FX, W / 2,
                                          H / 2))
    for t in (0.0, 13.3):
        g, d, _ = seq_j.frame(t)
        buf = numpy_packer(np.array(g), np.array(d), 1.0)
        fj = jbf(jnp.asarray(buf))
        ft = t_build_frame(torch.from_numpy(buf), None, tcfg, FX, FX, W / 2,
                           H / 2)
        uvj, vj = np.asarray(fj.feat.uv), np.asarray(fj.feat.valid)
        lv0 = np.asarray(fj.feat.level) == 0
        kj = {tuple(p) for p in uvj[lv0 & vj]}
        kt = {tuple(p) for p in ft.feat.uv.numpy()[
            (ft.feat.level.numpy() == 0) & ft.feat.valid.numpy()]}
        assert len(kj) > 50
        assert len(kj & kt) >= 0.95 * len(kj)
        dj = dict(zip(map(tuple, uvj[vj]), np.asarray(fj.depth_kp)[vj]))
        dt = dict(zip(map(tuple, ft.feat.uv.numpy()[ft.feat.valid.numpy()]),
                      ft.depth_kp.numpy()[ft.feat.valid.numpy()]))
        common = set(dj) & set(dt)
        assert all(dj[k] == dt[k] for k in common)
        np.testing.assert_array_equal(np.asarray(fj.cloud_valid),
                                      ft.cloud_valid.numpy())
        np.testing.assert_allclose(np.asarray(fj.cloud), ft.cloud.numpy(),
                                   rtol=1e-6, atol=0)
        for a, b in zip(fj.lk_pyramid, ft.lk_pyramid):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3,
                                       rtol=0)


def test_stage_timers_match_reference():
    """utils/timers.StageTimers: the same samples give the same mean and
    summary as the JAX package's; time() adds one sample a use."""
    from geoflowslam_tpu.utils.timers import StageTimers as JTimers
    from geoflowslam_tpu_torch.utils.timers import StageTimers as TTimers
    j, t = JTimers(), TTimers()
    rs = np.random.RandomState(0)
    for stage in ("Track_total", "New_KF", "Track_total"):
        for ms in rs.rand(5) * 40:
            j.add(stage, float(ms))
            t.add(stage, float(ms))
    assert t.summary() == j.summary()
    assert t.mean("New_KF") == j.mean("New_KF")
    assert t.mean("absent") == j.mean("absent") == 0.0
    with t.time("LBA"):
        pass
    assert len(t.samples["LBA"]) == 1 and t.samples["LBA"][0] >= 0.0
