"""The plain references on tiny inputs: equal to the port's plain versions
they were copied from (the CPU path of each kernel), and their bfloat16
controls not."""
import numpy as np
import pytest
import torch

from slam_bench.gen import room as G
from slam_bench.reference import features as RF
from slam_bench.reference import klt as RK
from slam_bench.reference import search as RS
from slam_bench.reference import trajectory as RT

ORB = dict(n_features=200, scale_factor=1.2, n_levels=4, ini_th_fast=20.0,
           min_th_fast=7.0, height=96, width=128)


def _image(seed=3):
    cam = dict(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)
    room = G.Room(cam, 7, "cpu")
    traj = G.Trajectory({"position": {"amp": [0.3, 0.1, 0.2],
                                      "freq": [0.5, 0.7, 0.4],
                                      "phase": [0.0, 1.0, 0.0]},
                         "rotation": {"amp": [0.1, 0.1, 0.05],
                                      "freq": [0.3, 0.2, 0.1],
                                      "phase": [0.0, 0.5, 0.0]}}, seed)
    rot, t = traj.pose_cw(torch.tensor([0.0, 0.1]))
    return [room.render(rot[i], t[i]) for i in range(2)]


@pytest.mark.parametrize("clahe", [True, False])
def test_features_equal_the_port(clahe):
    from geoflowslam_tpu_torch.config import OrbConfig
    from geoflowslam_tpu_torch.ops import pyramid
    from geoflowslam_tpu_torch.ops.extractor import extract
    gray = torch.round(_image()[0][0]).clamp(0, 255)
    img = pyramid.clahe(gray) if clahe else gray
    want = extract(img, OrbConfig(**ORB))
    uv, lvl, desc, valid = RF.extract(gray, ORB, clahe)
    assert int(valid.sum()) > 50
    assert torch.equal(uv, want.uv) and torch.equal(valid, want.valid)
    assert torch.equal(lvl, want.level) and torch.equal(desc, want.desc)
    low = RF.extract(gray, ORB, clahe, lowp=True)
    assert not (torch.equal(low[0], uv) and torch.equal(low[2], desc))


def test_gated_search_equals_the_port():
    from geoflowslam_tpu_torch.ops.matching import gated_hamming_plain
    g = torch.Generator().manual_seed(0)
    n, m = 150, 90
    uv_q = torch.rand(n, 2, generator=g) * 100
    uv_t = torch.rand(m, 2, generator=g) * 100
    args = (uv_q, torch.randint(0, 4, (n,), generator=g, dtype=torch.int32),
            torch.rand(n, generator=g) > 0.1,
            torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g,
                          dtype=torch.int32),
            torch.full((n,), 12.0), uv_t,
            torch.randint(0, 4, (m,), generator=g, dtype=torch.int32),
            torch.rand(m, generator=g) > 0.1,
            torch.randint(-2 ** 31, 2 ** 31 - 1, (m, 8), generator=g,
                          dtype=torch.int32), -1, 1)
    want = gated_hamming_plain(*args)
    got = RS.gated_search(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int((got[2] >= 0).sum()) > 20
    low = RS.gated_search(*args, lowp=True)
    assert not all(torch.equal(a, b) for a, b in zip(low, want))


def test_flow_equals_the_port():
    from geoflowslam_tpu_torch.ops.klt import build_lk_pyramid, fb_klt_track
    (g0, _), (g1, _) = _image()
    p0, p1 = build_lk_pyramid(g0, 3), build_lk_pyramid(g1, 3)
    g = torch.Generator().manual_seed(2)
    pts = torch.rand(60, 2, generator=g) * torch.tensor([100.0, 70.0]) + 10
    guess = pts + torch.randn(60, 2, generator=g)
    want = fb_klt_track(p0, p1, pts, guess, fb_thresh=0.5, fb_levels=1,
                        win=11, iters=10, min_eig=1e-4, max_levels=3)
    kw = dict(n_levels=3, fb_levels=1, scale_factor=2.0, fb_thresh=0.5,
              win=11, iters=10, min_eig=1e-4)
    pts_r, st_r, err_r = RK.fb_track(p0, p1, pts, guess, **kw)
    assert torch.equal(pts_r, want.pts) and torch.equal(st_r, want.status)
    assert int(st_r.sum()) > 10
    low = RK.fb_track(p0, p1, pts, guess, lowp=True, **kw)
    assert float((low[0] - pts_r).abs()[low[1] & st_r].max()) > 1e-4


def _poses(n, seed):
    traj = G.Trajectory({"position": {"amp": [0.8, 0.3, 0.6],
                                      "freq": [0.5, 0.7, 0.4],
                                      "phase": [0.0, 1.0, 0.0]},
                         "rotation": {"amp": [0.1, 0.15, 0.05],
                                      "freq": [0.3, 0.23, 0.17],
                                      "phase": [0.0, 0.5, 0.0]}}, seed)
    return traj, traj.twc_np(np.arange(n) / 30.0)


def test_pose_errors():
    traj, gt = _poses(40, 40.0)
    # the same path in another world frame: nothing left after alignment
    a = np.eye(4)
    a[:3, :3] = G.so3_exp(torch.tensor([0.3, -0.2, 1.0],
                                       dtype=torch.float64)).numpy()
    a[:3, 3] = [1.0, 2.0, -0.5]
    pos, rot = RT.pose_errors(a @ gt, gt)
    assert pos.max() < 1e-9 and rot.max() < 1e-5
    step_t, step_r = RT.step_errors(a @ gt, gt)
    assert step_t.max() < 1e-9 and step_r.max() < 1e-5
    # one frame 5 cm off: seen absolute and frame to frame
    est = gt.copy()
    est[20, 0, 3] += 0.05
    assert RT.pose_errors(est, gt)[0].max() > 0.04
    assert RT.step_errors(est, gt)[0].max() > 0.04
    assert RT.ate_rmse_m(gt, gt) < 1e-9


def test_umeyama_equals_the_port():
    from geoflowslam_tpu_torch.eval.ate import umeyama_align
    rs = np.random.RandomState(0)
    src, dst = rs.rand(30, 3), rs.rand(30, 3)
    for with_scale in (False, True):
        for a, b in zip(RT.umeyama_align(src, dst, with_scale),
                        umeyama_align(src, dst, with_scale)):
            np.testing.assert_array_equal(a, b)


def test_room_equals_the_port():
    from geoflowslam_tpu_torch.io import synthetic as S
    cam = S.Camera(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128, height=96)
    world = S.SyntheticWorld(cam, device="cpu")
    room = G.Room(dict(fx=100.0, fy=100.0, cx=64.0, cy=48.0, width=128,
                       height=96), 7, "cpu")
    traj, _ = _poses(1, 0.0)
    t = torch.tensor([0.0, 0.7, 1.3])
    rot_wc, p, v, a, w = S.smooth_trajectory(t)
    r2, p2, v2, a2, w2 = traj(t)
    for x, y in ((rot_wc, r2), (p, p2), (v, v2), (a, a2), (w, w2)):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    rot_cw, t_cw = traj.pose_cw(t)
    for i in range(3):
        g0, d0 = world.render(rot_cw[i], t_cw[i])
        g1, d1 = room.render(rot_cw[i], t_cw[i])
        assert torch.equal(g0, g1) and torch.equal(d0, d1)
    acc, gyro, dts = traj.imu(np.array([0.0, 1 / 30, 2 / 30]), 200.0, 32,
                              "cpu")
    seq = S.SyntheticSequence(world)
    a0, w0, dt0 = seq.imu_between(1 / 30, 2 / 30, 32)
    torch.testing.assert_close(torch.from_numpy(acc[1]), a0, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(torch.from_numpy(gyro[1]), w0, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(torch.from_numpy(dts[1]), dt0)
