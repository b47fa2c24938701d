"""The port's lidar stage against the JAX package, on the synthetic room at
320x240 (the scenario of tests/test_e2e_variants.py):

* ops/pointcloud.lidar_feature_cloud on a depth image of the room (stride
  3, the reference's default): identical valid and edge masks, points
  within 1e-6 m;
* pipeline/lidar_mapping.insert_kf_cloud over three KF clouds (stride 8,
  5 cm voxels) into a 2048-point map with a 1-KF window, so that the third
  insert evicts the first KF. Given the same world points (the reference's
  transform of each cloud, inserted at the identity pose) the maps are
  identical: `pts`, `valid` and `kf_id`. At the true poses the two
  transforms agree within 1e-6 m but round differently in the last bit (a
  3-term product summed in another order), which moves a point on a voxel
  face (the room's walls lie on them) into the next voxel. Such a point
  changes at most two voxels, and in each the (voxel, KF) pair of the
  point that represents it, so the sets of occupied (voxel, KF) pairs
  differ by at most four per point that the two transforms put in
  different voxels (both counted and printed);
* make_plane_obs of a fourth cloud against the reference's map, handed
  to both, at a pose 1 cm and 0.3 deg off the truth: identical `valid`,
  except at points whose planarity or distance gate lies within 1e-5 of
  its threshold, or whose five nearest neighbours differ (a distance
  matrix summed in another order can swap near-equidistant targets; at
  most 0.5% of the queries); both are counted and printed. On the points
  both call valid, the residual |n . p + d| of the query point within
  1e-5 m and the normals equal up to sign within 1e-4;
* solvers/pose_opt.pose_optimization with those plane factors (the JAX
  ones, handed to both) and 200 reprojection observations, 2 rounds x 5
  iterations as the lidar stage runs it: rotation within 1e-4 rad and
  translation within 1e-4 m;
* GlobalMap.points after `add` of two clouds and `add_lazy` of a third:
  the same set of points; save_pcd writes them all;
* state/frame.build_frame with FrameConfig(lidar_features=True) at 320x240
  (stride 8, 1024 cloud points): the frame's cloud equal to the JAX
  build_frame's (mask identical, points within 1e-6 m);
* check_config accepts use_lidar, use_odom, the IMU with use_icp,
  use_of or both, use_lidar with local_ba_every_kf=False, and the
  monocular sensor with use_of, use_lidar or use_odom (SlamSystem builds
  those on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import (Camera, SyntheticSequence,
                                          SyntheticWorld)
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.ops import pointcloud as JP
from geoflowslam_tpu.pipeline import lidar_mapping as JLD
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.solvers import pose_opt as JPO
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.ops import pointcloud as TP
from geoflowslam_tpu_torch.pipeline import lidar_mapping as TLD
from geoflowslam_tpu_torch.pipeline.system import SlamSystem, check_config
from geoflowslam_tpu_torch.solvers import pose_opt as TPO
from geoflowslam_tpu_torch.state.frame import build_frame

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0
CFG = dict(local_capacity=2048, window_kfs=1)
CFG_VOXEL = C.LidarConfig().local_voxel
TIMES = (0.0, 0.4, 0.8, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def room():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=10.0)
    out = []
    for t in TIMES:
        _, depth, (rot, tr) = seq.frame(t)
        pts, mask = JP.depth_to_cloud(depth, FX, FX, W / 2, H / 2, stride=8)
        c, v = JP.voxel_downsample(pts, mask, 0.05, 1024)
        out.append(dict(depth=np.array(depth), cloud=np.asarray(c),
                        valid=np.asarray(v), rot=np.asarray(rot, np.float32),
                        t=np.asarray(tr, np.float32)))
    return out


def test_lidar_feature_cloud(room):
    depth = room[1]["depth"]
    pj, vj, ej = (np.asarray(x) for x in JP.lidar_feature_cloud(
        jnp.asarray(depth), FX, FX, W / 2, H / 2))
    pt, vt, et = (x.numpy() for x in TP.lidar_feature_cloud(
        _t(depth), FX, FX, W / 2, H / 2))
    assert vj.sum() > 1000 and 0 < ej.sum() < vj.sum()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(et, ej)
    np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0)


def _maps(room, world_in=False):
    """The JAX and port local maps after three inserts (slots 0, 1, 2); with
    `world_in` both get the reference's world points at the identity
    pose."""
    cfg_j, cfg_t = JLD.LidarConfig(**CFG), C.LidarConfig(**CFG)
    lm_j = JLD.create_local_map(cfg_j)
    lm_t = TLD.create_local_map(cfg_t, "cpu")
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for slot, f in enumerate(room[:3]):
        oldest = max(slot - cfg_j.window_kfs, 0)
        cloud, rot, tr = f["cloud"], f["rot"], f["t"]
        if world_in:
            cloud = np.asarray(jnp.asarray(cloud) @ jnp.asarray(rot)
                               + (-jnp.asarray(rot).T @ jnp.asarray(tr)))
            rot, tr = eye, zero
        lm_j = JLD.insert_kf_cloud(
            lm_j, jnp.asarray(cloud), jnp.asarray(f["valid"]),
            jnp.asarray(rot), jnp.asarray(tr), jnp.int32(slot),
            jnp.int32(oldest), cfg_j)
        lm_t = TLD.insert_kf_cloud(lm_t, _t(cloud), _t(f["valid"]), _t(rot),
                                   _t(tr), slot, oldest, cfg_t)
    return lm_j, lm_t


def _occupied(pts, valid, kf_id):
    key = np.floor(np.asarray(pts)[np.asarray(valid)] / CFG_VOXEL)
    return {(tuple(k), int(i)) for k, i in
            zip(key.astype(np.int64), np.asarray(kf_id)[np.asarray(valid)])}


def test_insert_kf_cloud(room):
    lm_j, lm_t = _maps(room, world_in=True)
    kf_j = np.asarray(lm_j.kf_id)[np.asarray(lm_j.valid)]
    assert set(kf_j.tolist()) == {1, 2}          # slot 0 was evicted
    np.testing.assert_array_equal(lm_t.valid.numpy(), np.asarray(lm_j.valid))
    np.testing.assert_array_equal(lm_t.kf_id.numpy(), np.asarray(lm_j.kf_id))
    np.testing.assert_array_equal(lm_t.pts.numpy(), np.asarray(lm_j.pts))

    lm_j, lm_t = _maps(room)
    flipped = 0
    for f in room[:3]:
        rot, tr = f["rot"], f["t"]
        pw_j = np.asarray(jnp.asarray(f["cloud"]) @ jnp.asarray(rot)
                          + (-jnp.asarray(rot).T @ jnp.asarray(tr)))
        pw_t = (_t(f["cloud"]) @ _t(rot) + (-_t(rot).T @ _t(tr))).numpy()
        np.testing.assert_allclose(pw_t, pw_j, atol=1e-6, rtol=0)
        flipped += int((np.floor(pw_j / CFG_VOXEL) != np.floor(
            pw_t / CFG_VOXEL)).any(1)[f["valid"]].sum())
    occ_j = _occupied(lm_j.pts, lm_j.valid, lm_j.kf_id)
    occ_t = _occupied(lm_t.pts, lm_t.valid, lm_t.kf_id)
    print(f"{len(occ_j ^ occ_t)} (voxel, KF) pairs differ; {flipped} "
          f"points fall in another voxel by the two transforms")
    assert len(occ_j) > 500 and len(occ_j ^ occ_t) <= 4 * flipped


def _query_pose(f):
    """The fourth frame's pose, 1 cm and 0.3 deg off the truth."""
    dr = np.asarray(JL.so3_exp(jnp.asarray(np.radians([0.3, -0.2, 0.1]),
                                           jnp.float32)))
    return dr @ f["rot"], f["t"] + np.float32([0.006, -0.005, 0.006])


@pytest.fixture(scope="module")
def planes(room):
    lm_j, _ = _maps(room)
    lm_t = TLD.LocalMap(_t(lm_j.pts), _t(lm_j.valid), _t(lm_j.kf_id).long())
    f = room[3]
    rot, tr = _query_pose(f)
    cfg_j, cfg_t = JLD.LidarConfig(**CFG), C.LidarConfig(**CFG)
    pj = JLD.make_plane_obs(lm_j, jnp.asarray(f["cloud"]),
                            jnp.asarray(f["valid"]), jnp.asarray(rot),
                            jnp.asarray(tr), cfg_j)
    pt = TLD.make_plane_obs(lm_t, _t(f["cloud"]), _t(f["valid"]), _t(rot),
                            _t(tr), cfg_t)
    return lm_j, f, rot, tr, pj, pt, cfg_j


def test_make_plane_obs(planes):
    lm_j, f, rot, tr, pj, pt, cfg = planes
    vj, vt = np.asarray(pj.valid), pt.valid.numpy()
    assert vj.sum() > 200
    # the gates' margins and the neighbour sets, from the reference's map
    pw = (f["cloud"] @ rot + (-rot.T @ tr)).astype(np.float32)
    idx_j, d2, ok = (np.asarray(x) for x in JP.knn_indices(
        jnp.asarray(pw), jnp.asarray(f["valid"]), lm_j.pts, lm_j.valid,
        cfg.knn))
    idx_t, _, _ = TP.knn_indices(_t(pw), _t(f["valid"]), _t(lm_j.pts),
                                 _t(lm_j.valid), cfg.knn)
    same_nb = (np.sort(idx_j, 1) == np.sort(idx_t.numpy(), 1)).all(1)
    nb = np.asarray(lm_j.pts, np.float64)[idx_j]
    w = ok.astype(np.float64)
    mean = (nb * w[..., None]).sum(1) / np.maximum(w.sum(1), 1)[:, None]
    c = (nb - mean[:, None]) * w[..., None]
    vals = np.linalg.eigvalsh(np.einsum("lki,lkj->lij", c, c)
                              / np.maximum(w.sum(1), 1)[:, None, None])
    near = ((np.abs(np.sqrt(np.maximum(vals[:, 0], 0)) - cfg.planarity_eps)
             < 1e-5)
            | (np.abs(vals[:, 1] - 4 * vals[:, 0] - 1e-12) < 1e-5)
            | (np.abs(d2[:, 0] - cfg.max_plane_dist ** 2) < 1e-5))
    differ = vj != vt
    print(f"valid differs at {differ.sum()} of {len(vj)} points: "
          f"{(differ & near).sum()} near a gate, {(differ & ~same_nb).sum()}"
          f" with other neighbours; {(~same_nb).sum()} queries with other "
          f"neighbours")
    assert (~same_nb).mean() <= 0.005
    assert not (differ & ~near & same_nb).any()
    both = vj & vt
    res_j = np.abs(np.einsum("li,li->l", np.asarray(pj.normal), pw)
                   + np.asarray(pj.d))[both]
    res_t = np.abs((pt.normal.numpy() * pw).sum(1) + pt.d.numpy())[both]
    np.testing.assert_allclose(res_t, res_j, atol=1e-5, rtol=0)
    dots = np.abs((pt.normal.numpy() * np.asarray(pj.normal)).sum(1))[both]
    np.testing.assert_allclose(dots, 1.0, atol=1e-4, rtol=0)


def test_pose_optimization_with_planes(planes):
    _, f, rot, tr, pj, _, _ = planes
    rs = np.random.RandomState(2)
    n = 200
    pc = np.stack([rs.uniform(-1.5, 1.5, n), rs.uniform(-1.0, 1.0, n),
                   rs.uniform(1.0, 4.0, n)], 1)
    r_true, t_true = f["rot"].astype(np.float64), f["t"].astype(np.float64)
    pts_w = ((pc - t_true) @ r_true).astype(np.float32)
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + W / 2,
                   FX * pc[:, 1] / pc[:, 2] + H / 2], 1)
    uv = (uv + rs.randn(n, 2) * 0.5).astype(np.float32)
    stereo = rs.rand(n) < 0.5
    ur = np.where(stereo, uv[:, 0] - 20.0 / pc[:, 2], -1.0).astype(np.float32)
    obs = dict(pts_w=pts_w, uv=uv, u_right=ur, is_stereo=stereo,
               inv_sigma2=np.ones(n, np.float32), valid=rs.rand(n) < 0.95)
    out_j = JPO.pose_optimization(
        jnp.asarray(rot), jnp.asarray(tr),
        JPO.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}), FX, FX,
        W / 2, H / 2, 20.0, plane_obs=pj, rounds=2, iters_per_round=5)
    pl = TPO.PlaneObs(*(_t(x) for x in pj))
    out_t = TPO.pose_optimization(
        _t(rot), _t(tr), TPO.PoseObs(**{k: _t(v) for k, v in obs.items()}),
        FX, FX, W / 2, H / 2, 20.0, plane_obs=pl, rounds=2,
        iters_per_round=5)
    d = np.linalg.norm(out_t[0].numpy().astype(np.float64)
                       - np.asarray(out_j[0], np.float64))
    assert 2 * np.arcsin(min(d / np.sqrt(8.0), 1.0)) < 1e-4
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               atol=1e-4, rtol=0)


def test_global_map_points(room, tmp_path):
    gj = JLD.GlobalMap(JLD.LidarConfig())
    gt = TLD.GlobalMap(C.LidarConfig())
    for i, f in enumerate(room[:3]):
        gj.add(f["cloud"], f["valid"], f["rot"], f["t"])
        args = (_t(f["cloud"]), _t(f["valid"]), _t(f["rot"]), _t(f["t"]))
        (gt.add_lazy if i == 2 else gt.add)(*args)
    pj, pt = gj.points(), gt.points()
    assert len(pj) > 500
    np.testing.assert_array_equal(np.unique(pt, axis=0),
                                  np.unique(pj, axis=0))
    gt.save_pcd(str(tmp_path / "globalMap.pcd"))
    lines = (tmp_path / "globalMap.pcd").read_text().splitlines()
    assert f"POINTS {len(pt)}" in lines and len(lines) == 11 + len(pt)


def test_frame_with_lidar_features(room):
    orb = dict(n_features=300, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0,
              lidar_features=True)
    gray = np.full((H, W), 120.0, np.float32)
    depth = room[2]["depth"]
    jcfg = JFrame(orb=JOrb(**orb), **fc)
    fj = jax.jit(lambda g, d: j_build_frame(g, d, jcfg, FX, FX, W / 2,
                                            H / 2))(gray, depth)
    ft = build_frame(_t(gray), _t(depth), C.FrameConfig(
        orb=C.OrbConfig(**orb), **fc), FX, FX, W / 2, H / 2)
    vj = np.asarray(fj.cloud_valid)
    assert 500 < vj.sum() <= 1024
    np.testing.assert_array_equal(ft.cloud_valid.numpy(), vj)
    np.testing.assert_allclose(ft.cloud.numpy()[vj], np.asarray(fj.cloud)[vj],
                               atol=1e-6, rtol=0)


def test_check_config_accepts_sensor_fusion():
    base = C.SystemConfig()
    imu = dataclasses.replace(base, imu=C.ImuConfig())
    for cfg in (dataclasses.replace(base, use_lidar=True),
                dataclasses.replace(base, use_odom=True),
                dataclasses.replace(imu, use_icp=True),
                dataclasses.replace(imu, use_of=True),
                dataclasses.replace(imu, use_icp=True, use_of=True),
                dataclasses.replace(base, use_lidar=True,
                                    local_ba_every_kf=False)):
        check_config(cfg)
    for ok in (dict(sensor="mono", use_of=True),
               dict(sensor="mono", use_lidar=True),
               dict(sensor="mono", use_odom=True)):
        cfg = dataclasses.replace(base, **ok)
        check_config(cfg)
        slam = SlamSystem(dataclasses.replace(cfg, k_max=4, m_max=64, frame=C.FrameConfig(orb=C.OrbConfig(
            n_features=50, n_levels=2, height=64, width=64))), "cpu")
        assert (slam.lidar_map is not None) == cfg.use_lidar
