"""The port's dataset drivers from disk to trajectory on the CPU
(geoflowslam_tpu_torch/tools/run_rgbd_tum.py and run_euroc.py over the
port's io/fixtures directories at 320x240), with the bounds of the JAX
drivers' tests (tests/test_dataset_drivers.py, slow tier there; only the
port runs here):

* run_rgbd_tum.main --imu: state OK, at least 30 exported poses, an
  SE3-aligned ATE against the written groundtruth under 6 cm, the shutdown
  file set; KeyFrameTrajectory.txt on the sequence's absolute time stamps;
  the --atlas file loads into a new SlamSystem with its KFs;
* run_euroc.main --mode mono: the Sim3-aligned ATE of the post-bootstrap
  segment under 15 cm;
* the drivers default to the CUDA device and raise without CUDA;
* tools/run_hardmode.py --mode mono (track_monocular on the hard
  sequence's gray images) over 40 frames at 320x240: state OK, >= 3 KFs,
  the 7-DoF ATE under 20 cm (a smoke gate: the monocular parity with the
  JAX package is tests/test_torch_slice_mono.py's).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from geoflowslam_tpu_torch.io import fixtures as FX
from geoflowslam_tpu_torch.io.yaml_compat import system_config_from_yaml
from geoflowslam_tpu_torch.pipeline.system import SlamSystem
from geoflowslam_tpu_torch.tools import run_euroc, run_hardmode, run_rgbd_tum

torch.set_num_threads(2)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_dataset_drivers import _ate, _load_tum_traj  # noqa: E402


def test_tum_rgbd_inertial_driver(tmp_path):
    seq = str(tmp_path / "tum_seq")
    _, settings, assoc = FX.export_tum_rgbd(seq, n_frames=35, fps=10.0)
    out, atlas = str(tmp_path / "out"), str(tmp_path / "atlas")
    res = run_rgbd_tum.main([settings, seq, assoc, "--imu", "--out", out,
                             "--atlas", atlas, "--device", "cpu"])
    slam = res["slam"]
    assert slam.map_stats()["state"] == "OK"
    assert slam.imu is not None and len(res["frame_ms"]) == 35
    traj = _load_tum_traj(os.path.join(out, "CameraTrajectory.txt"))
    gt = _load_tum_traj(os.path.join(seq, "groundtruth.txt"))
    assert len(traj) >= 30
    ate = _ate(traj, gt)
    assert ate < 0.06, f"ATE {ate * 100:.2f} cm"
    for n in ("KeyFrameTrajectory.txt", "map.html", "ExecTimeMean.txt",
              "LocalMapTimeStats.txt", "LBA_Stats.txt", "SessionInfo.txt",
              "TrackTimeCost.txt"):
        assert os.path.exists(os.path.join(out, n)), n
    kf = _load_tum_traj(os.path.join(out, "KeyFrameTrajectory.txt"))
    gt_t = {round(r[0], 4) for r in gt}
    assert len(kf) == slam.map_stats()["n_kfs"]
    assert all(round(r[0], 4) in gt_t for r in kf)
    cfg, _ = system_config_from_yaml(settings, sensor="rgbd")
    fresh = SlamSystem(cfg, "cpu")
    fresh.load_atlas(atlas)
    assert fresh.map_stats()["n_kfs"] == slam.map_stats()["n_kfs"]
    assert fresh.map_stats()["n_maps"] == slam.map_stats()["n_maps"] + 1
    assert fresh.time_base == slam.time_base == 1.4e9


def test_euroc_mono_driver(tmp_path):
    seq = str(tmp_path / "euroc_seq")
    FX.export_euroc(seq, n_frames=45, fps=10.0)
    out = str(tmp_path / "out")
    run_euroc.main([seq, "--mode", "mono", "--settings",
                    os.path.join(seq, "settings.yaml"), "--out", out,
                    "--device", "cpu"])
    traj = _load_tum_traj(os.path.join(out, "CameraTrajectory.txt"))
    gt = _load_tum_traj(os.path.join(seq, "groundtruth.txt"))
    assert len(traj) >= 20
    # mono: scale-free, Sim3 (Umeyama) over the post-bootstrap segment
    gt_by_t = {round(r[0], 4): r[1:4] for r in gt}
    p_est, p_gt = [], []
    for r in traj[15:]:
        g = gt_by_t.get(round(r[0], 4))
        if g is not None:
            p_est.append(r[1:4])
            p_gt.append(g)
    assert len(p_est) >= 15
    p_est, p_gt = np.asarray(p_est), np.asarray(p_gt)
    mu_e, mu_g = p_est.mean(0), p_gt.mean(0)
    cov = (p_gt - mu_g).T @ (p_est - mu_e) / len(p_est)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u @ vt))
    rot = u @ np.diag([1, 1, d]) @ vt
    var_e = ((p_est - mu_e) ** 2).sum(1).mean()
    scale = (s * np.array([1, 1, d])).sum() / max(var_e, 1e-12)
    err = (p_gt - mu_g) - scale * (p_est - mu_e) @ rot.T
    ate = float(np.sqrt((err ** 2).sum(1).mean()))
    assert ate < 0.15, f"Sim3 ATE {ate * 100:.2f} cm"


def test_drivers_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = str(tmp_path / "tum_seq")
    _, settings, assoc = FX.export_tum_rgbd(seq, n_frames=2, width=64,
                                            height=48)
    assert run_rgbd_tum.parse_args([settings, seq, assoc]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_rgbd_tum.main([settings, seq, assoc, "--out",
                           str(tmp_path / "o")])
    FX.export_euroc(str(tmp_path / "euroc"), n_frames=2, width=64, height=48)
    assert run_euroc.parse_args([str(tmp_path / "euroc")]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_euroc.main([str(tmp_path / "euroc"), "--mode", "mono",
                        "--out", str(tmp_path / "o2")])


def test_hardmode_driver_mono(tmp_path):
    out = str(tmp_path / "hm")
    assert run_hardmode.main([
        "--mode", "mono", "--device", "cpu", "--width", "320", "--height",
        "240", "--features", "400", "--frames", "40", "--out", out]) == 0
    with open(os.path.join(out, "hardmode.json")) as f:
        res = json.load(f)
    assert res["map"]["state"] == "OK" and res["map"]["n_kfs"] >= 3, res
    assert res["ate_rmse_m"] < 0.2, res
    assert os.path.exists(os.path.join(out, "CameraTrajectory.txt"))
