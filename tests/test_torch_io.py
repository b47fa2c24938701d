"""The port's host I/O against the JAX package's, on shared inputs made from
a seed with numpy:

* io/trajectory: the TUM, KITTI and EuRoC writers byte-equal to the JAX
  writers on the same poses, the TUM loader equal, and keyframe_trajectory
  of the same map equal (1e-12);
* io/datasets: load_image equal to the JAX load_image on PGM (8 and 16
  bit), PPM and PNG files (gray 8 and 16 bit, RGB, gray+alpha, RGBA, every
  row filter 0-4), and the native decoder (io/native_loader, built with
  g++; skipped only when no compiler is found) equal to the Python one on
  the gray files; the TUM association, imu.txt, odom.txt and EuRoC readers
  and imu_between equal;
* io/yaml_compat: every SystemConfig field equal to the JAX one for the
  fixtures' settings (TUM and EuRoC), a dual-KB8 stereo-fisheye file and a
  radtan file, and the reference's g1 config when a checkout of the
  reference is named by GEOFLOWSLAM_REFERENCE (skipped otherwise, as
  tests/test_io.py skips without it);
* io/fixtures: the exported TUM and EuRoC directories at 160x120 beside the
  JAX exporter's: images within 1 level (gray) or 1 step (depth) on at
  least 99.9% of pixels, the groundtruth and IMU text within 1e-6 (rtol
  1e-6 for values past 1), the association, CSV names and settings equal;
* utils/timers: the five files byte-equal to the JAX writers' for the same
  samples; viewer/html_export byte-equal for the same map and poses;
* pipeline/async_api.AsyncSlam as tests/test_io.py drives the JAX one.
"""
import dataclasses
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import datasets as JD
from geoflowslam_tpu.io import fixtures as JFX
from geoflowslam_tpu.io import trajectory as JTR
from geoflowslam_tpu.io import yaml_compat as JY
from geoflowslam_tpu.utils.timers import StageTimers as JTimers
from geoflowslam_tpu.viewer import html_export as JH

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.io import datasets as D
from geoflowslam_tpu_torch.io import fixtures as FX
from geoflowslam_tpu_torch.io import native_loader as NL
from geoflowslam_tpu_torch.io import trajectory as TR
from geoflowslam_tpu_torch.io import yaml_compat as Y
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.utils import native_build
from geoflowslam_tpu_torch.utils.timers import StageTimers
from geoflowslam_tpu_torch.viewer import html_export as H

torch.set_num_threads(2)


def _poses(rng, n):
    out = []
    for i in range(n):
        w = rng.normal(size=3) * 0.8
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        twc = np.eye(4)
        twc[:3, :3] = (np.eye(3) + np.sin(th) / th * k
                       + (1 - np.cos(th)) / th ** 2 * (k @ k))
        twc[:3, 3] = rng.normal(size=3)
        out.append((1.4e9 + 0.1 * i + rng.uniform(0, 1e-3), twc))
    return out


def _map(rng, k=6, n=16, m=64):
    """A port MapState with random contents in every field."""
    ms = M.create(k, n, m, "cpu")
    vals = {}
    for f in ms._fields:
        ref = getattr(ms, f)
        if ref.dtype == torch.bool:
            v = torch.from_numpy(np.asarray(rng.random(tuple(ref.shape))
                                            < 0.6))
        elif ref.dtype == torch.int32:
            v = torch.from_numpy(np.asarray(rng.integers(
                -2 ** 31, 2 ** 31 - 1, size=tuple(ref.shape),
                dtype=np.int64), np.int32))
        else:
            v = torch.from_numpy(np.asarray(rng.normal(
                size=tuple(ref.shape)), np.float32))
        vals[f] = v
    vals["kf_rot"] = torch.from_numpy(np.stack(
        [p[1][:3, :3].T for p in _poses(rng, k)]).astype(np.float32))
    vals["kf_time"] = torch.from_numpy(rng.uniform(0, 5, k)
                                       .astype(np.float32))
    return M.MapState(**vals)


def _jax_fields(ms):
    """The port map as the JAX package's arrays (uint32 descriptors)."""
    from geoflowslam_tpu_torch.state.serialize import ms_to_host
    return ms_to_host(ms)


def test_trajectory_writers_byte_equal(tmp_path):
    traj = _poses(np.random.default_rng(0), 25)
    for name, a, b in (("tum", JTR.save_trajectory_tum,
                        TR.save_trajectory_tum),
                       ("kitti", JTR.save_trajectory_kitti,
                        TR.save_trajectory_kitti),
                       ("euroc", JTR.save_trajectory_euroc,
                        TR.save_trajectory_euroc)):
        a(str(tmp_path / f"j_{name}.txt"), traj)
        b(str(tmp_path / f"t_{name}.txt"), traj)
        assert ((tmp_path / f"j_{name}.txt").read_bytes()
                == (tmp_path / f"t_{name}.txt").read_bytes()), name
    lj = JTR.load_trajectory_tum(str(tmp_path / "j_tum.txt"))
    lt = TR.load_trajectory_tum(str(tmp_path / "t_tum.txt"))
    assert len(lj) == len(lt) == 25
    for (tj, mj), (tt, mt) in zip(lj, lt):
        assert tj == tt
        np.testing.assert_array_equal(mj, mt)


def test_keyframe_trajectory_equal():
    ms = _map(np.random.default_rng(1))
    jms = _jax_fields(ms)

    class JMap:   # the fields keyframe_trajectory reads, as numpy
        kf_valid, kf_time = jms["kf_valid"], jms["kf_time"]
        kf_rot, kf_t = jms["kf_rot"], jms["kf_t"]

    kj = JTR.keyframe_trajectory(JMap, time_base=1.4e9)
    kt = TR.keyframe_trajectory(ms, time_base=1.4e9)
    assert len(kj) == len(kt) == int(ms.kf_valid.sum())
    for (tj, mj), (tt, mt) in zip(kj, kt):
        assert tj == tt
        np.testing.assert_allclose(mt, mj, atol=1e-12, rtol=0)


def _png_chunk(ctype: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data) & 0xFFFFFFFF))


def _filter_row(line, prev, bpp, ftype):
    """PNG row filter `ftype` (0-4) of one row of bytes (int arrays)."""
    left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(line)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, ul))
    return ((line - pred) & 0xFF).astype(np.uint8)


def _write_png(path, img, color, bitd):
    """img [H, W, C] uint8/uint16; rows filtered 0, 1, 2, 3, 4, 0, ..."""
    h, w, nch = img.shape
    be = img.astype(">u2" if bitd == 16 else np.uint8)
    rows = np.frombuffer(be.tobytes(), np.uint8).reshape(h, -1)
    bpp = nch * bitd // 8
    raw, prev = b"", np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        line = rows[y].astype(np.int64)
        raw += bytes([y % 5]) + _filter_row(line, prev, bpp, y % 5).tobytes()
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, bitd, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def _image_files(tmp_path):
    rng = np.random.default_rng(2)
    h, w = 23, 37
    g8 = rng.integers(0, 256, (h, w, 1), dtype=np.uint16).astype(np.uint8)
    g16 = rng.integers(0, 65536, (h, w, 1), dtype=np.uint32).astype(
        np.uint16)
    gray, other = [], []
    for name, img, color, bitd in (("g8", g8, 0, 8), ("g16", g16, 0, 16)):
        p = str(tmp_path / f"{name}.png")
        _write_png(p, img, color, bitd)
        gray.append(p)
    for name, nch, color in (("rgb", 3, 2), ("ga", 2, 4), ("rgba", 4, 6)):
        img = rng.integers(0, 256, (h, w, nch), dtype=np.uint16).astype(
            np.uint8)
        p = str(tmp_path / f"{name}.png")
        _write_png(p, img, color, 8)
        other.append(p)
    rgb16 = rng.integers(0, 65536, (h, w, 3), dtype=np.uint32).astype(
        np.uint16)
    _write_png(str(tmp_path / "rgb16.png"), rgb16, 2, 16)
    other.append(str(tmp_path / "rgb16.png"))
    p = str(tmp_path / "g8.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n# a comment\n%d %d\n255\n" % (w, h) + g8.tobytes())
    gray.append(p)
    p = str(tmp_path / "g16.pgm")
    with open(p, "wb") as f:
        f.write(b"P5\n%d %d\n65535\n" % (w, h) + g16.astype(">u2").tobytes())
    gray.append(p)
    p = str(tmp_path / "c.ppm")
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint16).astype(np.uint8)
    with open(p, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h) + rgb.tobytes())
    other.append(p)
    return gray, other, (h, w)


def test_load_image_equal_to_jax(tmp_path):
    gray, other, _ = _image_files(tmp_path)
    for p in gray + other:
        a, b = JD.load_image(p), D.load_image(p)
        assert a.dtype == b.dtype == np.float32, p
        np.testing.assert_array_equal(b, a, err_msg=p)


def test_native_decoder_equal_to_python(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler on this host")
    assert NL.native_available(), native_build.build_log()
    gray, _, (h, w) = _image_files(tmp_path)
    loader = NL.FrameLoader(gray, gray[::-1], height=h, width=w,
                            depth_scale=0.5)
    assert loader.native
    seen = []
    for i, g, d in loader:
        np.testing.assert_array_equal(g, JD.load_image(gray[i]))
        np.testing.assert_array_equal(
            d, JD.load_image(gray[::-1][i]) * np.float32(0.5))
        seen.append(i)
    loader.close()
    assert seen == list(range(len(gray)))
    monkeypatch.setattr(NL, "_load_lib", lambda: None)  # no library
    py = NL.FrameLoader(gray, None, height=h, width=w)
    assert not py.native
    for i, g, d in py:
        assert d is None
        np.testing.assert_array_equal(g, JD.load_image(gray[i]))


def test_dataset_readers_equal(tmp_path):
    rng = np.random.default_rng(3)
    seq = tmp_path / "seq"
    (seq / "imu").mkdir(parents=True)
    lines = [f"{1.4e9 + 0.1 * i:.6f} rgb/{i}.png {1.4e9 + 0.1 * i + 0.01:.6f}"
             f" depth/{i}.png" for i in range(7)]
    (seq / "assoc.txt").write_text("# t rgb t depth\n" + "\n".join(lines))
    imu = np.column_stack([1.4e9 + np.sort(rng.uniform(0, 0.7, 150)),
                           rng.normal(size=(150, 6))])
    (seq / "imu" / "imu.txt").write_text(
        "# t wx wy wz ax ay az\n"
        + "\n".join(",".join(f"{v:.9f}" for v in r) for r in imu))
    (seq / "imu" / "odom.txt").write_text(
        "\n".join(" ".join(f"{v:.6f}" for v in r) for r in imu[:20, :4]))
    ja = JD.load_tum_associations(str(seq), str(seq / "assoc.txt"))
    ta = D.load_tum_associations(str(seq), str(seq / "assoc.txt"))
    assert [dataclasses.astuple(x) for x in ja] == [
        dataclasses.astuple(x) for x in ta]
    for fn in ("load_imu_txt", "load_odom_txt"):
        path = str(seq / "imu" / ("imu.txt" if "imu" in fn else "odom.txt"))
        np.testing.assert_array_equal(getattr(D, fn)(path),
                                      getattr(JD, fn)(path))
    rows = D.load_imu_txt(str(seq / "imu" / "imu.txt"))
    for t0, t1, cap in ((1.4e9, 1.4e9 + 0.1, 32), (1.4e9 + 0.2,
                                                   1.4e9 + 0.65, 16)):
        for a, b in zip(D.imu_between(rows, t0, t1, cap),
                        JD.imu_between(rows, t0, t1, cap)):
            np.testing.assert_array_equal(a, b)
    euroc = tmp_path / "euroc"
    FX.export_euroc(str(euroc), n_frames=3, width=64, height=48)
    fj, ij = JD.load_euroc(str(euroc))
    ft, it = D.load_euroc(str(euroc))
    assert [dataclasses.astuple(x) for x in fj] == [
        dataclasses.astuple(x) for x in ft]
    np.testing.assert_array_equal(it, ij)


def _assert_config_equal(a, b, path="cfg"):
    """Every field of a port config dataclass equal to the JAX one's."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        fa = {f.name for f in dataclasses.fields(a)}
        assert fa == {f.name for f in dataclasses.fields(b)}, path
        for f in fa:
            _assert_config_equal(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


_FISHEYE = """%YAML:1.0
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.97847715128717
Camera1.fy: 190.9733070521226
Camera1.cx: 254.93170605935475
Camera1.cy: 256.8974428996504
Camera1.k1: 0.0034823894022493434
Camera1.k2: 0.0007150348452162257
Camera1.k3: -0.0020532361418706202
Camera1.k4: 0.00020293673591811182
Camera2.fx: 190.44236969414825
Camera2.fy: 190.4344384721956
Camera2.cx: 252.59949716835982
Camera2.cy: 254.91723064636983
Camera2.k1: 0.0034003170790442797
Camera2.k2: 0.001766278153469831
Camera2.k3: -0.00266312569781606
Camera2.k4: 0.0003299517423931039
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera1.overlappingBegin: 0
Camera1.overlappingEnd: 511
Camera2.overlappingBegin: 0
Camera2.overlappingEnd: 511
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997,-0.00231714,-0.000343393,0.101175,
         0.0023175,0.999997,0.000373837,0.00197698,
         0.000342526,-0.000374631,1.0,0.00104331,
         0,0,0,1]
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 0.000022
IMU.AccWalk: 0.00086
IMU.Frequency: 200
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [-0.99952504,0.00750192,-0.02989013,0.04557484,
         0.02961534,-0.03439736,-0.99896935,-0.07116180,
         -0.00852233,-0.99938008,0.03415885,-0.04468125,
         0.0,0.0,0.0,1.0]
ORBextractor.nFeatures: 1500
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
UseClahe: 1
UseOpticalFlow: 1
UseICP: 1
ICPMethod: "NDT"
TimeRecentlyLost: 3.0
InsertKFsWhenLost: 0
"""

_RADTAN = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.bf: 47.90639384423901
ThDepth: 35.0
UseRobotOdom: 1
UsePointCloudObs: 1
UseGMSInit: 1
T_odom_w: !!opencv-matrix
  rows: 3
  cols: 3
  dt: f
  data: [0, -1, 0, 0, 0, -1, 1, 0, 0]
"""


def test_yaml_compat_equal(tmp_path):
    seq = str(tmp_path / "tum")
    _, tum_yaml, _ = FX.export_tum_rgbd(seq, n_frames=2, width=64, height=48)
    FX.export_euroc(str(tmp_path / "euroc"), n_frames=2, width=64, height=48)
    (tmp_path / "fisheye.yaml").write_text(_FISHEYE)
    (tmp_path / "radtan.yaml").write_text(_RADTAN)
    cases = [(tum_yaml, "rgbd"), (tum_yaml, None),
             (str(tmp_path / "euroc" / "settings.yaml"), "mono"),
             (str(tmp_path / "fisheye.yaml"), None),
             (str(tmp_path / "radtan.yaml"), "rgbd")]
    for path, sensor in cases:
        cfg_t, y_t = Y.system_config_from_yaml(path, sensor=sensor)
        cfg_j, y_j = JY.system_config_from_yaml(path, sensor=sensor)
        assert isinstance(cfg_t, C.SystemConfig)
        assert sorted(y_t) == sorted(y_j)
        for k in y_t:
            np.testing.assert_array_equal(np.asarray(y_t[k]),
                                          np.asarray(y_j[k]), err_msg=k)
        _assert_config_equal(cfg_t, cfg_j, path)
    fish, _ = Y.system_config_from_yaml(str(tmp_path / "fisheye.yaml"))
    assert fish.sensor == "stereo" and fish.stereo_fisheye is not None
    assert fish.frame.camera_model == "kb8" and fish.icp_method == "ndt"
    ref = os.path.join(os.environ.get("GEOFLOWSLAM_REFERENCE", ""),
                       "Examples/ROS2/RGB-D-Inertial/config/"
                       "g1_op_icp_lidar_indoor1.yaml")
    if not os.path.isfile(ref):
        pytest.skip("reference config not mounted")
    _assert_config_equal(Y.system_config_from_yaml(ref)[0],
                         JY.system_config_from_yaml(ref)[0], ref)


def _numbers(path):
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                rows.append([float(v) for v in line.replace(",", " ")
                             .split()])
    return np.asarray(rows)


def _assert_images_close(pa, pb, tol):
    a, b = JD.load_image(pa), JD.load_image(pb)
    assert a.shape == b.shape, (pa, a.shape, b.shape)
    assert np.mean(np.abs(a - b) <= tol) >= 0.999, (pa, np.abs(a - b).max())


def test_fixtures_equal_to_jax(tmp_path):
    kw = dict(n_frames=4, fps=10.0, width=160, height=120)
    j, t = tmp_path / "j", tmp_path / "t"
    JFX.export_tum_rgbd(str(j / "tum"), **kw)
    FX.export_tum_rgbd(str(t / "tum"), **kw)
    JFX.export_euroc(str(j / "euroc"), **kw)
    FX.export_euroc(str(t / "euroc"), **kw)
    for rel in ("tum/assoc.txt", "tum/settings.yaml",
                "euroc/mav0/cam0/data.csv", "euroc/settings.yaml"):
        assert (j / rel).read_text() == (t / rel).read_text(), rel
    for rel in ("tum/groundtruth.txt", "tum/imu/imu.txt",
                "euroc/groundtruth.txt", "euroc/mav0/imu0/data.csv"):
        a, b = _numbers(j / rel), _numbers(t / rel)
        assert a.shape == b.shape, rel
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6, err_msg=rel)
    for line in (j / "tum/assoc.txt").read_text().split("\n"):
        if line:
            _, rgb, _, dep = line.split()
            _assert_images_close(str(j / "tum" / rgb), str(t / "tum" / rgb),
                                 1.0)
            _assert_images_close(str(j / "tum" / dep), str(t / "tum" / dep),
                                 1.0)
    for name in os.listdir(j / "euroc/mav0/cam0/data"):
        _assert_images_close(str(j / "euroc/mav0/cam0/data" / name),
                             str(t / "euroc/mav0/cam0/data" / name), 1.0)
    # the PNG writer round-trips both readers at 8 and 16 bit
    g16 = (np.arange(48 * 64).reshape(48, 64) * 7 % 60001).astype(np.uint16)
    FX.write_png_gray(str(tmp_path / "d16.png"), g16)
    np.testing.assert_array_equal(D.load_image(str(tmp_path / "d16.png")),
                                  g16.astype(np.float32))


def test_timers_and_html_byte_equal(tmp_path):
    rng = np.random.default_rng(4)
    tj, tt = JTimers(), StageTimers()
    for stage in ("Track_total", "LBA", "New_KF", "KF_insert", "Custom"):
        for v in rng.uniform(0, 50, rng.integers(1, 9)):
            tj.add(stage, float(v))
            tt.add(stage, float(v))
    info = {"sensor": "rgbd", "n_frames": 12, "state": "OK"}
    tj.write_all(str(tmp_path / "j"), info)
    tt.write_all(str(tmp_path / "t"), info)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) == [
        "ExecTimeMean.txt", "LBA_Stats.txt", "LocalMapTimeStats.txt",
        "SessionInfo.txt", "TrackTimeCost.txt"]
    for n in names:
        assert ((tmp_path / "j" / n).read_bytes()
                == (tmp_path / "t" / n).read_bytes()), n
    ms = _map(rng)
    jms = _jax_fields(ms)

    class JMap:
        mp_valid, mp_pos = jms["mp_valid"], jms["mp_pos"]
        kf_valid, kf_rot, kf_t = jms["kf_valid"], jms["kf_rot"], jms["kf_t"]

    traj = _poses(rng, 6)
    JH.export_html(JMap, traj, jms["kf_rot"][0], jms["kf_t"][0],
                   path=str(tmp_path / "j.html"), max_points=20)
    H.export_html(ms, traj, ms.kf_rot[0], ms.kf_t[0],
                  path=str(tmp_path / "t.html"), max_points=20)
    assert (tmp_path / "j.html").read_bytes() == (tmp_path /
                                                  "t.html").read_bytes()


def test_async_slam():
    from geoflowslam_tpu_torch.io.synthetic import (Camera,
                                                    SyntheticSequence,
                                                    SyntheticWorld)
    from geoflowslam_tpu_torch.pipeline.async_api import AsyncSlam
    from geoflowslam_tpu_torch.pipeline.system import SlamSystem

    w, h = 320, 240
    cam = Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    orb = C.OrbConfig(n_features=200, n_levels=3, height=h, width=w)
    fc = C.FrameConfig(orb=orb, lk_levels=2, cloud_stride=8,
                       cloud_max_pts=512, bf=20.0)
    cfg = C.SystemConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                         bf=20.0, frame=fc, k_max=8, m_max=1024)
    seq = SyntheticSequence(SyntheticWorld(cam, device="cpu"), fps=10.0)
    aslam = AsyncSlam(SlamSystem(cfg, "cpu"))
    futs = []
    for i in range(5):
        t = i / seq.fps
        gray, depth, _ = seq.frame(t)
        futs.append(aslam.track_rgbd_async(gray.numpy(), depth.numpy(), t))
    poses = [f.result(timeout=300) for f in futs]
    assert all(p.shape == (4, 4) and np.all(np.isfinite(p)) for p in poses)
    assert aslam.slam.n_frames == 5
    aslam.shutdown()
    assert not aslam.worker.is_alive()
