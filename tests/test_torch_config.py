"""The port's copies of the reference's configs and numpy-only modules stay
equal to the originals, and the port imports no JAX."""
import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from geoflowslam_tpu.eval import ate as ate_jax
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.inertial import ImuConfig as JImu
from geoflowslam_tpu.pipeline.lidar_mapping import LidarConfig as JLidar
from geoflowslam_tpu.pipeline.local_mapping import MappingConfig as JMap
from geoflowslam_tpu.pipeline.loop_closing import LoopConfig as JLoop
from geoflowslam_tpu.pipeline.system import StereoFisheyeConfig as JSF
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.pipeline.tracking import TrackConfig as JTrack
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval import ate as ate_torch

torch.set_num_threads(2)

PAIRS = [(C.OrbConfig, JOrb), (C.FrameConfig, JFrame), (C.TrackConfig, JTrack),
         (C.MappingConfig, JMap), (C.LoopConfig, JLoop),
         (C.SystemConfig, JSys), (C.LidarConfig, JLidar),
         (C.StereoFisheyeConfig, JSF)]
PORT_DIR = Path(__file__).resolve().parents[1] / "geoflowslam_tpu_torch"


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def _plain(v):
    """Nested dataclass defaults compared field by field."""
    if dataclasses.is_dataclass(v):
        return {k: _plain(x) for k, x in dataclasses.asdict(v).items()}
    return v


@pytest.mark.parametrize("port,ref", PAIRS, ids=[p.__name__ for p, _ in PAIRS])
def test_config_fields_and_defaults_equal(port, ref):
    assert dataclasses.is_dataclass(port)
    assert port.__dataclass_params__.frozen
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    dp, dr = _defaults(port), _defaults(ref)
    for name in dp:
        assert _plain(dp[name]) == _plain(dr[name]), name


def test_imu_config_equal():
    """ImuConfig: the same fields and defaults (t_bc compared as an array)
    and the same calibration from calib()."""
    assert C.ImuConfig.__dataclass_params__.frozen
    assert [f.name for f in dataclasses.fields(C.ImuConfig)] == \
        [f.name for f in dataclasses.fields(JImu)]
    dp, dr = _defaults(C.ImuConfig), _defaults(JImu)
    for name in dp:
        np.testing.assert_array_equal(np.asarray(dp[name]),
                                      np.asarray(dr[name]), err_msg=name)
    for cfg_p, cfg_r in ((C.ImuConfig(), JImu()),
                         (C.ImuConfig(freq=100.0, noise_acc=0.01),
                          JImu(freq=100.0, noise_acc=0.01))):
        for a, b in zip(cfg_p.calib(), cfg_r.calib()):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)


def test_config_methods_equal():
    for n_levels, sf, nf in [(8, 1.2, 1000), (4, 1.2, 400), (6, 1.5, 777)]:
        a = C.OrbConfig(n_features=nf, n_levels=n_levels, scale_factor=sf)
        b = JOrb(n_features=nf, n_levels=n_levels, scale_factor=sf)
        assert a.per_level_quota() == b.per_level_quota()
        assert a.scale_factors() == b.scale_factors()
    sp = C.SystemConfig(fx=200.0, fy=210.0, cx=160.0, cy=120.0, bf=20.0,
                        close_depth=3.0)
    sr = JSys(fx=200.0, fy=210.0, cx=160.0, cy=120.0, bf=20.0,
              close_depth=3.0)
    assert dataclasses.asdict(sp.track_cfg()) == dataclasses.asdict(sr.track_cfg())
    assert dataclasses.asdict(sp.map_cfg()) == dataclasses.asdict(sr.map_cfg())


def test_check_config_stereo_and_cameras():
    """check_config takes the stereo sensor and a stereo-fisheye rig,
    check_supported KB8 and radtan keypoint undistortion, and the monocular
    sensor with and without the IMU; local BA off, the monocular sensor
    with OF or lidar, and an unknown camera model still raise."""
    from geoflowslam_tpu_torch.pipeline.system import SlamSystem, check_config
    from geoflowslam_tpu_torch.state.frame import check_supported
    kb8 = C.FrameConfig(camera_model="kb8",
                        dist_params=(0.0035, 0.0007, -0.002, 0.0002))
    radtan = C.FrameConfig(dist_params=(-0.28, 0.07, 2e-4, 1.8e-5))
    rig = C.StereoFisheyeConfig(
        params_r=(190.0, 190.0, 256.0, 256.0, 0.003, 0.001, -0.002, 0.0),
        r_lr=(1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0), t_lr=(0.1, 0.0, 0.0))
    base = C.SystemConfig()
    for cfg in (dataclasses.replace(base, sensor="stereo"),
                dataclasses.replace(base, sensor="stereo", frame=kb8,
                                    stereo_fisheye=rig),
                dataclasses.replace(base, frame=radtan),
                dataclasses.replace(base, sensor="stereo", frame=kb8,
                                    stereo_fisheye=rig, imu=C.ImuConfig()),
                dataclasses.replace(base, sensor="mono"),
                dataclasses.replace(base, sensor="mono", imu=C.ImuConfig()),
                dataclasses.replace(base, local_ba_every_kf=False)):
        check_config(cfg)
        check_supported(cfg.frame)
    for bad in (dict(sensor="mono", use_of=True),
                dict(sensor="mono", use_icp=True),
                dict(sensor="mono", imu=C.ImuConfig(), use_lidar=True)):
        with pytest.raises(NotImplementedError):
            check_config(dataclasses.replace(base, **bad))
    with pytest.raises(NotImplementedError):
        check_supported(C.FrameConfig(camera_model="equidistant"))
    slam = SlamSystem(dataclasses.replace(
        base, k_max=4, m_max=64, frame=dataclasses.replace(
            base.frame, orb=C.OrbConfig(n_features=50, n_levels=2,
                                        height=64, width=64))), "cpu")
    with pytest.raises(ValueError):          # no rig configured
        slam.track_stereo_fisheye(np.zeros((64, 64)), np.zeros((64, 64)), 0.0)
    with pytest.raises(ValueError):          # no IMU configured
        slam.track_stereo_inertial(np.zeros((64, 64)), np.zeros((64, 64)),
                                   np.zeros((1, 3)), np.zeros((1, 3)),
                                   np.zeros(1), 0.0)


def test_ate_copy_equal():
    rs = np.random.RandomState(3)
    gt, est = [], []
    for i in range(30):
        g = np.eye(4)
        g[:3, 3] = rs.randn(3)
        e = g.copy()
        e[:3, 3] += rs.randn(3) * 0.01
        gt.append((i * 0.1, g))
        est.append((i * 0.1 + 0.001, e))
    assert ate_torch.ate_rmse(est, gt) == ate_jax.ate_rmse(est, gt)
    assert ate_torch.rpe(est, gt) == ate_jax.rpe(est, gt)
    assert ate_torch.associate(np.arange(5.0), np.arange(5.0) + 0.01) == \
        ate_jax.associate(np.arange(5.0), np.arange(5.0) + 0.01)


PORT_FILES = sorted(PORT_DIR.rglob("*.py")) + [PORT_DIR.parent /
                                               "chip_smoke.py"]


def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|geoflowslam_tpu\b(?!_torch))",
                     re.M)
    offenders = [str(p) for p in PORT_FILES if pat.search(p.read_text())]
    assert offenders == []


def _reference_paths(path):
    """String constants of a source file, docstrings left out, that name the
    reference package's directory or a file in it. chip_smoke.py's
    `replaces=` labels (file:line of the TPU kernel, never opened) do not
    count."""
    tree = ast.parse(path.read_text())
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)):
                skip.add(id(first.value))
        if isinstance(node, ast.keyword) and node.arg == "replaces":
            skip.add(id(node.value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in skip
            and re.search(r"geoflowslam_tpu(?!_torch)(/|$)", node.value)]


def test_port_reads_no_file_of_the_reference():
    """The port keeps its own copy of the one data file it needs, and no
    code of it or of chip_smoke.py holds a path into the reference."""
    asset = Path("assets") / "vocab_default.npz"
    ours = PORT_DIR / asset
    assert ours.read_bytes() == (PORT_DIR.parent / "geoflowslam_tpu"
                                 / asset).read_bytes()
    from geoflowslam_tpu_torch.retrieval import vocab
    assert vocab.DEFAULT_VOCAB_PATH == ours
    assert {str(p): _reference_paths(p) for p in PORT_FILES
            if _reference_paths(p)} == {}
    probe = PORT_DIR.parent / "tests" / "test_torch_config.py"
    assert _reference_paths(probe)          # the scan does see such a path


def test_port_passes_no_level_fn():
    """klt_track's `level_fn` exists so that a check can hold CUDA tensors to
    the plain level function; no module of the port may pass it."""
    callers = [str(p) for p in sorted(PORT_DIR.rglob("*.py"))
               for node in ast.walk(ast.parse(p.read_text()))
               if isinstance(node, ast.keyword) and node.arg == "level_fn"]
    assert callers == []
    probe = ast.parse((PORT_DIR.parent / "chip_smoke.py").read_text())
    assert any(isinstance(n, ast.keyword) and n.arg == "level_fn"
               for n in ast.walk(probe))    # the scan does see such a call
