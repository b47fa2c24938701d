"""The port's copies of the reference's configs and numpy-only modules stay
equal to the originals, and the port imports no JAX."""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from geoflowslam_tpu.eval import ate as ate_jax
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline.local_mapping import MappingConfig as JMap
from geoflowslam_tpu.pipeline.loop_closing import LoopConfig as JLoop
from geoflowslam_tpu.pipeline.system import SystemConfig as JSys
from geoflowslam_tpu.pipeline.tracking import TrackConfig as JTrack
from geoflowslam_tpu.state.frame import FrameConfig as JFrame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.eval import ate as ate_torch

torch.set_num_threads(2)

PAIRS = [(C.OrbConfig, JOrb), (C.FrameConfig, JFrame), (C.TrackConfig, JTrack),
         (C.MappingConfig, JMap), (C.LoopConfig, JLoop), (C.SystemConfig, JSys)]
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


def test_port_imports_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|geoflowslam_tpu\b(?!_torch))",
                     re.M)
    offenders = [str(p) for p in PORT_DIR.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    assert not pat.search((PORT_DIR.parent / "chip_smoke.py").read_text())
