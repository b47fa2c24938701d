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
