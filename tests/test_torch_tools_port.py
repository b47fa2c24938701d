"""The port's last host-side surface against the JAX package's:

* utils/timers.StageTimers.summary_lines: the same strings as the JAX
  class's for the same samples, ties (equal means) in insertion order;
* tools/calibration_recorder.record_synthetic against the JAX tool's, a
  few frames at 320x240 on the CPU: cam0/times.txt identical, imu0/data.csv
  identical in static mode and within 1e-6 with the moving rig (rtol 1e-6
  for values past 1), the PNGs within 1 grey level on at least 99.9% of
  the pixels (the io/fixtures exporter's bounds, tests/test_torch_io.py),
  and the tree read by tools/process_imu.py; the CLI refuses CUDA without
  a card;
* tools/run_hardmode_matrix: cell_cmd gives every PLANNED tag the JAX
  runner's flags (script path aside, --device passed through),
  write_tables the JAX runner's table from the same cells, a cell in
  matrix.json is skipped without --force and run with it (subprocess.run
  stubbed by a writer of hardmode.json), a failed cell is recorded and
  retried; tools/assemble_hardmode_matrix collects the per-cell files.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import datasets as JD
from geoflowslam_tpu.utils.timers import StageTimers as JTimers

from geoflowslam_tpu_torch.tools import assemble_hardmode_matrix as TA
from geoflowslam_tpu_torch.tools import calibration_recorder as TR
from geoflowslam_tpu_torch.tools import run_hardmode_matrix as TM
from geoflowslam_tpu_torch.utils.timers import StageTimers

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """A module of the repo's tools/ directory, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- timers ------------------------------------------------------------------

def test_summary_lines_equal_to_jax():
    rng = np.random.default_rng(11)
    tj, tt = JTimers(), StageTimers()
    for stage in ("Track_total", "LBA", "New_KF", "ORB_extract", "Custom"):
        for v in rng.uniform(0, 50, rng.integers(1, 9)):
            tj.add(stage, float(v))
            tt.add(stage, float(v))
    # three stages with the same mean: insertion order decides
    for stage in ("tie_b", "tie_a", "tie_c"):
        for v in (2.0, 4.0):
            tj.add(stage, v)
            tt.add(stage, v)
    with tj.time("timed"):
        pass
    tt.add("timed", tj.samples["timed"][0])
    lines = tt.summary_lines()
    assert lines == tj.summary_lines()
    assert len(lines) == 9
    ties = [ln.split(":")[0] for ln in lines if ln.startswith("tie_")]
    assert ties == ["tie_b", "tie_a", "tie_c"]
    assert StageTimers().summary_lines() == []


# -- the calibration recorder ------------------------------------------------

def _numbers(path):
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                rows.append([float(v) for v in line.split(",")])
    return np.asarray(rows)


@pytest.mark.parametrize("static", [True, False], ids=["static", "moving"])
def test_calibration_recorder_equal_to_jax(tmp_path, static):
    jtool = _jax_tool("calibration_recorder")
    kw = dict(seconds=0.4, fps=10.0, imu_rate=200.0, seed=3, static=static)
    j, t = str(tmp_path / "j"), str(tmp_path / "t")
    jtool.record_synthetic(j, **kw)
    TR.record_synthetic(t, device="cpu", **kw)
    rel = lambda *p: os.path.join(*p)
    assert open(rel(j, "cam0", "times.txt")).read() == \
        open(rel(t, "cam0", "times.txt")).read()
    names = sorted(os.listdir(rel(j, "cam0", "data")))
    assert names == sorted(os.listdir(rel(t, "cam0", "data")))
    assert len(names) == 4
    for name in names:
        a = JD.load_image(rel(j, "cam0", "data", name))
        b = JD.load_image(rel(t, "cam0", "data", name))
        assert a.shape == b.shape == (240, 320)
        assert np.mean(np.abs(a - b) <= 1.0) >= 0.999, name
    ja, ta = rel(j, "imu0", "data.csv"), rel(t, "imu0", "data.csv")
    assert open(ja).readline() == open(ta).readline()
    if static:
        assert open(ja).read() == open(ta).read()
    else:
        a, b = _numbers(ja), _numbers(ta)
        assert a.shape == b.shape == (80, 7)
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-6)
    # the tree feeds tools/process_imu.py as it is
    proc = _jax_tool("process_imu")
    stamps, gyro, acc, rate = proc.load_euroc_imu(t)
    assert len(stamps) == 80 and gyro.shape == acc.shape == (80, 3)
    assert abs(rate - 200.0) < 1e-6


@pytest.mark.skipif(torch.cuda.is_available(), reason="has a card")
def test_calibration_recorder_needs_the_card_unless_told(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.main(["--out", str(tmp_path / "c"), "--seconds", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.main(["--out", str(tmp_path / "m"), "--cells", "rgbd"])
    assert not os.path.exists(tmp_path / "m")


# -- the hard-mode matrix runner ---------------------------------------------

def _flags(cmd):
    """A command line without the interpreter, the script and --device."""
    out = list(cmd[2:])
    if "--device" in out:
        i = out.index("--device")
        del out[i:i + 2]
    return out


def test_cell_cmd_equal_to_jax():
    jtool = _jax_tool("run_hardmode_matrix")
    assert TM.PLANNED == jtool.PLANNED
    for tag in TM.PLANNED:
        jc = jtool.cell_cmd(tag, 300, "results_x")
        tc = TM.cell_cmd(tag, 300, "results_x", "cuda:1")
        assert _flags(tc) == _flags(jc), tag
        assert tc[:2] == [sys.executable, TM.SCRIPT]
        assert tc[-2:] == ["--device", "cuda:1"]
    assert TM.cell_cmd("rgbd_of_icp_loop", 60, "o")[2:] == [
        "--mode", "rgbd", "--frames", "60", "--out", "o/rgbd_of_icp_loop",
        "--loop", "--of", "--icp", "--device", "cuda"]


def _cell(tag, fps=2.0, device="NVIDIA H100 80GB HBM3"):
    return {"tag": tag, "cmd": f"run {tag}", "fps": fps,
            "ate_rmse_m": 0.0123, "rpe_trans_m": 0.0045, "rpe_rot_deg": 0.21,
            "kf_cost_early_ms": 120.5, "kf_cost_late_ms": 130.25,
            "map": {"n_maps": 1, "state": "OK"}, "device": device}


def test_write_tables_equal_to_jax(tmp_path):
    jtool = _jax_tool("run_hardmode_matrix")
    cells = {"rgbd_of_icp": _cell("rgbd_of_icp"), "zz_extra": _cell(
        "zz_extra", 1.0), "rgbd": _cell("rgbd", 3.0),
        "mono": {"tag": "mono", "error": 1, "cmd": "run mono"}}
    tj = jtool.write_tables(cells, str(tmp_path / "j"))
    tt = TM.write_tables(cells, str(tmp_path / "t"))
    assert tt == tj
    assert len(tt.split("\n")) == 6 and "FAILED rc=1" in tt
    for name in ("matrix.md", "matrix.json"):
        assert (tmp_path / "j" / name).read_text() == \
            (tmp_path / "t" / name).read_text()


def _stub_run(calls, fail=()):
    """subprocess.run for run_hardmode.py: writes the cell's hardmode.json
    (or fails for the tags in `fail`)."""
    def run(cmd, cwd=None, stdout=None, stderr=None, text=None):
        calls.append(cmd)
        out = cmd[cmd.index("--out") + 1]
        tag = os.path.basename(out)

        class R:
            returncode = 3 if tag in fail else 0
        if tag not in fail:
            path = out if os.path.isabs(out) else os.path.join(cwd, out)
            os.makedirs(path, exist_ok=True)
            d = _cell(tag)
            del d["tag"], d["cmd"]
            with open(os.path.join(path, "hardmode.json"), "w") as f:
                json.dump(dict(d, mode=tag.split("_")[0], frames=60), f)
        stdout.write("log of " + tag)
        return R()
    return run


def test_matrix_resumes_and_persists(tmp_path, monkeypatch):
    out = str(tmp_path / "mx")
    calls = []
    monkeypatch.setattr(TM.subprocess, "run",
                        _stub_run(calls, fail={"mono"}))
    argv = ["--out", out, "--frames", "60", "--device", "cpu"]
    cells = TM.main(argv + ["--cells", "rgbd,mono"])
    assert [os.path.basename(c[c.index("--out") + 1]) for c in calls] == [
        "rgbd", "mono"]
    assert cells["mono"]["error"] == 3 and "error" not in cells["rgbd"]
    assert cells["rgbd"]["device"] == "NVIDIA H100 80GB HBM3"
    assert cells["rgbd"]["cmd"].endswith("--device cpu")
    assert open(os.path.join(out, "rgbd.log")).read() == "log of rgbd"
    rows = {d["tag"]: d for d in json.load(open(os.path.join(out,
                                                             "matrix.json")))}
    assert set(rows) == {"rgbd", "mono"}

    # the cached cell is skipped, the failed one retried
    calls.clear()
    monkeypatch.setattr(TM.subprocess, "run", _stub_run(calls))
    cells = TM.main(argv + ["--cells", "rgbd,mono"])
    assert [os.path.basename(c[c.index("--out") + 1]) for c in calls] == [
        "mono"]
    assert "error" not in cells["mono"]
    calls.clear()
    TM.main(argv + ["--cells", "rgbd", "--force"])
    assert len(calls) == 1

    # the assembler collects the per-cell files that are there
    os.remove(os.path.join(out, "matrix.json"))
    got = TA.main(["--out", out])
    assert sorted(got) == ["mono", "rgbd"]
    rows = json.load(open(os.path.join(out, "matrix.json")))
    assert {d["tag"] for d in rows} == {"mono", "rgbd"}
    assert all(d["device"] == "NVIDIA H100 80GB HBM3" for d in rows)
    assert "| run (command) |" in open(os.path.join(out, "matrix.md")).read()
    with pytest.raises(SystemExit):
        TA.main(["--out", str(tmp_path / "empty")])
