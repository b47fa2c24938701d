"""The port's quick-start drivers (geoflowslam_tpu_torch/tools/
run_synthetic.py, evaluate_ate.py, train_vocab.py) against the JAX
package's (examples/run_synthetic.py, examples/evaluate_ate.py,
tools/train_vocab.py), on the CPU at small sizes:

* run_synthetic --mode rgbd, 320x240, 8 frames at 30 fps, --t0 1.4e9 (the
  epoch-scale stamps): the same report lines and the same files under
  --out; the trajectories' stamps equal and positions within 2 cm. Also
  --mode mono and stereo through the port alone (finite poses, files).
* evaluate_ate on the port's CameraTrajectory.txt against a ground truth
  written from the sequence: the JAX CLI prints the same report, number
  for number, with and without --scale.
* train_vocab --frames 3 --k 3 --levels 2 --iters 1 at the JAX tool's
  640x480: the same npz keys, shapes and dtypes; JAX's load_vocabulary
  reads the port's file.

The JAX drivers run in this process with their persistent-cache setup
switched off (it would repoint this process's compile cache)."""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from geoflowslam_tpu.retrieval import vocab as JV
from geoflowslam_tpu.utils import compile_log

from geoflowslam_tpu_torch.io import trajectory as TT
from geoflowslam_tpu_torch.io.synthetic import (Camera, SyntheticSequence,
                                                SyntheticWorld)
from geoflowslam_tpu_torch.retrieval import vocab as TV
from geoflowslam_tpu_torch.tools import evaluate_ate, run_synthetic, \
    train_vocab

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "320", "--height", "240", "--fps", "30"]


def _jax_main(script, argv, monkeypatch, capsys):
    """Run a JAX driver as `python <script> argv...`; returns its stdout."""
    monkeypatch.setattr(compile_log, "enable_persistent_cache",
                        lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [script] + argv)
    capsys.readouterr()
    runpy.run_path(os.path.join(ROOT, script), run_name="__main__")
    return capsys.readouterr().out


def _report(out: str):
    """The report's lines without the wall-clock figures."""
    return [ln.split(" in ")[0] if "FPS" in ln else ln
            for ln in out.strip().splitlines()]


def _write_gt(path, n, fps, t0, w=320, h=240):
    cam = Camera(fx=w * 0.625, fy=w * 0.625, cx=w / 2, cy=h / 2, width=w,
                 height=h)
    seq = SyntheticSequence(SyntheticWorld(cam, device="cpu"), fps=fps)
    rows = []
    for i in range(n):
        rot_cw, t_cw = seq.pose_cw(i / fps)
        rwc = rot_cw.numpy().astype(np.float64).T
        twc = np.eye(4)
        twc[:3, :3] = rwc
        twc[:3, 3] = -rwc @ t_cw.numpy().astype(np.float64)
        rows.append((t0 + i / fps, twc))
    TT.save_trajectory_tum(path, rows)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tmp_path_factory.mktemp("quickstart")


def test_run_synthetic_and_evaluate_ate_match_jax(runs, monkeypatch,
                                                  capsys):
    argv = ["--mode", "rgbd", "--frames", "8", "--t0", "1.4e9"] + SMALL
    jout = str(runs / "jax")
    jrep = _jax_main("examples/run_synthetic.py", argv + ["--out", jout],
                     monkeypatch, capsys)
    tout = str(runs / "port")
    res = run_synthetic.main(argv + ["--out", tout, "--device", "cpu"])
    trep = capsys.readouterr().out
    assert res["stats"]["state"] == "OK"
    assert [ln.split(":")[0].split(" ")[0] for ln in _report(trep)] == [
        ln.split(":")[0].split(" ")[0] for ln in _report(jrep)]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    cam = "CameraTrajectory.txt"
    tj = TT.load_trajectory_tum(os.path.join(jout, cam))
    tp = TT.load_trajectory_tum(os.path.join(tout, cam))
    assert [round(t, 4) for t, _ in tp] == [round(t, 4) for t, _ in tj]
    assert tp[0][0] > 1e9
    for (_, a), (_, b) in zip(tp, tj):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) < 0.02

    gt = str(runs / "gt.txt")
    _write_gt(gt, 8, 30.0, 1.4e9)
    est = os.path.join(tout, cam)
    for extra in ([], ["--scale"]):
        jrep = _jax_main("examples/evaluate_ate.py", [est, gt] + extra,
                         monkeypatch, capsys)
        m = evaluate_ate.main([est, gt] + extra)
        assert capsys.readouterr().out == jrep
        assert m["n_pairs"] == 8 and m["ate_rmse"] < 0.02


@pytest.mark.parametrize("mode", ["mono", "stereo"])
def test_run_synthetic_modes(runs, mode):
    out = str(runs / mode)
    res = run_synthetic.main(["--mode", mode, "--frames", "6", "--out", out,
                              "--device", "cpu"] + SMALL)
    slam = res["slam"]
    assert slam.n_frames == 6
    assert np.all(np.isfinite(slam.current_pose_wc()))
    assert os.path.exists(os.path.join(out, "CameraTrajectory.txt"))
    assert run_synthetic.parse_args([]).device == "cuda"


def test_train_vocab_matches_jax(runs, monkeypatch, capsys):
    argv = ["--frames", "3", "--k", "3", "--levels", "2", "--iters", "1"]
    jp, tp = str(runs / "jv.npz"), str(runs / "tv.npz")
    _jax_main("tools/train_vocab.py", argv + ["--out", jp], monkeypatch,
              capsys)
    voc = train_vocab.main(argv + ["--out", tp, "--device", "cpu"])
    with np.load(jp) as zj, np.load(tp) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for f in zj.files:
            assert zj[f].shape == zt[f].shape, f
            assert zj[f].dtype == zt[f].dtype, f
    ref = JV.load_vocabulary(tp)
    assert (ref.k, ref.levels) == (voc.k, voc.levels) == (3, 2)
    for a, b in zip(voc.centers, ref.centers):
        np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                      np.asarray(b))
    back = TV.load_vocabulary(tp, "cpu")
    assert torch.equal(back.weights, voc.weights)
