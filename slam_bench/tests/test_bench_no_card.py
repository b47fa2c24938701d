"""run.py fails, printing no result, without a CUDA card and in a
directory holding only BENCHMARK.json and slam_bench/."""
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "tum1_rgbd.handheld", "--seed", "5000000000",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    import os
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "slam_bench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_fails_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # past the look for a card, the run stops at the missing program
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from slam_bench import cell\n"
            "spec = cell.find_cell(cell.load_manifest(), "
            "'tum1_rgbd.handheld')\n"
            "cell.run_cell(spec, 5, 1.0, False, time.perf_counter(), "
            "device='cpu')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "geoflowslam_tpu_torch" in out.stderr
