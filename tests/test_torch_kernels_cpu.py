"""The port's kernel plumbing without a card: CPU tensors take the plain
versions and never touch a kernel, CUDA requests without CUDA raise, the
kernel sources are in the repository, their build directory is ignored by
git, and the kernel module imports on a machine without nvcc."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops import fast as F
from geoflowslam_tpu_torch.ops import klt as KLT
from geoflowslam_tpu_torch.ops import matching as MA
from geoflowslam_tpu_torch.pipeline.system import SlamSystem

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _forbid_kernels(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a kernel launcher was called for CPU tensors")
    monkeypatch.setattr(kernels, "fast_scores", boom)
    monkeypatch.setattr(kernels, "gated_hamming_search", boom)
    monkeypatch.setattr(kernels, "lk_level", boom)
    monkeypatch.setattr(kernels, "load", boom)


def test_cpu_tensors_dispatch_to_plain(monkeypatch):
    _forbid_kernels(monkeypatch)
    kernels.reset_launch_counts()
    rs = np.random.RandomState(0)
    img = torch.from_numpy((rs.rand(61, 77) * 255).astype(np.float32))
    lo, hi = F.fast_scores_two(img, 7.0, 20.0)
    ref = F.fast_score_maps(img, [7.0, 20.0])
    assert torch.equal(lo, ref[0]) and torch.equal(hi, ref[1])
    n, m = 50, 40
    args = (torch.from_numpy((rs.rand(n, 2) * 50).astype(np.float32)),
            torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
            torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, (n, 8),
                                        dtype=np.int64).astype(np.int32)),
            torch.full((n,), 8.0),
            torch.from_numpy((rs.rand(m, 2) * 50).astype(np.float32)),
            torch.zeros(m, dtype=torch.int32), torch.ones(m, dtype=torch.bool),
            torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, (m, 8),
                                        dtype=np.int64).astype(np.int32)))
    got = MA.gated_hamming(*args, -1, 1)
    want = MA.gated_hamming_plain(*args, -1, 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    pts = torch.from_numpy((rs.rand(30, 2) * 60).astype(np.float32))
    got = KLT.track_level(img, img, pts, pts + 0.5, 21, 5, 1e-4)
    want = KLT._track_level(img, img, pts, pts + 0.5, 21, 5, 1e-4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kernels.launch_counts == {"fast_scores": 0,
                                     "gated_hamming_search": 0,
                                     "lk_level": 0}


def test_launchers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_scores(torch.zeros(8, 8), 7.0, 20.0)
    z2, zi = torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gated_hamming_search(
            z2, zi, zi.bool(), torch.zeros(4, 8, dtype=torch.int32),
            torch.zeros(4), z2, zi, zi.bool(),
            torch.zeros(4, 8, dtype=torch.int32), -1, 1, MA.BIG)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lk_level(torch.zeros(8, 8), torch.zeros(8, 8), z2, z2, 21, 10,
                         1e-4)


def test_cuda_system_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = C.SystemConfig(frame=C.FrameConfig(orb=C.OrbConfig(
        n_features=100, n_levels=2, height=64, width=64)), k_max=4, m_max=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamSystem(cfg, device="cuda")


def test_unported_options_raise():
    for kw in (dict(use_lidar=True), dict(imu=object())):
        with pytest.raises(NotImplementedError):
            SlamSystem(C.SystemConfig(k_max=4, m_max=64, **kw), "cpu")


def test_sources_and_build_dir():
    for src in kernels.SOURCES:
        text = (kernels.CSRC_DIR / src).read_text()
        assert "sm_90a" in text and 'extern "C"' in text
    rel = kernels.BUILD_DIR.relative_to(REPO).as_posix()
    ignored = (REPO / ".gitignore").read_text().split()
    assert rel + "/" in ignored or rel in ignored
    assert kernels.library_path().parent == kernels.BUILD_DIR
    assert "-gencode=arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_kernel_module_imports_without_nvcc(monkeypatch, tmp_path):
    code = ("import geoflowslam_tpu_torch.kernels as K, "
            "geoflowslam_tpu_torch.pipeline.system, "
            "geoflowslam_tpu_torch.convert; print(K.launch_counts)")
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(REPO),
           "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "CUDA_NVCC", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels._find_nvcc()
