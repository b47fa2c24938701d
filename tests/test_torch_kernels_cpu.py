"""The port's kernel plumbing without a card: CPU tensors take the plain
versions and never touch a kernel, CUDA requests without CUDA raise, the
kernel sources are in the repository, their build directory is ignored by
git, and the kernel module imports on a machine without nvcc. K4's plain
version (the ungated best-two search), match_descriptors and the batched
match_descriptors_many are exact against the JAX package's XLA path."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import matching as JM

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
    for name in list(kernels.launch_counts) + ["load"]:
        monkeypatch.setattr(kernels, name, boom)


def test_cpu_tensors_dispatch_to_plain(monkeypatch):
    _forbid_kernels(monkeypatch)
    kernels.reset_launch_counts()
    rs = np.random.RandomState(0)
    img = torch.from_numpy((rs.rand(61, 77) * 255).astype(np.float32))
    lo, hi = F.fast_scores_two(img, 7.0, 20.0)
    ref = F.fast_score_maps(img, [7.0, 20.0])
    assert torch.equal(lo, ref[0]) and torch.equal(hi, ref[1])
    got = F.fast_nms_levels([img, img[:40, :50]], 7.0, 20.0)
    want = F.fast_nms_levels_plain([img, img[:40, :50]], 7.0, 20.0)
    for a, b in zip(got, want):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
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
    kw = dict(fb_thresh=0.5, win=9, iters=3)
    r, = KLT.fb_klt_track_streams([img], [img], pts, [pts + 0.5], [1], **kw)
    want = KLT.fb_klt_track([img], [img], pts, pts + 0.5, max_levels=1, **kw)
    for a, b in zip(r, want):
        assert torch.equal(a, b)
    dq, vq, dt, vt = (T(x) for x in _k4_inputs(40, 60, seed=1))
    got = MA.hamming_best2(dq, vq, dt, vt)
    want = MA.hamming_best2_plain(dq, vq, dt, vt)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    MA.match_descriptors(dq, vq, dt, vt, mutual=True)
    assert kernels.launch_counts == {
        "fast_scores": 0, "fast_nms_levels": 0, "gated_hamming_search": 0,
        "lk_level": 0, "lk_pyramid": 0, "hamming_best2": 0}


def test_launchers_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_scores(torch.zeros(8, 8), 7.0, 20.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fast_nms_levels([torch.zeros(8, 8), torch.zeros(7, 5)], 7.0,
                                20.0, 16)
    z2, zi = torch.zeros(4, 2), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gated_hamming_search(
            z2, zi, zi.bool(), torch.zeros(4, 8, dtype=torch.int32),
            torch.zeros(4), z2, zi, zi.bool(),
            torch.zeros(4, 8, dtype=torch.int32), -1, 1, MA.BIG)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hamming_best2(torch.zeros(4, 8, dtype=torch.int32), zi.bool(),
                              torch.zeros(4, 8, dtype=torch.int32), zi.bool(),
                              MA.BIG)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hamming_best2_many(
            [(torch.zeros(4, 8, dtype=torch.int32), zi.bool(),
              torch.zeros(3, 8, dtype=torch.int32), zi[:3].bool())] * 2,
            MA.BIG)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lk_level(torch.zeros(8, 8), torch.zeros(8, 8), z2, z2, 21, 10,
                         1e-4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.lk_pyramid([torch.zeros(8, 8)], [torch.zeros(8, 8)],
                           torch.zeros(2, 4, 2), torch.zeros(2, 4, 2), [1, 1],
                           1, 2.0, 0.5, 21, 10, 1e-4)


@pytest.mark.parametrize("bad", ["no_levels", "too_many_levels", "border",
                                 "stream_levels", "pts_shape", "pyramids",
                                 "no_searches", "too_many_searches",
                                 "search_arity", "search_shape"])
def test_fused_launchers_reject_bad_arguments(bad):
    """Malformed level lists, stream tables and search tables raise before
    any build or launch (no card is needed to see it)."""
    img = torch.zeros(8, 8)
    d4, v4 = torch.zeros(4, 8, dtype=torch.int32), torch.ones(4, dtype=torch.bool)
    lk = dict(pyr_prev=[img], pyr_next=[img], pts=torch.zeros(2, 4, 2),
              guess=torch.zeros(2, 4, 2), levels=[1, 1], fb_levels=1,
              scale_factor=2.0, fb_thresh=0.5, win=21, iters=10,
              min_eig=1e-4)
    match = {"no_searches": "0 searches", "too_many_searches": "65 searches",
             "search_arity": "expected 4", "search_shape": "shape"}
    with pytest.raises(ValueError, match=match.get(bad)):
        if bad == "no_levels":
            kernels.fast_nms_levels([], 7.0, 20.0, 16)
        elif bad == "too_many_levels":
            kernels.fast_nms_levels([img] * (kernels.FAST_MAX_LEVELS + 1),
                                    7.0, 20.0, 16)
        elif bad == "border":
            kernels.fast_nms_levels([img], 7.0, 20.0, -1)
        elif bad == "stream_levels":
            kernels.lk_pyramid(**dict(lk, levels=[1, 2]))
        elif bad == "pts_shape":
            kernels.lk_pyramid(**dict(lk, pts=torch.zeros(4, 2)))
        elif bad == "pyramids":
            kernels.lk_pyramid(**dict(lk, pyr_next=[img, img]))
        elif bad == "no_searches":
            kernels.hamming_best2_many([], MA.BIG)
        elif bad == "too_many_searches":
            kernels.hamming_best2_many(
                [(d4, v4, d4, v4)] * (kernels.K4_MAX_SEARCHES + 1), MA.BIG)
        elif bad == "search_arity":
            kernels.hamming_best2_many([(d4, v4, d4)], MA.BIG)
        else:
            kernels.hamming_best2_many([(d4[:, :4], v4, d4, v4)], MA.BIG)


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
    assert sorted(kernels.SOURCES) == sorted(
        p.name for p in kernels.CSRC_DIR.glob("*.cu"))
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


def T(a):
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _k4_inputs(n, m, seed, all_invalid_t=False):
    """Descriptors with ~25% invalid rows and columns, queries copied from
    targets and duplicated targets (ties on best and second); an all-invalid
    target set gives every row no valid pair."""
    rs = np.random.RandomState(seed)
    dq = rs.randint(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    dt = rs.randint(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    k = min(n, m) // 3
    dq[:k] = dt[rs.randint(0, m, k)]
    dt[m // 2:m // 2 + m // 6] = dt[:m // 6]
    j = min(10, n - k, m)
    dq[k:k + j] = dt[:j] ^ np.uint32(1 << 7)
    vq = rs.rand(n) > 0.25
    vt = np.zeros(m, bool) if all_invalid_t else rs.rand(m) > 0.25
    return dq, vq, dt, vt


K4_CASES = [(100, 120, False), (131, 77, False), (64, 200, True),
            (1, 3, False)]


@pytest.mark.parametrize("n,m,none_valid", K4_CASES)
def test_hamming_best2_plain_matches_jax(n, m, none_valid):
    """Best, second and argbest against JAX's hamming_matrix + BIG mask +
    _best_two, and the swapped search's argbest against jnp.argmin of the
    transpose, exact (ties to the lowest index, (BIG, BIG, 0) rows)."""
    dq, vq, dt, vt = _k4_inputs(n, m, seed=n + m, all_invalid_t=none_valid)
    dist = JM.hamming_matrix(jnp.asarray(dq), jnp.asarray(dt))
    invalid = (~jnp.asarray(vq)[:, None]) | (~jnp.asarray(vt)[None, :])
    dist = jnp.where(invalid, JM.BIG, dist)
    jb, js, ji = (np.asarray(x) for x in JM._best_two(dist))
    tb, ts, ti = MA.hamming_best2_plain(T(dq), T(vq), T(dt), T(vt))
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(ti.numpy(), ji)
    col = MA.hamming_best2_plain(T(dt), T(vt), T(dq), T(vq))[2]
    np.testing.assert_array_equal(col.numpy(),
                                  np.asarray(jnp.argmin(dist.T, axis=1)))
    if none_valid:
        assert (tb == MA.BIG).all() and (ts == MA.BIG).all()
        assert (ti == 0).all()
    assert int((tb == ts).sum()) > 0 or n < 10     # ties were exercised


@pytest.mark.parametrize("n,m,none_valid", K4_CASES)
@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_unmasked_matches_jax(n, m, none_valid, mutual):
    dq, vq, dt, vt = _k4_inputs(n, m, seed=3 * n + m,
                                all_invalid_t=none_valid)
    for max_dist, ratio in ((JM.TH_LOW, 0.85), (JM.TH_HIGH, 1.0)):
        ij, dj = JM.match_descriptors(
            jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt),
            jnp.asarray(vt), max_dist=max_dist, ratio=ratio, mutual=mutual)
        it, dtt = MA.match_descriptors(T(dq), T(vq), T(dt), T(vt),
                                       max_dist=max_dist, ratio=ratio,
                                       mutual=mutual)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dtt.numpy(), np.asarray(dj))


# (N, M, no valid target) of the three pairs of a batch: unequal sizes, one
# pair whose targets are all invalid
MANY_PAIRS = [(100, 120, False), (57, 40, True), (131, 77, False)]


@pytest.mark.parametrize("mutual", [False, True])
def test_match_descriptors_many_matches_per_pair_and_jax(mutual):
    """The batched entry's plain path equals match_descriptors on each pair
    and the JAX package's match_descriptors, exactly, with duplicated
    descriptors (ties on best and second)."""
    pairs = [_k4_inputs(n, m, seed=7 * n + m, all_invalid_t=none)
             for n, m, none in MANY_PAIRS]
    got = MA.match_descriptors_many([tuple(T(x) for x in p) for p in pairs],
                                    max_dist=JM.TH_LOW, ratio=0.85,
                                    mutual=mutual)
    assert len(got) == len(pairs)
    n_ties = 0
    for (dq, vq, dt, vt), (it, dtt) in zip(pairs, got):
        one = MA.match_descriptors(T(dq), T(vq), T(dt), T(vt),
                                   max_dist=JM.TH_LOW, ratio=0.85,
                                   mutual=mutual)
        assert torch.equal(it, one[0]) and torch.equal(dtt, one[1])
        ij, dj = JM.match_descriptors(
            jnp.asarray(dq), jnp.asarray(vq), jnp.asarray(dt),
            jnp.asarray(vt), max_dist=JM.TH_LOW, ratio=0.85, mutual=mutual)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(dtt.numpy(), np.asarray(dj))
        b, s, _ = MA.hamming_best2_plain(T(dq), T(vq), T(dt), T(vt))
        n_ties += int(((b == s) & (b < MA.BIG)).sum())
    assert n_ties > 0
    assert (got[1][0] == -1).all() and (got[0][0] >= 0).any()
