"""The frame step's eigensolvers that never wait for the device
(geoflowslam_tpu_torch/math/sym_eig.py) against torch.linalg.eigh and
torch.linalg.svd on the CPU, on inputs made from a numpy seed: random SPD
matrices over a wide range of conditioning, near-singular and slightly
indefinite ones, and repeated eigenvalues; and the two places that take
them on the frame step's path against their eigh-based forms:
solvers/inertial.sanitize_info (the marginal's PSD clamp, a fixed-sweep
Jacobi) and ops/gicp.build_ndt_grid (the NDT voxel covariances, the 3x3
closed form)."""
import numpy as np
import pytest
import torch

from geoflowslam_tpu_torch.math import sym_eig as SE
from geoflowslam_tpu_torch.ops import gicp as G
from geoflowslam_tpu_torch.solvers import inertial as VI


def _sym(n, b, seed, cond=1e4, kind="spd"):
    """[b, n, n] float64 symmetric matrices: random orthonormal bases with
    log-uniform eigenvalues up to `cond`; "singular" puts the smallest at
    1e-9 of the largest and the next at -1e-7 of it (slightly indefinite);
    "repeated" makes the two smallest equal."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, n, n)))
    ev = np.exp(rng.uniform(0.0, np.log(cond), (b, n)))
    if kind == "singular":
        ev[:, 0] = 1e-9 * ev.max(1)
        ev[:, 1] = -1e-7 * ev.max(1)
    elif kind == "repeated":
        ev[:, 1] = ev[:, 0]
    return torch.from_numpy(np.einsum("bij,bj,bkj->bik", q, ev, q))


def _recon(vals, vecs):
    return vecs @ torch.diag_embed(vals) @ vecs.transpose(-1, -2)


@pytest.mark.parametrize("kind", ["spd", "singular", "repeated"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eigh3_matches_eigh(kind, dtype):
    a = _sym(3, 4000, 1, cond=1e4, kind=kind).to(dtype)
    vals, vecs = SE.eigh3(a)
    ref, _ = torch.linalg.eigh(a.double())
    scale = a.double().abs().amax((1, 2))
    # the trigonometric method in float64 keeps ~sqrt(eps) near a double
    # eigenvalue; either way far below float32 inputs' own rounding
    tol = 2e-6 if dtype == torch.float32 else 1e-7
    assert vals.dtype == dtype and vecs.dtype == dtype
    assert ((vals.double() - ref).abs().amax(1) / scale).max() < tol
    assert ((_recon(vals, vecs).double() - a.double()).abs().amax((1, 2))
            / scale).max() < tol
    eye = torch.eye(3, dtype=torch.float64)
    assert (vecs.double().transpose(1, 2) @ vecs.double() - eye).abs().max() \
        < (1e-6 if dtype == torch.float32 else 1e-12)


def test_eigh3_isotropic_and_zero():
    """An isotropic matrix gives the identity basis; the zero matrix zero
    eigenvalues and an orthonormal basis."""
    a = torch.stack([2.5 * torch.eye(3), torch.zeros(3, 3)])
    vals, vecs = SE.eigh3(a)
    assert torch.allclose(vals, torch.tensor([[2.5] * 3, [0.0] * 3]))
    assert torch.allclose(vecs[0], torch.eye(3))
    assert torch.allclose(vecs[1].T @ vecs[1], torch.eye(3), atol=1e-6)


@pytest.mark.parametrize("kind", ["spd", "singular", "repeated"])
@pytest.mark.parametrize("n", [6, 9, 12, 15])
def test_eigh_jacobi_matches_eigh(n, kind):
    a = _sym(n, 40, 2 + n, cond=1e8, kind=kind)
    vals, vecs = SE.eigh_jacobi(a)
    ref, ref_vecs = torch.linalg.eigh(a)
    scale = a.abs().amax((1, 2))
    # JACOBI_SWEEPS float64 sweeps: ~1e-8 of the norm at n = 15 and cond
    # 1e8 (1e-14 at n <= 12), far below the float32 the callers keep
    assert ((vals - ref).abs().amax(1) / scale).max() < 5e-8
    assert ((_recon(vals, vecs) - a).abs().amax((1, 2)) / scale).max() < 5e-8
    eye = torch.eye(n, dtype=torch.float64)
    assert (vecs.transpose(1, 2) @ vecs - eye).abs().max() < 1e-12
    if kind == "spd":
        # well-separated eigenvalues: the same vectors up to sign
        dots = torch.abs(torch.sum(vecs * ref_vecs, dim=1))
        assert (dots - 1.0).abs().max() < 1e-6


def test_sanitize_info_matches_the_eigh_clamp():
    """The marginal's PSD clamp (float64 Jacobi) against eigh's on 15x15
    float32 informations spanning 1e2 to 1e8, slightly indefinite."""
    for seed in range(6):
        a = _sym(15, 1, 30 + seed, cond=1e6, kind="singular")[0] * 1e2
        info = a.float()
        got = VI.sanitize_info(info)
        sym = 0.5 * (info + info.T)
        ev, vec = torch.linalg.eigh(sym.double())
        want = (vec * torch.clamp_min(ev, 0.0)[None, :]) @ vec.T
        assert (got.double() - want).abs().max() < 1e-6 * want.abs().max()
        assert torch.linalg.eigvalsh(got.double()).min() \
            > -1e-6 * want.abs().max()
    bad = torch.full((15, 15), float("nan"))
    assert torch.equal(VI.sanitize_info(bad), torch.zeros(15, 15))


def _ndt_reference(tgt, valid, resolution, max_voxels=2048):
    """build_ndt_grid with torch.linalg.eigh (the port's form before the
    closed form)."""
    key = G.pc._voxel_keys(tgt, valid, resolution)
    order = torch.argsort(key, stable=True)
    ks, pts_s = key[order], tgt[order]
    first = torch.cat([torch.ones((1,), dtype=torch.bool), ks[1:] != ks[:-1]])
    seg = torch.clamp(torch.cumsum(first.long(), 0) - 1, 0, max_voxels - 1)
    w = (ks != G.pc.INVALID_KEY).to(tgt.dtype)

    def seg_sum(x):
        return torch.zeros((max_voxels,) + tuple(x.shape[1:]),
                           dtype=tgt.dtype).index_add_(0, seg, x)
    cnt = seg_sum(w)
    mean = seg_sum(pts_s * w[:, None]) / torch.clamp_min(cnt[:, None], 1.0)
    d = pts_s - mean[seg]
    cov = seg_sum(torch.einsum("p,pi,pj->pij", w, d, d))
    cov = cov / torch.clamp_min(cnt[:, None, None], 1.0)
    vals, vecs = torch.linalg.eigh(cov)
    vals_r = torch.maximum(vals, torch.clamp_min(vals[:, 2:3] * 1e-2, 1e-6))
    cov_r = torch.einsum("vij,vj,vkj->vik", vecs, vals_r, vecs)
    inv = torch.linalg.inv_ex(cov_r + 1e-9 * torch.eye(3))[0]
    vvalid = cnt >= 5.0
    return mean, inv * vvalid[:, None, None], vvalid


def test_ndt_grid_matches_the_eigh_form():
    """Voxel covariances of planar, linear and blob-like patches (near-
    singular 3x3 matrices) and random points: the same information
    matrices as the eigh form, within 1e-4 of each voxel's largest."""
    rng = np.random.default_rng(7)
    plane = np.c_[rng.uniform(0, 2, (1500, 2)), 1e-4 * rng.standard_normal(
        1500)]
    line = np.c_[rng.uniform(0, 2, 800), 1e-4 * rng.standard_normal(
        (800, 2))] + [0.0, 3.0, 0.0]
    blob = rng.standard_normal((1200, 3)) * 0.3 + [4.0, 0.0, 1.0]
    pts = torch.from_numpy(np.concatenate([plane, line, blob])
                           .astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=len(pts)) > 0.05)
    mean, inv, vv = G.build_ndt_grid(pts, valid, 0.5)
    rmean, rinv, rvv = _ndt_reference(pts, valid, 0.5)
    assert torch.equal(vv, rvv) and int(vv.sum()) > 20
    assert torch.allclose(mean, rmean)
    scale = torch.clamp_min(rinv.abs().amax((1, 2)), 1e-12)
    assert ((inv - rinv).abs().amax((1, 2)) / scale)[vv].max() < 1e-4


def test_null_vector_and_svd3_match_svd():
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.standard_normal((64, 8, 9)).astype(np.float32))
    v = SE.null_vector(a)
    ref = torch.linalg.svd(a.double(), full_matrices=True)[2][:, 8]
    assert (torch.abs(torch.sum(v.double() * ref, 1)) - 1.0).abs().max() \
        < 1e-5
    m = torch.from_numpy(rng.standard_normal((200, 3, 3)))
    u, s, vt = SE.svd3(m)
    u2, s2, vt2 = torch.linalg.svd(m)
    assert torch.allclose(s, s2, atol=1e-10)
    assert torch.allclose(u @ torch.diag_embed(s) @ vt, m, atol=1e-10)
    r2 = SE.drop_smallest_singular3(m)
    want = u2 @ torch.diag_embed(torch.cat([s2[:, :2], 0 * s2[:, 2:]], 1)) \
        @ vt2
    assert torch.allclose(r2, want, atol=1e-10)
