"""Port parity of the point-cloud registration stack (ops/pointcloud.py,
ops/gicp.py) on two depth clouds of the synthetic room, 0.2 s apart
(320x240, stride 8, 5 cm voxels, then 256 padding slots appended):
brute-force kNN, the GICP covariances and the closed-form 3x3 helpers,
GICP and NDT registration. Clouds are made by the JAX package and handed to
both sides as numpy arrays.

Tolerances: kNN indices equal on all but 0.5% of the queries (a matmul in
another order can swap near-equidistant targets) and squared distances
within 1e-5 m^2; covariances within 1e-5 and normals parallel within 1e-4;
registrations within 1e-4 m and 1e-4 in each rotation entry, the inlier
count within 2 and `converged` equal (both are fixed-count Gauss-Newton on
float32 sums taken in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops import gicp as JG
from geoflowslam_tpu.ops import pointcloud as JP

from geoflowslam_tpu_torch.ops import gicp as TG
from geoflowslam_tpu_torch.ops import pointcloud as TP

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0


@pytest.fixture(scope="module")
def clouds():
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=5.0)
    out = []
    for t in (0.0, 0.2):
        _, depth, _ = seq.frame(t)
        pts, mask = JP.depth_to_cloud(depth, FX, FX, W / 2, H / 2, stride=8)
        c, v = JP.voxel_downsample(pts, mask, 0.05, 1536)
        out.append((np.concatenate([np.asarray(c), np.zeros((256, 3))])
                    .astype(np.float32),
                    np.concatenate([np.asarray(v), np.zeros(256, bool)])))
    (c0, v0), (c1, v1) = out
    assert 0 < v0.sum() < len(v0) and 0 < v1.sum() < len(v1)
    return c0, v0, c1, v1


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [1, 10])
def test_knn_matches_reference(clouds, k):
    c0, v0, c1, v1 = clouds
    ij, dj, oj = (np.asarray(x) for x in JP.knn_indices(
        jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c0), jnp.asarray(v0), k))
    it, dt, ot = (x.numpy() for x in TP.knn_indices(_t(c1), _t(v1), _t(c0),
                                                      _t(v0), k))
    assert it.shape == (len(c1), k) and np.array_equal(oj, ot)
    assert (ij[v1] != it[v1]).any(axis=1).mean() <= 0.005
    np.testing.assert_allclose(dt[v1], dj[v1], atol=1e-5)
    assert np.all(np.diff(dt[v1], axis=1) >= 0)


def test_covariances_match_reference(clouds):
    c0, v0, _, _ = clouds
    cj, nj = (np.asarray(x) for x in JP.estimate_covariances(
        jnp.asarray(c0), jnp.asarray(v0), 10))
    ct, nt = (x.numpy() for x in TP.estimate_covariances(_t(c0), _t(v0), 10))
    np.testing.assert_allclose(ct[v0], cj[v0], atol=1e-5)
    assert np.abs(np.sum(nj * nt, axis=1))[v0].min() > 1 - 1e-4


def test_sym3_helpers_match_reference():
    rs = np.random.RandomState(0)
    a = rs.randn(64, 3, 3).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32) * 1e-3
    a[0] = np.eye(3)                              # isotropic: +z fallback
    np.testing.assert_allclose(TP.sym3_eigvals(_t(a)).numpy(),
                               np.asarray(JP.sym3_eigvals(jnp.asarray(a))),
                               atol=1e-4, rtol=1e-4)
    vj = np.asarray(JP.smallest_eigvec_sym3(jnp.asarray(a)))
    vt = TP.smallest_eigvec_sym3(_t(a)).numpy()
    assert np.abs(np.sum(vj * vt, axis=1)).min() > 1 - 1e-4
    np.testing.assert_allclose(TG._inv_sym3(_t(a)).numpy(),
                               np.asarray(JG._inv_sym3(jnp.asarray(a))),
                               rtol=1e-4, atol=1e-3)
    rot, tr = _t(np.eye(3, dtype=np.float32)[[1, 2, 0]]), _t([1.0, 2.0, 3.0])
    np.testing.assert_allclose(
        TP.transform_cloud(rot, tr, _t(a[:, 0])).numpy(),
        np.asarray(JP.transform_cloud(rot.numpy(), tr.numpy(), a[:, 0])))


def _assert_registration_close(rj, rt):
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    np.testing.assert_allclose(rt.rot.numpy(), np.asarray(rj.rot), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert bool(rt.converged) == bool(rj.converged)
    assert abs(float(rt.error) - float(rj.error)) < 1e-4


@pytest.mark.parametrize("method", ["gicp", "ndt"])
def test_registration_matches_reference(clouds, method):
    c0, v0, c1, v1 = clouds
    jfn = JG.gicp_register if method == "gicp" else JG.ndt_register
    tfn = TG.gicp_register if method == "gicp" else TG.ndt_register
    rj = jax.jit(jfn)(jnp.asarray(c1), jnp.asarray(v1), jnp.asarray(c0),
                      jnp.asarray(v0))
    rt = tfn(_t(c1), _t(v1), _t(c0), _t(v0))
    _assert_registration_close(rj, rt)
    assert bool(rt.converged) and int(rt.n_inliers) > 500
    # the camera moved: the registration found a non-zero motion
    assert float(torch.linalg.norm(rt.t)) > 0.01
