"""The port's stereo front end against the JAX package on the same inputs:
the camera models (math/cameras), triangulate_points, the rectified SAD
matcher and the stereo-fisheye matcher (ops/stereo), build_frame's
undistortion and depth-free branches, and the KB8 renderer.

Tolerances: the camera functions within 1e-5 (pixels 1e-4) and their
Jacobians within 1e-4 relative; stereo_match's valid masks equal on >= 99%
of the keypoints and u_right within 1e-3 px where both are valid;
build_frame's undistorted keypoints within 1e-3 px; the KB8 render's gray
within 1e-3 mean absolute and depth within 1e-5. Triangulation: the same
masks and match_idx; the points within 1e-4 (triangulate_points) and the
fisheye depths within 5e-4 relative. The 3x3 normal equations of a 0.1 m
baseline at 1.5-4.5 m are ill-conditioned (~3000): each package's float32
solution sits up to 1.6e-4 (relative) from the float64 solution of the
same equations, so both are also held within 3e-4 of that solution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.math import cameras as JCAM
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.math.triangulate import triangulate_points as j_tri
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.ops.stereo import fisheye_stereo_match as j_fisheye
from geoflowslam_tpu.ops.stereo import stereo_match as j_stereo
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.math import cameras as TCAM
from geoflowslam_tpu_torch.math.triangulate import triangulate_points
from geoflowslam_tpu_torch.ops import stereo as TST
from geoflowslam_tpu_torch.state.frame import build_frame

torch.set_num_threads(2)

KB8_L = (0.0035, 0.0007, -0.002, 0.0002)     # tests/test_stereo_fisheye.py
KB8_R = (0.0034, 0.0018, -0.0027, 0.0003)
RADTAN = (-0.28, 0.07, 2e-4, 1.8e-5, 0.0)    # EuRoC cam0-like
PIN = (190.0, 190.0, 160.0, 120.0)
W, H = 320, 240


def T(a):
    return torch.from_numpy(np.array(a))


def _points(n, seed):
    rs = np.random.RandomState(seed)
    return rs.uniform([-1.5, -1.0, 0.5], [1.5, 1.0, 4.5],
                      (n, 3)).astype(np.float32)


def _pixels(n, seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 2) * [W, H]).astype(np.float32)


CAMERA_CASES = [
    ("pinhole_project", JCAM.pinhole_project, TCAM.pinhole_project, PIN,
     "pts", 1e-4),
    ("pinhole_unproject", JCAM.pinhole_unproject, TCAM.pinhole_unproject,
     PIN, "px", 1e-5),
    ("kb8_project", JCAM.kb8_project, TCAM.kb8_project, PIN + KB8_L, "pts",
     1e-4),
    ("kb8_unproject", JCAM.kb8_unproject, TCAM.kb8_unproject, PIN + KB8_L,
     "px", 1e-5),
    ("radtan_distort", JCAM.radtan_distort, TCAM.radtan_distort, RADTAN,
     "xy", 1e-5),
    ("radtan_undistort", JCAM.radtan_undistort, TCAM.radtan_undistort,
     RADTAN, "xy", 1e-5),
]


@pytest.mark.parametrize("name,jf,tf,params,kind,tol", CAMERA_CASES,
                         ids=[c[0] for c in CAMERA_CASES])
def test_camera_function(name, jf, tf, params, kind, tol):
    if kind == "pts":
        x = _points(500, 1)
    elif kind == "px":
        x = _pixels(500, 2)
    else:
        x = ((_pixels(500, 3) - [160, 120]) / 190.0).astype(np.float32)
    want = np.asarray(jf(jnp.asarray(params, jnp.float32), jnp.asarray(x)))
    got = tf(params, T(x)).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("model", [TCAM.PINHOLE, TCAM.KB8])
def test_camera_dispatch_and_jacobian(model):
    params = PIN if model == TCAM.PINHOLE else PIN + KB8_L
    jp = jnp.asarray(params + (0.0,) * (8 - len(params)), jnp.float32)
    pts = _points(300, 4)
    px = _pixels(300, 5)
    np.testing.assert_allclose(
        TCAM.project(model, params, T(pts)).numpy(),
        np.asarray(JCAM.project(model, jp, jnp.asarray(pts))), atol=1e-4,
        rtol=0)
    np.testing.assert_allclose(
        TCAM.unproject(model, params, T(px)).numpy(),
        np.asarray(JCAM.unproject(model, jp, jnp.asarray(px))), atol=1e-5,
        rtol=0)
    want = np.asarray(JCAM.project_jac(model, jp, jnp.asarray(pts)))
    got = TCAM.project_jac(model, params, T(pts)).numpy()
    assert got.shape == (300, 2, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_triangulate_points():
    rs = np.random.RandomState(6)
    pts = _points(400, 7).astype(np.float64)
    pts[:20, 2] *= -1.0         # behind both cameras: cheirality fails
    rot21 = np.asarray(JL.so3_exp(jnp.asarray([0.02, -0.05, 0.01])),
                       np.float64)
    t21 = np.array([-0.3, 0.02, 0.05])
    p2 = pts @ rot21.T + t21
    rays1 = pts / pts[:, 2:3] + rs.randn(400, 3) * 1e-3 * [1, 1, 0]
    rays2 = p2 / p2[:, 2:3] + rs.randn(400, 3) * 1e-3 * [1, 1, 0]
    args = [a.astype(np.float32) for a in (rays1, rays2, rot21, t21)]
    pj, vj = j_tri(*(jnp.asarray(a) for a in args))
    pt, vt = triangulate_points(*(T(a) for a in args))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert 0 < vt.sum() < 400
    p64, _ = triangulate_points(*(T(a).double() for a in args))
    for got in (pt.numpy(), np.asarray(pj)):
        assert _rel(got, p64.numpy()).max() < 3e-4
    assert _rel(pt.numpy(), np.asarray(pj)).max() < 1e-4


def _rel(a, b):
    """Per-point relative distance |a - b| / |b|."""
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.fixture(scope="module")
def rectified_pair():
    """The JAX e2e stereo test's rig (tests/test_e2e_stereo.py:20-27):
    320x240, fx 200, the right camera 0.1 m along +x, rendered by the
    reference."""
    cam = JS.Camera(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=W,
                    height=H)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=10.0)
    rot_cw, t_cw = seq.pose_cw(0.0)
    gl, depth = seq._render(rot_cw, t_cw)
    gr, _ = seq._render(rot_cw, t_cw + jnp.array([-0.1, 0.0, 0.0]))
    return np.array(gl), np.array(gr), np.array(depth)


def test_stereo_match(rectified_pair):
    gl, gr, depth = rectified_pair
    rs = np.random.RandomState(8)
    uv = np.concatenate([
        rs.uniform([80.0, 20.0], [300.0, 220.0], (400, 2)),
        rs.uniform([0.0, 0.0], [W, H], (100, 2))]).astype(np.float32)
    valid = rs.rand(500) > 0.05
    bf = 200.0 * 0.1
    urj, dj = j_stereo(jnp.asarray(gl), jnp.asarray(gr), jnp.asarray(uv),
                       jnp.asarray(valid), bf)
    urt, dt = TST.stereo_match(T(gl), T(gr), T(uv), T(valid), bf)
    okj, okt = np.asarray(dj) > 0, dt.numpy() > 0
    assert okj.mean() > 0.5
    assert (okj == okt).mean() >= 0.99
    both = okj & okt
    np.testing.assert_allclose(urt.numpy()[both], np.asarray(urj)[both],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(dt.numpy()[both], np.asarray(dj)[both],
                               rtol=1e-4, atol=0)
    # the reference's accuracy gate on the port's depths
    xi, yi = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(int)
    gt = depth[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
    rel = np.abs(dt.numpy() - gt)[okt] / gt[okt]
    assert np.median(rel) < 0.05


def _fisheye_fixture(n=128, seed=0):
    """tests/test_stereo_fisheye.py:33-53: random points seen by a dual-KB8
    rig, their rays through each camera's KB8 model, random descriptors."""
    rng = np.random.default_rng(seed)
    params_l = jnp.asarray([190.0, 190.0, 160.0, 120.0, *KB8_L])
    params_r = jnp.asarray([191.0, 190.5, 158.0, 121.0, *KB8_R])
    r_lr = JL.so3_exp(jnp.array([0.002, -0.001, 0.0008]))
    t_lr = jnp.array([0.101, 0.002, 0.001])
    pts = jnp.asarray(rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.0, 4.5],
                                  (n, 3)), jnp.float32)
    pts_r = (pts - t_lr) @ r_lr
    rays_l = JCAM.kb8_unproject(params_l, JCAM.kb8_project(params_l, pts))
    rays_r = JCAM.kb8_unproject(params_r, JCAM.kb8_project(params_r, pts_r))
    desc = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
        np.uint32)
    return (np.asarray(rays_l), np.asarray(rays_r), desc,
            np.asarray(r_lr), np.asarray(t_lr))


@pytest.mark.parametrize("case", ["identity", "shuffled", "lapping"])
def test_fisheye_stereo_match(case):
    rays_l, rays_r, desc, r_lr, t_lr = _fisheye_fixture(
        seed={"identity": 0, "shuffled": 3, "lapping": 5}[case])
    n = rays_l.shape[0]
    rs = np.random.RandomState(9)
    sig2_l = (1.2 ** (2 * rs.randint(0, 4, n))).astype(np.float32)
    sig2_r = (1.2 ** (2 * rs.randint(0, 4, n))).astype(np.float32)
    mask_l = np.ones(n, bool)
    desc_r = desc
    if case == "shuffled":
        rays_r = rays_r[np.roll(np.arange(n), 7)]
    if case == "lapping":
        mask_l[n // 2:] = False
        desc_r = desc.copy()
        desc_r[::5, 0] ^= 0x0F0F      # some pairs a few bits apart
    mask_r = np.ones(n, bool)
    args = (rays_l, desc, mask_l, sig2_l, rays_r, desc_r, mask_r, sig2_r,
            r_lr, t_lr)
    dj, pj, mj = j_fisheye(*(jnp.asarray(a) for a in args), f_err=190.0)
    dt, pt, mt = TST.fisheye_stereo_match(
        *(T(a.view(np.int32) if a.dtype == np.uint32 else a) for a in args),
        f_err=190.0)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    ok = np.asarray(dj) > 0
    np.testing.assert_array_equal(dt.numpy() > 0, ok)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=5e-4,
                               atol=0)
    if ok.any():
        assert _rel(pt.numpy()[ok], np.asarray(pj)[ok]).max() < 5e-4
    if case == "identity":
        assert ok.mean() > 0.95
    elif case == "shuffled":
        assert ok.mean() < 0.05
    else:
        assert not ok[n // 2:].any() and ok[:n // 2].any()


@pytest.fixture(scope="module")
def fisheye_image():
    """A frame of the KB8 camera of tests/test_stereo_fisheye.py's e2e rig
    (320x240, fx 140), rendered by the reference."""
    cam = JS.Camera(fx=140.0, fy=140.0, cx=160.0, cy=120.0, width=W,
                    height=H, kb8=KB8_L)
    seq = JS.SyntheticSequence(JS.SyntheticWorld(cam), fps=10.0)
    g, d, _ = seq.frame(0.7)
    return np.array(g), np.array(d)


def _frame_cfgs(**kw):
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=512, bf=14.0, **kw)
    return (JFrame(orb=JOrb(**orb), **fc),
            C.FrameConfig(orb=C.OrbConfig(**orb), **fc))


@pytest.mark.parametrize("model", ["kb8", "radtan"])
def test_build_frame_undistortion(model, fisheye_image):
    """The undistorted keypoints of the keypoints both packages detect
    (matched by their raw pixel, from the same build without distortion)
    within 1e-3 px, their depth (sampled at the raw pixel) equal."""
    g, d = fisheye_image
    kw = (dict(camera_model="kb8", dist_params=KB8_L) if model == "kb8"
          else dict(dist_params=RADTAN))
    out = {}
    for tag, extra in (("raw", {}), ("und", kw)):
        jcfg, tcfg = _frame_cfgs(**extra)
        fj = jax.jit(lambda a, b: j_build_frame(a, b, jcfg, 140.0, 140.0,
                                                160.0, 120.0))(
            jnp.asarray(g), jnp.asarray(d))
        ft = build_frame(T(g), T(d), tcfg, 140.0, 140.0, 160.0, 120.0)
        out[tag] = (fj, ft)
    maps = []
    for side in (0, 1):
        raw, und = out["raw"][side].feat, out["und"][side].feat
        valid = np.asarray(raw.valid)
        keys = [tuple(p) for p in np.asarray(raw.uv)[valid]]
        maps.append(dict(zip(keys, zip(
            np.asarray(und.uv)[valid],
            np.asarray(out["und"][side].depth_kp)[valid]))))
    shared = set(maps[0]) & set(maps[1])
    assert len(shared) >= 0.95 * len(maps[0]) and len(shared) > 100
    moved = 0.0
    for k in shared:
        (uj, dj), (ut, dt) = maps[0][k], maps[1][k]
        np.testing.assert_allclose(ut, uj, atol=1e-3, rtol=0)
        assert dj == pytest.approx(dt, rel=1e-6)
        moved = max(moved, float(np.abs(ut - np.asarray(k)).max()))
    assert moved > 1.0      # the undistortion did move the keypoints


def test_build_frame_without_depth(fisheye_image):
    """depth None: no depth or right u on any keypoint (OF slots padded),
    an empty cloud, no depth image kept."""
    g, _ = fisheye_image
    jcfg, tcfg = _frame_cfgs(n_of_slots=16)
    fj = jax.jit(lambda a: j_build_frame(a, None, jcfg, 140.0, 140.0,
                                         160.0, 120.0))(jnp.asarray(g))
    ft = build_frame(T(g), None, tcfg, 140.0, 140.0, 160.0, 120.0)
    assert ft.depth_img is None and fj.depth_img is None
    for a, b in ((ft.depth_kp, fj.depth_kp), (ft.u_right, fj.u_right),
                 (ft.cloud_valid, fj.cloud_valid), (ft.cloud, fj.cloud)):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ft.feat.uv.shape[0] == 416 and (ft.depth_kp == -1).all()


@pytest.mark.parametrize("t", [0.0, 1.3])
def test_kb8_render(t):
    cam = dict(fx=140.0, fy=140.0, cx=160.0, cy=120.0, width=W, height=H,
               kb8=KB8_L)
    jseq = JS.SyntheticSequence(JS.SyntheticWorld(JS.Camera(**cam)),
                                fps=10.0)
    tw = TS.SyntheticWorld(TS.Camera(**cam), device="cpu")
    rot_cw, t_cw = jseq.pose_cw(t)
    gj, dj = jseq._render(rot_cw, t_cw)
    gt, dt = tw.render(T(rot_cw), T(t_cw))
    assert float(np.abs(gt.numpy() - np.asarray(gj)).mean()) < 1e-3
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
