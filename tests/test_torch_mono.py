"""Port parity of the monocular modules against the JAX package, on the CPU:
ops/ransac.py's homography, math/triangulate.py's DLT,
pipeline/mono_init.py and local_mapping.triangulate_new_points.

jax.random's draws cannot be reproduced, so both sides get the same
randomness: the RANSACs the same minimal sets (`sample_sets`), the
initializer the Gumbel noise that the JAX package draws from its key
(handed to the port's `_sample_minimal_sets`).

Tolerances: the homography RANSAC on the same sets picks the same
hypothesis with the same inliers, score within 1e-3; the port's DLT runs in
float64 (the reference's float32 lands ~1e-3 from the exact solution on
pixel coordinates), so its H is held within 1e-5 of the float64 solution
and no further from the reference's than the reference is from that, plus
1e-5 (on the 4-point solver's sets too); the transfer distances within
1e-5 relative; the DLT within 1e-5 (up to the
null vector's sign); both decompositions give the same candidate set up to
order within 1e-5; two_view_reconstruct and try_monocular_init on two frames
of the synthetic room: the same ok and H/F choice, R21 within 0.05 deg, t21
within 1e-3, pt_valid >= 99% equal, points where both are valid within
1e-3 (median) and 2e-3 (max) at median depth 1 on a pair 0.2 s apart, and
on the 0.1 s pair, whose 1 cm baseline makes far points ill-conditioned,
within 5e-3 (median) and 2e-2 (90th percentile); create_initial_map_mono and triangulate_new_points on one converted
JAX map: the same masks and bindings, positions within 5e-4 (the float32
triangulation's reach, see tests/test_torch_stereo.py); the sync-free F
solve against the SVD on the initializer's hypotheses (its docstring
gives the tolerances), and the initializer on it within the tolerances
above."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.math import lie as JL
from geoflowslam_tpu.math import triangulate as JTRI
from geoflowslam_tpu.ops import ransac as JR
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.pipeline import local_mapping as JLM
from geoflowslam_tpu.pipeline import mono_init as JMI
from geoflowslam_tpu.state import map_state as JM
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import convert
from geoflowslam_tpu_torch.math import triangulate as TTRI
from geoflowslam_tpu_torch.ops import ransac as TR
from geoflowslam_tpu_torch.pipeline import local_mapping as TLM
from geoflowslam_tpu_torch.pipeline import mono_init as TMI
from test_torch_shared import shared_result

torch.set_num_threads(2)

W, H, FX = 320, 240, 200.0
CX, CY = W / 2, H / 2
CPU = torch.device("cpu")
SAMPLE_SETS = TR._sample_minimal_sets


def _t(x):
    return torch.from_numpy(np.array(x))


def _planar(seed=10, noise=0.3):
    """tests/test_matching.py's planar case: 120 points on z = 5 seen from
    two poses, 20 gross outliers; here with 0.3 px noise on the second view
    (as its two-view case has), without which every all-inlier hypothesis
    is the same H and the best index a tie broken by rounding."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    pts = jax.random.uniform(k1, (120, 3), minval=jnp.array([-2, -2, 0.0]),
                             maxval=jnp.array([2, 2, 0.0])) \
        + jnp.array([0, 0, 5.0])
    rot = JL.so3_exp(jnp.array([0.05, -0.02, 0.04]))
    t = jnp.array([0.3, -0.1, 0.1])
    c = jnp.array([320.0, 240.0])
    uv1 = pts[:, :2] / pts[:, 2:3] * 400.0 + c
    pc2 = pts @ rot.T + t
    uv2 = (pc2[:, :2] / pc2[:, 2:3] * 400.0 + c).at[:20].add(50.0)
    uv2 = uv2 + noise * jax.random.normal(k2, uv2.shape)
    return np.array(uv1), np.array(uv2), np.ones(120, bool)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _solve_h(mod, uv1, uv2, sets, dtype=None):
    """Every set's homography through `mod`'s 4-point solver."""
    if mod is JR:
        return np.array(jax.vmap(lambda i: JR._solve_h_4pt(
            jnp.asarray(uv1)[i], jnp.asarray(uv2)[i]))(jnp.asarray(sets)))
    idx = _t(sets).long()
    return TR._solve_h_4pt(_t(uv1).to(dtype)[idx],
                           _t(uv2).to(dtype)[idx]).numpy()


def test_ransac_homography_matches_reference_on_same_sets():
    """The same hypothesis and inliers as the reference, score within
    1e-3. The port solves the DLT in float64 (the reference in float32,
    ~1e-3 from the exact solution on pixel coordinates): its H within 1e-5
    of the float64 solution of the chosen set, and no further from the
    reference's than the reference is from that solution, plus 1e-5."""
    uv1, uv2, valid = _planar()
    key = jax.random.PRNGKey(11)
    sets = np.array(JR._sample_minimal_sets(key, jnp.asarray(valid), 128, 4))
    rj = JR.ransac_homography(key, jnp.asarray(uv1), jnp.asarray(uv2),
                              jnp.asarray(valid))
    rt = TR.ransac_homography(None, _t(uv1), _t(uv2), _t(valid),
                              sample_sets=_t(sets).long())
    hs_j = _solve_h(JR, uv1, uv2, sets)
    hs_64 = _solve_h(TR, uv1, uv2, sets, torch.float64)
    best_j = int(np.argmin(np.abs(hs_j - np.array(rj.model)).sum((1, 2))))
    best_t = int(np.argmin(np.abs(hs_64 - rt.model.numpy()).sum((1, 2))))
    assert best_j == best_t
    h_t, h_j, h_64 = rt.model.numpy(), np.array(rj.model), hs_64[best_t]
    assert _rel(h_t, h_64) < 1e-5
    assert _rel(h_t, h_j) <= _rel(h_j, h_64) + 1e-5
    assert np.array_equal(rt.inliers.numpy(), np.array(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) >= 95
    assert abs(float(rt.score) - float(rj.score)) <= 1e-3 * float(rj.score)


def test_solve_h_4pt_and_transfer_distances():
    """The solver on noise-free sets of inliers in normalized image
    coordinates: within 1e-6 relative of the float64 solution, and no
    further from the reference's than the reference is from it, plus 1e-5
    (its float32 SVD lands up to ~1e-2 away on a near-degenerate set); the
    transfer distances of one H over the planar case's pixels within 1e-5
    relative."""
    uv1, uv2, valid = _planar(noise=0.0)
    inl = valid & (np.arange(120) >= 20)
    sets = np.array(JR._sample_minimal_sets(jax.random.PRNGKey(4),
                                            jnp.asarray(inl), 16, 4))
    n1, n2 = (uv1 - 320.0) / 400.0, (uv2 - 320.0) / 400.0
    hj = _solve_h(JR, n1, n2, sets)
    ht = _solve_h(TR, n1, n2, sets, torch.float32)
    h64 = _solve_h(TR, n1, n2, sets, torch.float64)
    for a, b, c in zip(ht, hj, h64):
        assert _rel(a, c) < 1e-6
        assert _rel(a, b) <= _rel(b, c) + 1e-5
    uv1, uv2, valid = _planar()
    h = np.array(JR.ransac_homography(jax.random.PRNGKey(11),
                                      jnp.asarray(uv1), jnp.asarray(uv2),
                                      jnp.asarray(valid)).model)
    d12j, d21j = JR._h_transfer_dist2(jnp.asarray(h), jnp.asarray(uv1),
                                      jnp.asarray(uv2))
    d12t, d21t = TR._h_transfer_dist2(_t(h[None]), _t(uv1), _t(uv2))
    assert _rel(d12t[0].numpy(), np.array(d12j)) < 1e-5
    assert _rel(d21t[0].numpy(), np.array(d21j)) < 1e-5


def test_triangulate_dlt():
    rs = np.random.RandomState(2)
    x = np.c_[rs.rand(50) * 2 - 1, rs.rand(50) * 2 - 1,
              rs.rand(50) * 3 + 2].astype(np.float32)
    rot = np.array(JL.so3_exp(jnp.array([0.02, -0.1, 0.03])))
    t = np.array([0.3, 0.02, -0.05], np.float32)
    p1 = np.eye(3, 4, dtype=np.float32)
    p2 = np.concatenate([rot, t[:, None]], 1).astype(np.float32)
    r1 = x / x[:, 2:]
    x2 = x @ rot.T + t
    r2 = (x2 / x2[:, 2:]).astype(np.float32)
    want = np.array(JTRI.triangulate_dlt(*(jnp.asarray(a)
                                           for a in (r1, r2, p1, p2))))
    got = TTRI.triangulate_dlt(*(_t(a) for a in (r1, r2, p1, p2))).numpy()
    sign = np.sign(np.sum(got * want, axis=1, keepdims=True))
    assert np.abs(got * sign - want).max() < 1e-5
    pts = got[:, :3] / got[:, 3:]
    assert np.abs(pts - x).max() < 1e-3


def _same_set(ct, cj, tol=1e-5):
    """Every candidate of ct matches a distinct one of cj within tol."""
    used = set()
    for rt, tt in ct:
        d = [max(np.abs(rt.numpy() - np.array(rj)).max(),
                 np.abs(tt.numpy() - np.array(tj)).max()) for rj, tj in cj]
        k = int(np.argmin(d))
        assert d[k] < tol and k not in used, (d, used)
        used.add(k)


def _flip_svd(monkeypatch, d):
    """Make mono_init's SVDs return U D, D V^T (D diagonal, +-1): another
    valid factorization."""
    svd = torch.linalg.svd

    def flipped(a, *args, **kw):
        u, s, vt = svd(a, *args, **kw)
        dd = torch.tensor(d, dtype=u.dtype)
        return u * dd, s, vt * dd[:, None]
    monkeypatch.setattr(TMI.torch.linalg, "svd", flipped)


@pytest.mark.parametrize("flip", [None, (-1.0, 1.0, 1.0), (1.0, -1.0, -1.0)])
def test_decompositions_match_and_ignore_svd_signs(flip, monkeypatch):
    rs = np.random.RandomState(5)
    rot = np.array(JL.so3_exp(jnp.array([0.05, -0.08, 0.02])))
    t = np.array([0.4, -0.1, 0.2], np.float32)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    e = (tx @ rot).astype(np.float32)
    n = np.array([0.1, -0.2, 1.0])
    a = (rot + np.outer(t, n) / 3.0 + rs.randn(3, 3) * 1e-3).astype(
        np.float32)
    cj_e = JMI._decompose_essential(jnp.asarray(e))
    cj_h = JMI._decompose_homography(jnp.asarray(a))
    if flip is not None:
        _flip_svd(monkeypatch, flip)
    ct_e = TMI._decompose_essential(_t(e))
    ct_h = TMI._decompose_homography(_t(a))
    assert len(ct_e) == 4 and len(ct_h) == 8
    _same_set(ct_e, cj_e)
    _same_set(ct_h, cj_h)


# ---------------------------------------------------------------------------
# The initializer on two frames of the synthetic room
# ---------------------------------------------------------------------------

def _frame_cfgs():
    orb = dict(n_features=400, n_levels=4, height=H, width=W)
    fc = dict(lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=0.0)
    return (JFrame(orb=JOrb(**orb), **fc),
            C.FrameConfig(orb=C.OrbConfig(**orb), **fc))


@pytest.fixture(scope="module")
def room_frames(tmp_path_factory):
    """JAX frames (no depth) of the room at t = 0, 0.1 and 0.3 s (built once
    per session for every xdist worker, tests/test_torch_shared.py) and
    their conversions."""
    frames = shared_result(tmp_path_factory, "test_torch_mono.room_frames",
                           _room_frames)
    return [(jf, convert.frame_data(jf, CPU)) for jf in frames]


def _room_frames():
    jfc, _ = _frame_cfgs()
    cam = Camera(fx=FX, fy=FX, cx=CX, cy=CY, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=10.0)
    out = []
    for t in (0.0, 0.1, 0.3):
        g, _, _ = seq.frame(t)
        out.append(j_build_frame(jnp.asarray(g), None, jfc, FX, FX, CX, CY))
    return out


class _JaxNoise:
    """The port's `_sample_minimal_sets` fed with the Gumbel noise that
    jax.random draws from `key` for the F and then the H sets."""

    def __init__(self, key):
        kf, kh = jax.random.split(key)
        self.keys = [kf, kh]

    def __call__(self, gen, valid, n_hyp, set_size, noise=None):
        k = self.keys.pop(0)
        g = np.array(jax.random.gumbel(k, (n_hyp, valid.shape[0])))
        return SAMPLE_SETS(gen, valid, n_hyp, set_size, noise=_t(g))


def _use_h(key, uv1, uv2, valid):
    kf, kh = jax.random.split(key)
    sf = JR.ransac_fundamental(kf, uv1, uv2, valid, 128).score
    sh = JR.ransac_homography(kh, uv1, uv2, valid, 128).score
    return bool(sh / jnp.maximum(sh + sf, 1e-9) > 0.50)


def _check_init(rt, rj, use_h_t, use_h_j, pts_tol, unit=1.0):
    """The init checks; points compared in units of `unit` (the
    reference's median depth, for the unnormalized reconstruction)."""
    assert bool(rt[0]) == bool(rj[0])
    assert bool(use_h_t) == use_h_j
    # the angle of R_t^T R_j, read from the chord (float64; arccos of the
    # trace loses ~0.03 deg near identity in float32)
    diff = rt[1].numpy().astype(np.float64) - np.array(rj[1], np.float64)
    ang = np.degrees(2 * np.arcsin(min(np.linalg.norm(diff)
                                       / (2 * np.sqrt(2)), 1.0)))
    assert ang < 0.05
    assert np.abs(rt[2].numpy() - np.array(rj[2])).max() < 1e-3
    vt, vj = rt[4].numpy(), np.array(rj[4])
    assert (vt == vj).mean() >= 0.99
    both = vt & vj
    assert both.sum() > 50
    d = np.linalg.norm(rt[3].numpy()[both] - np.array(rj[3])[both],
                       axis=1) / unit
    med, q, bound = pts_tol
    assert np.median(d) < med and np.percentile(d, q) < bound, (
        np.median(d), np.percentile(d, q))


# points, as distances at median depth 1: (bound of the median, a
# percentile, its bound). Frames 0 and 1 (the slice's init pair) are 1 cm
# apart at that scale, so a point's depth is ill-conditioned by z^2 / 1 cm:
# a 1e-5 difference of t21 (the float32 F solves of two LAPACK paths)
# moves the median point by ~2e-3, and the reference's float32
# triangulation of the farthest ones (z ~ 12) is not defined to 1; the
# median and 90% of the points are held. Frames 0 and 2: every point.
PTS_TOL = {(0, 1): (5e-3, 90, 2e-2), (0, 2): (1e-3, 100, 2e-3)}


@pytest.mark.parametrize("pair", [(0, 1), (0, 2)])
def test_two_view_reconstruct_and_try_init(room_frames, pair, monkeypatch):
    _check_two_view(room_frames, pair, monkeypatch)


def _check_two_view(room_frames, pair, monkeypatch):
    (j1, t1), (j2, t2) = room_frames[pair[0]], room_frames[pair[1]]
    key = jax.random.PRNGKey(1234 + pair[1])
    rj = JMI.try_monocular_init(key, j1, j2, FX, FX, CX, CY)
    monkeypatch.setattr(TR, "_sample_minimal_sets", _JaxNoise(key))
    rt = TMI.try_monocular_init(None, t1, t2, FX, FX, CX, CY)
    assert np.array_equal(rt.match_idx.numpy(), np.array(rj.match_idx))
    valid = rj.match_idx >= 0
    uv2 = j2.feat.uv[jnp.maximum(rj.match_idx, 0)]
    use_h = _use_h(key, j1.feat.uv, uv2, valid)
    assert bool(rj.ok), "the reference fails to initialize on this pair"
    _check_init((rt.ok, rt.rot21, rt.t21, rt.pts1, rt.pt_valid),
                (rj.ok, rj.rot21, rj.t21, rj.pts1, rj.pt_valid), rt.use_h,
                use_h, PTS_TOL[pair])
    # two_view_reconstruct alone, before the scale normalization
    wj = JMI.two_view_reconstruct(key, j1.feat.uv, uv2, valid, FX, FX, CX, CY)
    monkeypatch.setattr(TR, "_sample_minimal_sets", _JaxNoise(key))
    wt = TMI.two_view_reconstruct(
        None, t1.feat.uv, t2.feat.uv[torch.clamp_min(rt.match_idx, 0).long()],
        rt.match_idx >= 0, FX, FX, CX, CY)
    # |t| = 1 here: compare at the reference's median depth
    unit = float(np.median(np.array(wj[3])[np.array(wj[4]), 2]))
    _check_init(wt[:5], wj, wt[5], use_h, PTS_TOL[pair], unit)


@pytest.mark.parametrize("pair", [(0, 1), (0, 2)])
def test_jacobi_f_solve_matches_svd_on_the_init_pairs(room_frames, pair,
                                                      monkeypatch):
    """The sync-free F solve (math/sym_eig's float64 null vector, the OF
    stage's) against the float32 SVD that the initializer keeps, on the
    initializer's own F hypotheses: the normalized F agree to float32
    rounding (median 1e-5; an ill-conditioned set reaches ~1e-3), the
    RANSAC keeps the same inliers with the score within 1e-5, and the
    initializer run on the Jacobi solve meets the SVD run's tolerances
    against JAX."""
    (j1, t1), (j2, t2) = room_frames[pair[0]], room_frames[pair[1]]
    key = jax.random.PRNGKey(1234 + pair[1])
    rj = JMI.try_monocular_init(key, j1, j2, FX, FX, CX, CY)
    valid = _t(np.array(rj.match_idx >= 0))
    uv2 = t2.feat.uv[torch.clamp_min(_t(np.array(rj.match_idx)), 0).long()]
    sets = _JaxNoise(key)(None, valid, 128, 8)
    u1n, _ = TR._normalize_2d(t1.feat.uv, valid)
    u2n, _ = TR._normalize_2d(uv2, valid)
    fs = [TR._solve_f_8pt(u1n[sets], u2n[sets], svd).double()
          for svd in (True, False)]
    fs = [f / torch.linalg.norm(f.flatten(1), dim=1)[:, None, None]
          for f in fs]
    sign = torch.sign(torch.sum((fs[0] * fs[1]).flatten(1), dim=1))
    d = torch.amax(torch.abs(fs[0] - sign[:, None, None] * fs[1]), (1, 2))
    assert float(torch.median(d)) < 1e-4 and float(d.max()) < 5e-3
    rs, rn = (TR.ransac_fundamental(None, t1.feat.uv, uv2, valid, 128,
                                    sample_sets=sets, svd=svd)
              for svd in (True, False))
    assert torch.equal(rs.inliers, rn.inliers)
    assert abs(float(rs.score) - float(rn.score)) <= 1e-5 * float(rs.score)
    fundamental = TR.ransac_fundamental

    def jacobi_f(*args, **kw):
        return fundamental(*args, **{**kw, "svd": False})

    monkeypatch.setattr(TR, "ransac_fundamental", jacobi_f)
    _check_two_view(room_frames, pair, monkeypatch)


def test_nanmedian_is_numpys():
    x = torch.tensor([3.0, 1.0, 7.0, 2.0, 9.0, 4.0])
    keep = torch.tensor([True, True, True, True, False, False])
    assert float(TMI._nanmedian(x, keep)) == float(
        np.nanmedian([3.0, 1.0, 7.0, 2.0]))
    assert float(TMI._nanmedian(x, keep | True)) == float(np.median(x))
    assert np.isnan(float(TMI._nanmedian(x, keep & False)))


def _map_fields_close(mt, mj, tol, pos_tol=None):
    for f in ("kf_valid", "kf_prev", "kf_obs_mp", "kf_kp_valid", "mp_valid",
              "mp_first_kf", "mp_desc", "kf_desc", "mp_map_id"):
        a, b = getattr(mt, f).numpy(), np.array(getattr(mj, f))
        if b.dtype == np.uint32:
            b = b.view(np.int32)
        assert np.array_equal(a, b), f
    for f in ("kf_rot", "kf_t", "kf_time", "mp_pos", "mp_normal",
              "mp_min_dist", "mp_max_dist"):
        a, b = getattr(mt, f).numpy(), np.array(getattr(mj, f))
        bound = pos_tol if f == "mp_pos" and pos_tol is not None else tol
        assert np.abs(a - b).max() < bound, (f, np.abs(a - b).max())


def test_initial_map_and_triangulation_on_a_converted_map(room_frames):
    (j1, _), (j2, t2f) = room_frames[0], room_frames[2]
    key = jax.random.PRNGKey(7)
    init = JMI.try_monocular_init(key, j1, j2, FX, FX, CX, CY)
    assert bool(init.ok)
    jms = JM.create(8, 400, 4096)
    jout = JMI.create_initial_map_mono(jms, j1, j2, init, jnp.float32(0.0),
                                       jnp.float32(0.3), 1.2, 4)
    t_init = TMI.MonoInitResult(
        ok=_t(init.ok), rot21=_t(init.rot21), t21=_t(init.t21),
        pts1=_t(init.pts1), match_idx=_t(init.match_idx),
        pt_valid=_t(init.pt_valid), use_h=torch.tensor(False))
    tout = TMI.create_initial_map_mono(
        convert.map_state(jms, CPU), convert.frame_data(j1, CPU), t2f,
        t_init, 0.0, 0.3, 1.2, 4)
    assert (tout[1], tout[2]) == (int(jout[1]), int(jout[2]))
    assert np.array_equal(tout[3].numpy(), np.array(jout[3]))
    assert int(tout[4]) == int(jout[4]) > 50
    _map_fields_close(tout[0], jout[0], tol=1e-6)

    # the second KF's free keypoints against its neighbours (KF1, then the
    # zero-covisibility slots the reference takes as they come)
    mcfg = C.MappingConfig(fx=FX, fy=FX, cx=CX, cy=CY, scale_factor=1.2)
    jms2, jn = JLM.triangulate_new_points(
        jout[0], jnp.int32(int(jout[2])),
        JLM.MappingConfig(fx=FX, fy=FX, cx=CX, cy=CY, scale_factor=1.2))
    tms = convert.map_state(jout[0], CPU)
    tms2, tn = TLM.triangulate_new_points(tms, int(jout[2]), mcfg)
    assert int(tn) == int(jn) > 0
    # the port triangulates in float64: its points within 1e-5 of the same
    # function on a float64 map, and the reference's float32 ones (depth up
    # to 100 baselines) within 2e-3; the fields derived from the positions
    # (normals, distance bounds) within 3e-3
    f64 = tms._replace(**{f: getattr(tms, f).double() for f in (
        "kf_rot", "kf_t", "kf_uv", "mp_pos", "mp_normal", "mp_min_dist",
        "mp_max_dist")})
    t64, _ = TLM.triangulate_new_points(f64, int(jout[2]), mcfg)
    new = tms2.mp_valid.numpy() & ~tms.mp_valid.numpy()
    assert np.array_equal(t64.mp_valid.numpy(), tms2.mp_valid.numpy())
    assert np.abs(tms2.mp_pos.numpy()[new]
                  - t64.mp_pos.numpy()[new]).max() < 1e-5
    _map_fields_close(tms2, jms2, tol=3e-3, pos_tol=2e-3)
