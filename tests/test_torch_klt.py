"""Port parity of the Lucas-Kanade tracker (ops/klt.py) on the CPU, where the
port runs its plain version: one pyramid level (`_track_level`) at 120x160
and 60x80 with windows 21 and 31, including points off the image, points on
a flat patch and points whose guess is off by up to 3 px; then the
coarse-to-fine `klt_track` and the forward-backward `fb_klt_track` over a
3-level pyramid, and the multi-stream entry `fb_klt_track_streams` (the
optical-flow stage's two streams at once) against one `fb_klt_track` per
stream, exact, and against the reference. Inputs are made with numpy and
handed to both packages.

Tolerances: where both say ok, tracked points within 1e-3 px and err within
1e-3 (the samples are the same float32 operations; XLA and PyTorch sum the
441 or 961 window terms in another order, and 10 Gauss-Newton steps
amplify that); ok equal on all but 1% of the points (the min-eigenvalue and
in-image gates can flip on their edge)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import klt as JK

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops import klt as TK

torch.set_num_threads(2)

SHIFT = np.array([1.7, -1.2], np.float32)
N_PTS = 300
FLAT = 24           # flat corner patch: every window up to 31 at its corner
TOL_PX, TOL_ERR, TOL_OK = 1e-3, 1e-3, 0.01


def _texture(h, w, shift, seed=0):
    """Sum of random plane waves, evaluated at (x - sx, y - sy), with a flat
    FLAT x FLAT patch in the top-left corner of the unshifted image."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xs, ys = xs - shift[0], ys - shift[1]
    img = np.full((h, w), 128.0)
    for _ in range(12):
        fx, fy = rs.uniform(-0.25, 0.25, 2)
        img += rs.uniform(5, 15) * np.sin(fx * xs + fy * ys + rs.uniform(0, 6))
    flat = (xs < FLAT) & (ys < FLAT)
    img[flat] = 100.0
    return img.astype(np.float32)


def _points(h, w, win, seed=1):
    """N_PTS points: 200 anywhere in and around the image, 10 in the flat
    corner, the rest inside with their window clear of border and patch;
    guesses up to 3 px off the true motion."""
    rs = np.random.RandomState(seed)
    anywhere = np.stack([rs.rand(200) * (w + 30) - 15,
                         rs.rand(200) * (h + 30) - 15], 1)
    flat = rs.rand(10, 2) * 3
    cand = rs.rand(20000, 2) * [w, h]
    inner = cand[_inner(cand, h, w, win)][:N_PTS - 210]
    pts = np.concatenate([anywhere, flat, inner]).astype(np.float32)
    guess = pts + SHIFT + rs.uniform(-3, 3, pts.shape).astype(np.float32)
    return pts, guess


def _inner(pts, h, w, win):
    """Points whose window lies inside the image and off the flat patch,
    where the motion is exactly SHIFT."""
    m = win // 2 + 4
    x, y = pts[:, 0], pts[:, 1]
    return ((x > m) & (x < w - m) & (y > m) & (y < h - m)
            & ~((x < FLAT + m) & (y < FLAT + m)))


def _compare(jres, tres):
    gj, okj, ej = (np.asarray(x) for x in jres)
    gt, okt, et = (x.numpy() for x in tres)
    both = okj & okt
    assert both.sum() > N_PTS // 3
    assert (okj != okt).mean() <= TOL_OK
    assert np.abs(gj - gt)[both].max() <= TOL_PX
    assert np.abs(ej - et)[both].max() <= TOL_ERR
    return both


@pytest.mark.parametrize("h,w,win", [(120, 160, 21), (120, 160, 31),
                                     (60, 80, 21), (60, 80, 31)])
def test_track_level_matches_reference(h, w, win):
    prev = _texture(h, w, (0.0, 0.0))
    nxt = _texture(h, w, SHIFT)
    pts, guess = _points(h, w, win)
    jres = jax.jit(JK._track_level, static_argnums=(4, 5, 6))(
        jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts),
        jnp.asarray(guess), win, 10, 1e-4)
    tres = TK._track_level(torch.from_numpy(prev), torch.from_numpy(nxt),
                           torch.from_numpy(pts), torch.from_numpy(guess),
                           win, 10, 1e-4)
    both = _compare(jres, tres)
    # windows clear of the border and the flat patch land on the true
    # motion; points off the image or on the flat patch are refused
    g = tres[0].numpy()
    inner = _inner(pts, h, w, win)
    assert (inner & both).sum() > 30
    assert (np.linalg.norm(g - pts - SHIFT, axis=1)[inner & both]
            < 0.05).all()
    ok = tres[1].numpy()
    outside = ((g[:, 0] < 0) | (g[:, 0] > w - 1)
               | (g[:, 1] < 0) | (g[:, 1] > h - 1))
    assert outside.sum() > 0 and not ok[outside].any()
    assert not ok[200:210].any()            # the flat corner


def test_cpu_track_level_takes_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launcher called for CPU tensors")
    monkeypatch.setattr(kernels, "lk_level", boom)
    prev = torch.from_numpy(_texture(60, 80, (0.0, 0.0)))
    nxt = torch.from_numpy(_texture(60, 80, SHIFT))
    pts, guess = (torch.from_numpy(x) for x in _points(60, 80, 21))
    got = TK.track_level(prev, nxt, pts, guess, 21, 10, 1e-4)
    want = TK._track_level(prev, nxt, pts, guess, 21, 10, 1e-4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def pyramids():
    h, w = 120, 160
    prev = _texture(h, w, (0.0, 0.0))
    nxt = _texture(h, w, (2.0 * SHIFT[0], 2.0 * SHIFT[1]))
    jp = JK.build_lk_pyramid(jnp.asarray(prev), 3)
    jn = JK.build_lk_pyramid(jnp.asarray(nxt), 3)
    tp = [torch.from_numpy(np.array(x)) for x in jp]
    tn = [torch.from_numpy(np.array(x)) for x in jn]
    rs = np.random.RandomState(5)
    pts = np.stack([rs.rand(N_PTS) * (w - 20) + 10,
                    rs.rand(N_PTS) * (h - 20) + 10], 1).astype(np.float32)
    return jp, jn, tp, tn, pts


def test_pyramid_matches_reference(pyramids):
    jp, _, tp, _, _ = pyramids
    tp2 = TK.build_lk_pyramid(tp[0], 3)
    for a, b in zip(jp, tp2):
        assert b.is_contiguous()
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3)


def test_klt_track_matches_reference(pyramids):
    jp, jn, tp, tn, pts = pyramids
    guess = pts + 2.0 * SHIFT + 1.5
    kw = dict(win=21, iters=10, min_eig=1e-4)
    jr = JK.klt_track(jp, jn, jnp.asarray(pts), jnp.asarray(guess), **kw)
    tr = TK.klt_track(tp, tn, torch.from_numpy(pts), torch.from_numpy(guess),
                      **kw)
    both = _compare((jr.pts, jr.status, jr.err), tuple(tr))
    inner = both & _inner(pts, 120, 160, 21)
    assert inner.sum() > 30
    assert np.abs(tr.pts.numpy() - pts - 2.0 * SHIFT)[inner].max() < 0.05


def test_fb_klt_track_matches_reference(pyramids):
    jp, jn, tp, tn, pts = pyramids
    kw = dict(fb_thresh=0.5, win=21, iters=10, min_eig=1e-4, max_levels=3)
    jr = JK.fb_klt_track(jp, jn, jnp.asarray(pts), None, **kw)
    tr = TK.fb_klt_track(tp, tn, torch.from_numpy(pts), None, **kw)
    both = _compare((jr.pts, jr.status, jr.err), tuple(tr))
    assert both.sum() > 0.8 * N_PTS


# the optical-flow stage's two streams: fine levels from a guess, and the
# whole pyramid (a level count past its depth is capped) from the points
STREAMS = {"levels3_guess": (3, True), "levels4_noguess": (4, False)}
FB_KW = dict(fb_thresh=0.5, win=21, iters=10, min_eig=1e-4)


@pytest.fixture(scope="module")
def streams(pyramids):
    """Both streams through the multi-stream entry, in one call."""
    _, _, tp, tn, pts = pyramids
    guess = pts + 2.0 * SHIFT + 1.5
    guesses = [torch.from_numpy(guess) if g else None
               for _, g in STREAMS.values()]
    res = TK.fb_klt_track_streams(tp, tn, torch.from_numpy(pts), guesses,
                                  [lv for lv, _ in STREAMS.values()], **FB_KW)
    return dict(zip(STREAMS, res)), guess


@pytest.mark.parametrize("name", list(STREAMS))
def test_fb_klt_track_streams_equals_per_stream(pyramids, streams, name):
    _, _, tp, tn, pts = pyramids
    res, guess = streams
    levels, with_guess = STREAMS[name]
    want = TK.fb_klt_track(tp, tn, torch.from_numpy(pts),
                           torch.from_numpy(guess) if with_guess else None,
                           max_levels=levels, **FB_KW)
    for a, b in zip(res[name], want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(STREAMS))
def test_fb_klt_track_streams_matches_reference(pyramids, streams, name):
    jp, jn, _, _, pts = pyramids
    res, guess = streams
    levels, with_guess = STREAMS[name]
    jr = JK.fb_klt_track(jp, jn, jnp.asarray(pts),
                         jnp.asarray(guess) if with_guess else None,
                         max_levels=levels, **FB_KW)
    both = _compare((jr.pts, jr.status, jr.err), tuple(res[name]))
    assert both.sum() > 0.8 * N_PTS


def test_cpu_streams_take_the_plain_version(pyramids, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel launcher called for CPU tensors")
    monkeypatch.setattr(kernels, "lk_pyramid", boom)
    monkeypatch.setattr(kernels, "lk_level", boom)
    _, _, tp, tn, pts = pyramids
    r, = TK.fb_klt_track_streams(tp, tn, torch.from_numpy(pts[:40]), [None],
                                 [None], **FB_KW)
    assert r.pts.shape == (40, 2) and r.status.dtype == torch.bool
    with pytest.raises(ValueError, match="per stream"):
        TK.fb_klt_track_streams(tp, tn, torch.from_numpy(pts), [None], [1, 2])
