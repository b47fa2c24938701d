"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card (marker `cuda`; skipped without one). On the machine with the card,
which has no JAX for tests/conftest.py to import:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops import extractor as EX
from geoflowslam_tpu_torch.ops import fast as F
from geoflowslam_tpu_torch.ops import klt as KLT
from geoflowslam_tpu_torch.ops import matching as MA
from geoflowslam_tpu_torch.ops.pyramid import build_pyramid, pyramid_shapes
from geoflowslam_tpu_torch.pipeline import of_tracking as OF
from geoflowslam_tpu_torch.state import map_state as M
from geoflowslam_tpu_torch.state.frame import build_frame

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_fast_scores_kernel_exact(cuda):
    rs = np.random.RandomState(0)
    for h, w in pyramid_shapes(480, 640, 8, 1.2) + [(7, 7), (33, 1)]:
        img = torch.from_numpy((rs.rand(h, w) * 255).astype(np.float32)).to(cuda)
        got = kernels.fast_scores(img, 7.0, 20.0)
        want = F.fast_score_maps(img, [7.0, 20.0])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the callers' gates: tracking (radius 7.5 here), fusion (radius 3), loop
# verification (radius 8, octave window [0, 8])
K2_GATES = [(7.5, -1, 1), (3.0, -1, 1), (8.0, 0, 8)]


@pytest.mark.parametrize("radius,min_off,max_off", K2_GATES)
@pytest.mark.parametrize("n,m", [(1000, 1000), (2048, 1000), (1256, 1256),
                                 (300, 2600), (37, 300)])
def test_gated_hamming_kernel_exact(cuda, n, m, radius, min_off, max_off):
    """K2 against its plain version, exact, at the paths' shapes, one M
    beyond what a block stages at once (2048), under the three gates."""
    rs = np.random.RandomState(n + m)
    dq = rs.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)
    dt = rs.randint(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64).astype(np.int32)
    k = min(n, m) // 2
    dt[:k] = dq[:k]
    dt[k:k + 10] = dt[:10]                   # duplicate targets: index ties
    uv_q = (rs.rand(n, 2) * 640).astype(np.float32)
    uv_t = np.resize(uv_q, (m, 2)) + (rs.randn(m, 2) * 2).astype(np.float32)
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    args = (c(uv_q), c(rs.randint(0, 8, n).astype(np.int32)),
            c(rs.rand(n) > 0.1), c(dq), torch.full((n,), radius, device=cuda),
            c(uv_t.astype(np.float32)), c(rs.randint(0, 8, m).astype(np.int32)),
            c(rs.rand(m) > 0.1), c(dt))
    got = kernels.gated_hamming_search(*args, min_off, max_off, MA.BIG)
    want = MA.gated_hamming_plain(*args, min_off, max_off)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((want[2] >= 0).sum()) > 0


@pytest.mark.parametrize("n,m,none_valid", [(1000, 1000, False),
                                            (777, 1013, False),
                                            (2048, 1000, False),
                                            (1, 1, False), (64, 300, True)])
def test_hamming_best2_kernel_exact(cuda, n, m, none_valid):
    """K4 forward and swapped against its plain version, exact: ~25%
    invalid rows and columns, queries copied from targets and duplicated
    targets (ties to the lowest index), (BIG, BIG, 0) where a row has no
    valid target."""
    rs = np.random.RandomState(n + m)
    dq = rs.randint(-2 ** 31, 2 ** 31, (n, 8), dtype=np.int64).astype(np.int32)
    dt = rs.randint(-2 ** 31, 2 ** 31, (m, 8), dtype=np.int64).astype(np.int32)
    k = min(n, m) // 4
    dq[:k] = dt[rs.randint(0, m, k)]
    dt[m // 2:m // 2 + m // 8] = dt[:m // 8]
    vq, vt = rs.rand(n) > 0.25, rs.rand(m) > 0.25
    if none_valid:
        vt[:] = False
    c = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    for args in ((c(dq), c(vq), c(dt), c(vt)), (c(dt), c(vt), c(dq), c(vq))):
        got = kernels.hamming_best2(*args, MA.BIG)
        want = MA.hamming_best2_plain(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _k4_table(cuda, shapes, seed):
    """One search per (n, m, no valid target): ~25% invalid rows and
    columns, queries copied from targets and duplicated targets."""
    rs = np.random.RandomState(seed)
    out = []
    for n, m, none_valid in shapes:
        dq = rs.randint(-2 ** 31, 2 ** 31, (n, 8),
                        dtype=np.int64).astype(np.int32)
        dt = rs.randint(-2 ** 31, 2 ** 31, (m, 8),
                        dtype=np.int64).astype(np.int32)
        k = min(n, m) // 4
        dq[:k] = dt[rs.randint(0, m, k)]
        dt[m // 2:m // 2 + m // 8] = dt[:m // 8]
        vq, vt = rs.rand(n) > 0.25, rs.rand(m) > 0.25
        if none_valid:
            vt[:] = False
        out.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                         for a in (dq, vq, dt, vt)))
    return out


@pytest.mark.parametrize("table", ["reloc", "mixed"])
def test_hamming_best2_many_kernel_exact(cuda, table):
    """One launch of K4 over a table: relocalization's six searches (three
    1000 x 1000 candidates, both directions) and a table of mixed sizes with
    an all-invalid target set, each search torch.equal to the plain
    version."""
    if table == "reloc":
        fwd = _k4_table(cuda, [(1000, 1000, False)] * 3, seed=1)
        searches = fwd + [(t, vt, q, vq) for q, vq, t, vt in fwd]
    else:
        searches = _k4_table(cuda, [(777, 1013, False), (64, 300, True),
                                    (1, 1, False), (2048, 1000, False),
                                    (0, 5, False), (17, 9, False)], seed=2)
    kernels.reset_launch_counts()
    got = kernels.hamming_best2_many(searches, MA.BIG)
    assert kernels.launch_counts["hamming_best2"] == 1
    assert len(got) == len(searches)
    for s, g in zip(searches, got):
        if s[0].shape[0] == 0:
            assert all(x.numel() == 0 for x in g)
            continue
        for a, b in zip(g, MA.hamming_best2_plain(*s)):
            assert torch.equal(a, b)


def test_match_descriptors_on_cuda_goes_through_the_kernel(cuda,
                                                           monkeypatch):
    """An unmasked match launches K4 once with mutual (both directions in
    one table), match_descriptors_many once for all its pairs, and both
    equal the CPU result; with the launcher made to raise, they raise."""
    rs = np.random.RandomState(5)
    d = rs.randint(-2 ** 31, 2 ** 31, (300, 8), dtype=np.int64).astype(np.int32)
    e = d.copy()
    e[::3] ^= 1 << 5
    v = rs.rand(300) > 0.1
    cpu = [torch.from_numpy(x) for x in (d, v, e, v)]
    kernels.reset_launch_counts()
    got = MA.match_descriptors(*(x.to(cuda) for x in cpu), mutual=True)
    assert kernels.launch_counts["hamming_best2"] == 1
    want = MA.match_descriptors(*cpu, mutual=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    pairs = [cpu, [cpu[2][:200], cpu[3][:200], cpu[0], cpu[1]], cpu]
    kernels.reset_launch_counts()
    got = MA.match_descriptors_many([[x.to(cuda) for x in p] for p in pairs],
                                    ratio=0.85)
    assert kernels.launch_counts["hamming_best2"] == 1
    for p, g in zip(pairs, got):
        want = MA.match_descriptors(*p, ratio=0.85)
        for a, b in zip(g, want):
            assert torch.equal(a.cpu(), b)

    def boom(*a, **k):
        raise RuntimeError("hamming_best2 launcher reached")
    monkeypatch.setattr(kernels, "hamming_best2_many", boom)
    with pytest.raises(RuntimeError, match="launcher reached"):
        MA.match_descriptors(*(x.to(cuda) for x in cpu), mutual=False)


def _lk_case(cuda, h, w, n, seed):
    """Smooth random texture, the same moved by (3, -2) px, n points (some
    past the border) and guesses up to 3 px off."""
    rs = np.random.RandomState(seed)
    big = rs.rand(h // 8 + 4, w // 8 + 4).astype(np.float32) * 255
    tex = torch.nn.functional.interpolate(
        torch.from_numpy(big)[None, None].to(cuda), size=(h + 16, w + 16),
        mode="bicubic", align_corners=False)[0, 0]
    prev = tex[8:8 + h, 8:8 + w].contiguous()
    nxt = tex[10:10 + h, 5:5 + w].contiguous()
    pts = np.stack([rs.rand(n) * (w + 16) - 8, rs.rand(n) * (h + 16) - 8], 1)
    guess = pts + [3, -2] + rs.uniform(-3, 3, pts.shape)
    c = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    return prev, nxt, c(pts), c(guess)


@pytest.mark.parametrize("h,w,win", [(480, 640, 21), (60, 80, 31),
                                     (7, 9, 21), (120, 160, 4)])
def test_lk_level_kernel_matches_plain(cuda, h, w, win):
    """Where both say ok, tracked points within 1e-3 px and err within 1e-4
    (equal samples, sums in another order); ok equal on >= 99.5%."""
    args = _lk_case(cuda, h, w, 1256, seed=h + win) + (win, 10, 1e-4)
    gk, okk, ek = kernels.lk_level(*args)
    gp, okp, ep = KLT._track_level(*args)
    both = okk & okp
    assert int((okk != okp).sum()) <= 0.005 * len(okk)
    if both.any():
        assert float((gk - gp).abs()[both].max()) <= 1e-3
        assert float((ek - ep).abs()[both].max()) <= 1e-4
    assert torch.isfinite(gk).all()


def test_klt_track_on_cuda_goes_through_the_kernel(cuda, monkeypatch):
    """A CUDA request never reaches the plain version: with the launcher
    made to raise, klt_track raises."""
    prev, nxt, pts, _ = _lk_case(cuda, 120, 160, 64, seed=0)
    kernels.reset_launch_counts()
    KLT.klt_track([prev], [nxt], pts)
    assert kernels.launch_counts["lk_level"] == 1

    def boom(*a, **k):
        raise RuntimeError("lk_level launcher reached")
    monkeypatch.setattr(kernels, "lk_level", boom)
    with pytest.raises(RuntimeError, match="launcher reached"):
        KLT.klt_track([prev], [nxt], pts)


@pytest.mark.parametrize("kind", ["random", "flat"])
def test_fast_nms_levels_kernel_exact(cuda, kind):
    """The fused K1 against its plain version, exact, on the 8-level x1.2
    pyramid of 480x640 (odd widths included), a random image and one of flat
    12 px blocks (NMS ties); then tiny and odd shapes with borders 0 and 2,
    where the -inf outside the image and the 3 px zeros reach the result."""
    rs = np.random.RandomState(2)
    if kind == "random":
        img = rs.rand(480, 640) * 255
    else:
        img = np.kron(rs.randint(0, 6, (41, 54)) * 50.0,
                      np.ones((12, 12)))[:480, :640]
    img = torch.from_numpy(img.astype(np.float32)).to(cuda)
    cases = [(build_pyramid(img, 8, 1.2), 16)]
    small = [img[:h, :w].contiguous() for h, w in ((7, 9), (33, 1), (40, 65))]
    cases += [(small, 0), (small, 2), (small, 16)]
    for levels, border in cases:
        got = kernels.fast_nms_levels(levels, 7.0, 20.0, border)
        want = F.fast_nms_levels_plain(levels, 7.0, 20.0, border)
        for g, p in zip(got, want):
            assert torch.equal(g[0], p[0]) and torch.equal(g[1], p[1])


@pytest.mark.parametrize("levels,fb_levels,win", [((3, 4), 1, 21),
                                                  ((1, 2), 2, 9),
                                                  ((4,), 1, 31)])
def test_lk_pyramid_kernel_matches_plain(cuda, levels, fb_levels, win):
    """The fused K3 against fb_klt_track per stream: where both track,
    points within 1e-3 px and err within 1e-4; status equal on >= 99.5%."""
    prev, nxt, pts, guess = _lk_case(cuda, 480, 640, 1256, seed=win)
    pyr_p = KLT.build_lk_pyramid(prev, 4)
    pyr_n = KLT.build_lk_pyramid(nxt, 4)
    kw = dict(fb_thresh=0.5, fb_levels=fb_levels, win=win, iters=10,
              min_eig=1e-4)
    guesses = [guess, None][:len(levels)]
    kernels.reset_launch_counts()
    got = KLT.fb_klt_track_streams(pyr_p, pyr_n, pts, guesses, list(levels),
                                   **kw)
    assert kernels.launch_counts["lk_pyramid"] == 1
    for k, g, lv in zip(got, guesses, levels):
        p = KLT.fb_klt_track(pyr_p, pyr_n, pts, g, max_levels=lv,
                             level_fn=KLT._track_level, **kw)
        both = k.status & p.status
        assert int(both.sum()) > 300
        assert int((k.status != p.status).sum()) <= 0.005 * len(both)
        assert float((k.pts - p.pts).abs()[both].max()) <= 1e-3
        assert float((k.err - p.err).abs()[both].max()) <= 1e-4
        assert torch.isfinite(k.pts).all()
    assert kernels.launch_counts["lk_level"] == 0   # nor did the plain one


def test_extract_and_of_launch_each_fused_kernel_once(cuda, monkeypatch):
    """extract() and of_dual_stream() on CUDA tensors launch the fused K1 and
    the fused K3 exactly once, the per-level kernels never; with a launcher
    made to raise, they raise (no way to the plain version)."""
    rs = np.random.RandomState(9)
    big = torch.from_numpy(rs.rand(34, 44).astype(np.float32) * 255)
    tex = torch.nn.functional.interpolate(
        big[None, None].to(cuda), size=(272, 352), mode="bicubic",
        align_corners=False)[0, 0].clamp(0, 255)
    g0 = tex[8:248, 8:328].contiguous()
    g1 = tex[10:250, 5:325].contiguous()
    depth = torch.full((240, 320), 2.0, device=cuda)
    fcfg = C.FrameConfig(orb=C.OrbConfig(n_features=300, n_levels=4,
                                         height=240, width=320),
                         n_of_slots=64, lk_levels=3, cloud_stride=8,
                         cloud_max_pts=512)
    kernels.reset_launch_counts()
    EX.extract(g0, fcfg.orb)
    assert kernels.launch_counts["fast_nms_levels"] == 1
    assert kernels.launch_counts["fast_scores"] == 0
    f0 = build_frame(g0, depth, fcfg, 200.0, 200.0, 160.0, 120.0)
    f1 = build_frame(g1, depth, fcfg, 200.0, 200.0, 160.0, 120.0)
    tcfg = C.SystemConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                          frame=fcfg).track_cfg()
    ms = M.create(8, f0.feat.capacity, 512, cuda)
    no_mp = torch.full((f0.feat.capacity,), M.NO_MP, dtype=torch.int32,
                       device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    args = (ms, f0, f1, no_mp, torch.eye(3, device=cuda),
            torch.zeros(3, device=cuda), gen, tcfg, OF.OFConfig(), 64)
    kernels.reset_launch_counts()
    _, _, n3d, n2d, _ = OF.of_dual_stream(*args)
    assert kernels.launch_counts["lk_pyramid"] == 1
    assert kernels.launch_counts["lk_level"] == 0
    assert int(n3d) == 0 and int(n2d) > 0

    def boom(*a, **k):
        raise RuntimeError("fused launcher reached")
    monkeypatch.setattr(kernels, "fast_nms_levels", boom)
    monkeypatch.setattr(kernels, "lk_pyramid", boom)
    with pytest.raises(RuntimeError, match="launcher reached"):
        EX.extract(g0, fcfg.orb)
    with pytest.raises(RuntimeError, match="launcher reached"):
        OF.of_dual_stream(*args)
