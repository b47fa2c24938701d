"""The fused FAST entry of the port on the CPU, where it runs its plain
version (ops/fast.py::fast_nms_levels_plain): FAST-9 at two thresholds, 3x3
non-maximum suppression and the border mask for all levels at once.

* Against the JAX package's fast_score_maps + nms3x3 and its border mask on
  numpy-seeded images, at three level shapes (one with odd sides), exact:
  the arithmetic is float32 adds in one order and comparisons. Borders 16
  (the default), 2 (inside the 3 px FAST border, so its zeros take part in
  the suppression next to -inf) and 0.
* extract() through the new entry against the per-level composition it had
  before (fast_scores_two, nms3x3, the mask, then detect_level) on the same
  image: keypoints, levels, angles, descriptors equal, so the rewiring of
  detect_level changes nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.ops import fast as JF

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops import extractor as TE
from geoflowslam_tpu_torch.ops import fast as TF
from geoflowslam_tpu_torch.ops import orb as TO
from geoflowslam_tpu_torch.ops import pyramid as TP

torch.set_num_threads(2)

SHAPES = [(120, 160), (97, 133), (61, 77)]


def _image(h, w, seed):
    """Random blocks (corners, and flat regions where NMS ties occur) plus
    mild noise on half of the image."""
    rs = np.random.RandomState(seed)
    img = np.kron(rs.rand(h // 6 + 1, w // 6 + 1) * 255,
                  np.ones((6, 6)))[:h, :w]
    img[:, : w // 2] += rs.rand(h, w // 2) * 30
    return np.clip(img, 0, 255).astype(np.float32)


def _reference(img, border):
    h, w = img.shape
    ys, xs = np.mgrid[0:h, 0:w]
    inb = ((ys >= border) & (ys < h - border)
           & (xs >= border) & (xs < w - border))
    return [np.where(inb, np.asarray(JF.nms3x3(s)), 0.0)
            for s in JF.fast_score_maps(jnp.asarray(img), [7.0, 20.0])]


@pytest.mark.parametrize("border", [16, 2, 0])
def test_fused_plain_matches_reference(border):
    imgs = [_image(h, w, seed=h + border) for h, w in SHAPES]
    got = TF.fast_nms_levels([torch.from_numpy(x) for x in imgs], 7.0, 20.0,
                             border)
    assert len(got) == len(SHAPES)
    for img, (lo, hi) in zip(imgs, got):
        want_lo, want_hi = _reference(img, border)
        np.testing.assert_array_equal(lo.numpy(), want_lo)
        np.testing.assert_array_equal(hi.numpy(), want_hi)
        assert (want_lo > 0).sum() > 10 and (want_hi > 0).sum() > 3


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_level_equals_its_parts(shape):
    """One level of the fused entry is fast_scores_two, nms3x3 and the mask,
    and its border really is zero."""
    img = torch.from_numpy(_image(*shape, seed=shape[1]))
    (lo, hi), = TF.fast_nms_levels([img], 7.0, 20.0)
    s_lo, s_hi = TF.fast_scores_two(img, 7.0, 20.0)
    for got, raw in ((lo, s_lo), (hi, s_hi)):
        want = TF.nms3x3(raw)
        assert torch.equal(got[16:-16, 16:-16], want[16:-16, 16:-16])
        inner = torch.zeros_like(got, dtype=torch.bool)
        inner[16:-16, 16:-16] = True
        assert not got[~inner].any()


def _extract_per_level(img, cfg):
    """extract() as it composed the detector before the fused entry."""
    levels = TP.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    out = []
    for lvl, (lv_img, quota, scale) in enumerate(
            zip(levels, cfg.per_level_quota(), cfg.scale_factors())):
        h, w = lv_img.shape
        s_low, s_high = TF.fast_scores_two(lv_img, cfg.min_th_fast,
                                           cfg.ini_th_fast)
        ys = torch.arange(h)[:, None]
        xs = torch.arange(w)[None, :]
        inb = (ys >= 16) & (ys < h - 16) & (xs >= 16) & (xs < w - 16)
        kp = TF.detect_level(torch.where(inb, TF.nms3x3(s_low), 0.0),
                             torch.where(inb, TF.nms3x3(s_high), 0.0), quota,
                             cell_size=cfg.cell_size,
                             per_cell_cap=cfg.per_cell_cap)
        ang, d = TO.orient_and_describe(lv_img, kp.xy)
        out.append((kp.xy * scale, kp.score, ang,
                    torch.full((quota,), lvl, dtype=torch.int32), d, kp.valid))
    return TE.FeatureSet(*(torch.cat(x) for x in zip(*out)))


@pytest.mark.parametrize("h,w,n_levels,n_features", [(120, 160, 3, 200),
                                                     (97, 133, 2, 120),
                                                     (150, 211, 4, 300)])
def test_extract_unchanged_by_the_fused_entry(h, w, n_levels, n_features,
                                              monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a kernel launcher was called for CPU tensors")
    monkeypatch.setattr(kernels, "fast_nms_levels", boom)
    cfg = C.OrbConfig(n_features=n_features, n_levels=n_levels, height=h,
                      width=w)
    img = torch.from_numpy(_image(h, w, seed=w))
    got = TE.extract(img, cfg)
    want = _extract_per_level(img, cfg)
    assert int(got.valid.sum()) > n_features // 4
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
