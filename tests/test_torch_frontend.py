"""Port parity of the frame build: CLAHE, pyramid, FAST, keypoints,
orientation, descriptors, depth cloud and the whole build_frame, against
the JAX package on the same images (the reference's XLA paths, as on CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io.synthetic import Camera, SyntheticSequence, SyntheticWorld
from geoflowslam_tpu.ops import fast as JF
from geoflowslam_tpu.ops import orb as JO
from geoflowslam_tpu.ops import pointcloud as JPC
from geoflowslam_tpu.ops import pyramid as JP
from geoflowslam_tpu.ops.extractor import OrbConfig as JOrb
from geoflowslam_tpu.state.frame import FrameConfig as JFrame
from geoflowslam_tpu.state.frame import build_frame as j_build_frame

from geoflowslam_tpu_torch import config as C
from geoflowslam_tpu_torch.ops import fast as TF
from geoflowslam_tpu_torch.ops import orb as TO
from geoflowslam_tpu_torch.ops import pointcloud as TPC
from geoflowslam_tpu_torch.ops import pyramid as TP
from geoflowslam_tpu_torch.state.frame import build_frame as t_build_frame

torch.set_num_threads(2)

W, H = 320, 240
FX = 200.0


@pytest.fixture(scope="module")
def images():
    """Two frames of the e2e scenario, rendered by the reference."""
    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    seq = SyntheticSequence(SyntheticWorld(cam), fps=10.0)
    out = []
    for t in (0.0, 2.3):
        g, d, _ = seq.frame(t)
        out.append((np.array(g), np.array(d)))
    return out


def T(a):
    return torch.from_numpy(np.array(a))


def test_clahe(images):
    """max diff <= 1 grey level, >= 99.9% of pixels exact."""
    for g, _ in images:
        a = np.asarray(JP.clahe(jnp.asarray(g)))
        b = TP.clahe(T(g)).numpy()
        diff = np.abs(a - b)
        assert diff.max() <= 1.0
        assert (diff == 0).mean() >= 0.999


def test_pyramid_and_blur(images):
    """atol 1e-2 (the antialiased resizes agree to ~5e-3 at 640x480)."""
    g = np.asarray(JP.clahe(jnp.asarray(images[0][0])))
    lj = JP.build_pyramid(jnp.asarray(g), 4, 1.2)
    lt = TP.build_pyramid(T(g), 4, 1.2)
    assert [tuple(x.shape) for x in lj] == [tuple(x.shape) for x in lt]
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-2, rtol=0)
    np.testing.assert_allclose(np.asarray(JP.gaussian_blur(jnp.asarray(g))),
                               TP.gaussian_blur(T(g)).numpy(), atol=1e-3,
                               rtol=0)


@pytest.mark.parametrize("shape", [(240, 320), (133, 179), (97, 211)])
def test_fast_score_maps_exact(shape):
    img = (np.random.RandomState(shape[1]).rand(*shape) * 255).astype(np.float32)
    for a, b in zip(JF.fast_score_maps(jnp.asarray(img), [7.0, 20.0]),
                    TF.fast_scores_two(T(img), 7.0, 20.0)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_detect_orient_describe(images):
    """The JAX level image goes to both sides: the same keypoints, angles
    within 1e-5 rad, bit-equal descriptors."""
    g = np.asarray(JP.clahe(jnp.asarray(images[1][0])))
    levels = JP.build_pyramid(jnp.asarray(g), 4, 1.2)
    maps = TF.fast_nms_levels([T(lvl) for lvl in levels], 7.0, 20.0)
    for lvl, (s_low, s_high), quota in zip(
            levels, maps, JOrb(n_features=400, n_levels=4).per_level_quota()):
        kj = JF.detect_level(lvl, quota, 20.0, 7.0)
        kt = TF.detect_level(s_low, s_high, quota)
        np.testing.assert_array_equal(np.asarray(kj.xy), kt.xy.numpy())
        np.testing.assert_array_equal(np.asarray(kj.score), kt.score.numpy())
        np.testing.assert_array_equal(np.asarray(kj.valid), kt.valid.numpy())
        aj, dj = JO.orient_and_describe(lvl, kj.xy)
        at, dt = TO.orient_and_describe(T(lvl), kt.xy)
        np.testing.assert_allclose(np.asarray(aj), at.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(np.asarray(dj).view(np.int32),
                                      dt.numpy())


def test_depth_cloud(images):
    d = images[0][1]
    pj, mj = JPC.depth_to_cloud(jnp.asarray(d), FX, FX, W / 2, H / 2, stride=4)
    pt, mt = TPC.depth_to_cloud(T(d), FX, FX, W / 2, H / 2, stride=4)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-6, rtol=0)
    cj, vj = JPC.voxel_downsample(pj, mj, 0.05, 1024)
    ct, vt = TPC.voxel_downsample(T(pj), T(mj), 0.05, 1024)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())


def test_build_frame(images):
    """>= 95% of level-0 keypoints shared, depth cloud equal (jitted
    reference)."""
    jcfg = JFrame(orb=JOrb(n_features=400, n_levels=4, height=H, width=W),
                  lk_levels=3, cloud_stride=8, cloud_max_pts=1024, bf=20.0)
    tcfg = C.FrameConfig(orb=C.OrbConfig(n_features=400, n_levels=4,
                                         height=H, width=W),
                         lk_levels=3, cloud_stride=8, cloud_max_pts=1024,
                         bf=20.0)
    jbf = jax.jit(lambda g, d: j_build_frame(g, d, jcfg, FX, FX, W / 2, H / 2))
    for g, d in images:
        fj = jbf(jnp.asarray(g), jnp.asarray(d))
        ft = t_build_frame(T(g), T(d), tcfg, FX, FX, W / 2, H / 2)
        lv0 = np.asarray(fj.feat.level) == 0
        kj = {tuple(p) for p in np.asarray(fj.feat.uv)[lv0 & np.asarray(
            fj.feat.valid)]}
        kt = {tuple(p) for p in ft.feat.uv.numpy()[lv0 & ft.feat.valid.numpy()]}
        assert len(kj) > 50
        assert len(kj & kt) >= 0.95 * len(kj)
        # the same points in the same order; XLA's fused back-projection
        # rounds differently in the last bit
        np.testing.assert_array_equal(np.asarray(fj.cloud_valid),
                                      ft.cloud_valid.numpy())
        np.testing.assert_allclose(np.asarray(fj.cloud), ft.cloud.numpy(),
                                   rtol=1e-6, atol=0)
        for a, b in zip(fj.lk_pyramid, ft.lk_pyramid):
            np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-3,
                                       rtol=0)
