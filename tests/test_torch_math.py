"""Port parity: Lie-group functions and the synthetic renderer against the
JAX package, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoflowslam_tpu.io import synthetic as JS
from geoflowslam_tpu.math import lie as JL

from geoflowslam_tpu_torch.io import synthetic as TS
from geoflowslam_tpu_torch.math import lie as TL

torch.set_num_threads(2)

ATOL_LIE = 1e-5


# Angles in (1e-4, ~0.02) rad are left out: there the reference's float32
# (1 - cos t) / t^2 cancels to a few significant bits, so two correct float32
# implementations differ by ~1e-4. The Taylor branch (t^2 < 1e-8) and
# ordinary angles are compared.
def _vecs(n, scale, seed):
    rs = np.random.RandomState(seed)
    v = (rs.randn(n, 3) * scale).astype(np.float32)
    v[0] = 0.0                      # Taylor branch
    v[1] = 1e-5                     # near-zero branch
    return v


def _close(a, b, atol=ATOL_LIE):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("scale", [2e-5, 0.5, 2.5])
def test_so3(scale):
    phi = _vecs(64, scale, seed=int(scale * 1000) + 1)
    _close(JL.hat(jnp.asarray(phi)), TL.hat(torch.from_numpy(phi)))
    rj = JL.so3_exp(jnp.asarray(phi))
    rt = TL.so3_exp(torch.from_numpy(phi))
    _close(rj, rt)
    _close(JL.so3_right_jacobian(jnp.asarray(phi)),
           TL.so3_right_jacobian(torch.from_numpy(phi)))
    r = np.array(rj)
    _close(JL.quat_from_mat(jnp.asarray(r)), TL.quat_from_mat(torch.from_numpy(r)))
    _close(JL.so3_log(jnp.asarray(r)), TL.so3_log(torch.from_numpy(r)))
    noisy = r + np.random.RandomState(1).randn(*r.shape).astype(np.float32) * 1e-3
    _close(JL.normalize_rotation(jnp.asarray(noisy)),
           TL.normalize_rotation(torch.from_numpy(noisy)))


@pytest.mark.parametrize("scale", [2e-5, 0.7])
def test_se3(scale):
    rs = np.random.RandomState(5)
    xi = np.concatenate([rs.randn(32, 3) * 0.5, _vecs(32, scale, 6)],
                        1).astype(np.float32)
    rj, tj = JL.se3_exp(jnp.asarray(xi))
    rt, tt = TL.se3_exp(torch.from_numpy(xi))
    _close(rj, rt)
    _close(tj, tt)
    ra, ta = np.array(rj), np.array(tj)
    rb, tb = ra[::-1].copy(), ta[::-1].copy()
    cj = JL.se3_compose(*(jnp.asarray(x) for x in (ra, ta, rb, tb)))
    ct = TL.se3_compose(*(torch.from_numpy(x) for x in (ra, ta, rb, tb)))
    for a, b in zip(cj, ct):
        _close(a, b)
    for a, b in zip(JL.se3_inverse(jnp.asarray(ra), jnp.asarray(ta)),
                    TL.se3_inverse(torch.from_numpy(ra), torch.from_numpy(ta))):
        _close(a, b)


def test_synthetic_render_matches():
    """gray atol 1e-2 grey levels, depth atol 1e-4 m, 320x240, 3 poses."""
    w, h = 320, 240
    cam_j = JS.Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    cam_t = TS.Camera(fx=200.0, fy=200.0, cx=w / 2, cy=h / 2, width=w, height=h)
    seq_j = JS.SyntheticSequence(JS.SyntheticWorld(cam_j), fps=10.0)
    seq_t = TS.SyntheticSequence(TS.SyntheticWorld(cam_t, device="cpu"), fps=10.0)
    for t in (0.0, 1.7, 4.2):
        gj, dj, (rj, tj) = seq_j.frame(t)
        gt, dt, (rt, tt) = seq_t.frame(t)
        _close(rj, rt, 1e-6)
        _close(tj, tt, 1e-6)
        _close(gj, gt, 1e-2)
        _close(dj, dt, 1e-4)
    # the trajectory's derivatives too
    ts = np.linspace(0, 10, 7).astype(np.float32)
    for a, b in zip(JS.smooth_trajectory(jnp.asarray(ts)),
                    TS.smooth_trajectory(torch.from_numpy(ts))):
        _close(a, b)


def test_texture_lookup_clamps_at_the_edge():
    """float32 remainder(-tiny, 1023) rounds to 1023.0 exactly; the +1
    neighbour then clamps to the last texel (the reference's gather
    semantics) instead of indexing past the texture (a device assert on
    CUDA, seen at frame 313 of the 640x480 sequence)."""
    tex = torch.from_numpy(TS.make_texture(7))
    u = torch.tensor([-1e-9, 0.5], dtype=torch.float32)
    v = torch.tensor([0.25, -1e-9], dtype=torch.float32)
    assert float(torch.remainder(u[:1] * 97.0, 1023.0)) == 1023.0
    g = TS.sample_texture(tex, u, v)
    vi = float(torch.remainder(v[0] * 97.0, 1023.0))
    v0, dv = int(vi), vi - int(vi)
    want0 = float(tex[v0, 1023]) * (1 - dv) + float(tex[v0 + 1, 1023]) * dv
    assert abs(float(g[0]) - want0) < 1e-3
    ui = float(torch.remainder(u[1] * 97.0, 1023.0))
    u0, du = int(ui), ui - int(ui)
    want1 = float(tex[1023, u0]) * (1 - du) + float(tex[1023, u0 + 1]) * du
    assert abs(float(g[1]) - want1) < 1e-3
