"""Stereo matching (port of geoflowslam_tpu/ops/stereo.py).

* `stereo_match`: rectified pairs (Frame::ComputeStereoMatches). Every left
  keypoint is compared with the right image along its row over 64
  disparities by an 11x11 SAD of centre-subtracted patches (border clamp),
  all keypoints and disparities as one batched gather; the best and second
  cost gate the match and a parabola refines it to subpixel.
* `fisheye_stereo_match`: a dual-KB8 rig (Frame::ComputeStereoFishEyeMatches
  with KannalaBrandt8::TriangulateMatches): the lapping-area descriptors
  matched with Lowe's 0.7 ratio (one best-two Hamming search, the K4 kernel
  on the card), then per match the parallax gate, triangulation in the left
  camera and both chi-square reprojection gates in pinhole-equivalent
  pixels.
"""
from __future__ import annotations

import torch

from geoflowslam_tpu_torch.math.triangulate import triangulate_points
from geoflowslam_tpu_torch.ops import matching as MA


def stereo_match(img_l: torch.Tensor, img_r: torch.Tensor, uv: torch.Tensor,
                 valid: torch.Tensor, bf: float, min_disp: float = 0.5,
                 max_disp: int = 64, half: int = 5, sad_ratio: float = 0.9):
    """Match left keypoints uv [N, 2] into the right image. Returns (u_right
    [N], depth [N]), -1 where the match failed a gate."""
    h, w = img_l.shape
    dev = img_l.device
    ui = torch.round(uv[:, 0]).long()
    vi = torch.round(uv[:, 1]).long()
    offs = torch.arange(-half, half + 1, device=dev)
    disp = torch.arange(max_disp, device=dev)
    ys = torch.clamp(vi[:, None] + offs, 0, h - 1)              # [N, P]
    xs_l = torch.clamp(ui[:, None] + offs, 0, w - 1)            # [N, P]
    pl = img_l[ys[:, :, None], xs_l[:, None, :]]                # [N, P, P]
    pl = pl - pl[:, half:half + 1, half:half + 1]
    # right patches at every disparity: [N, D, P, P] in one gather
    xs_r = torch.clamp(ui[:, None, None] - disp[None, :, None]
                       + offs[None, None, :], 0, w - 1)         # [N, D, P]
    flat = ys[:, None, :, None] * w + xs_r[:, :, None, :]
    pr = img_r.reshape(-1)[flat]
    pr = pr - pr[:, :, half:half + 1, half:half + 1]
    costs = torch.abs(pl[:, None] - pr).sum(dim=(2, 3))         # [N, D]
    best = torch.argmin(costs, dim=1)
    c_best = costs.gather(1, best[:, None])[:, 0]
    second = torch.where(disp[None, :] == best[:, None], float("inf"),
                         costs).amin(dim=1)
    cm1 = costs.gather(1, torch.clamp(best - 1, 0, max_disp - 1)[:, None])[:, 0]
    cp1 = costs.gather(1, torch.clamp(best + 1, 0, max_disp - 1)[:, None])[:, 0]
    denom = cm1 + cp1 - 2 * c_best
    delta = torch.where(torch.abs(denom) > 1e-6,
                        0.5 * (cm1 - cp1) / torch.clamp_min(denom, 1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    d = best.float() + delta
    good = (valid & (d >= min_disp) & (best > 0) & (best < max_disp - 1)
            & (c_best < sad_ratio * second + 1e-6) & (ui - max_disp >= 0))
    ur = torch.where(good, ui.float() - d, -1.0)
    depth = torch.where(good, bf / torch.clamp_min(d, min_disp), -1.0)
    return ur, depth


def fisheye_stereo_match(rays_l, desc_l, mask_l, sigma2_l, rays_r, desc_r,
                         mask_r, sigma2_r, r_lr, t_lr, f_err: float = 400.0):
    """Stereo-fisheye matching and ray triangulation.

    rays_l [N, 3], rays_r [M, 3]: unit-depth rays of the keypoints; desc_*
    [., 8] int32 descriptor words; mask_*: validity and lapping area;
    sigma2_*: each keypoint's level sigma^2; r_lr, t_lr: right camera to
    left camera. The reprojection gates are evaluated in the
    pinhole-equivalent image (errors scaled by f_err). Returns (depth [N],
    z in the left camera, -1 where invalid; p3d [N, 3] left-camera points;
    match_idx [N] into the right keypoints or -1)."""
    m_idx, _ = MA.match_descriptors(desc_l, mask_l, desc_r, mask_r,
                                    max_dist=255, ratio=0.7, mutual=False)
    j = torch.clamp_min(m_idx, 0).long()
    r2 = rays_r[j]
    # the parallax gate in the left frame (r21 = R_lr r2)
    r21 = r2 @ r_lr.T
    cosp = (rays_l * r21).sum(-1) / torch.clamp_min(
        torch.linalg.norm(rays_l, dim=-1) * torch.linalg.norm(r21, dim=-1),
        1e-9)
    # the left camera as the world: P2 = [R_rl | -R_rl t_lr]
    rot21 = r_lr.T
    t21 = -rot21 @ t_lr
    p3d, cheir = triangulate_points(rays_l, r2, rot21, t21)
    z1 = p3d[:, 2]
    p2c = p3d @ rot21.T + t21
    e1 = (p3d[:, :2] / torch.clamp_min(z1[:, None], 1e-9)
          - rays_l[:, :2]) * f_err
    e2 = (p2c[:, :2] / torch.clamp_min(p2c[:, 2:3], 1e-9)
          - r2[:, :2]) * f_err
    ok = ((m_idx >= 0) & (cosp <= 0.9998) & cheir
          & ((e1 * e1).sum(-1) <= 5.991 * sigma2_l)
          & ((e2 * e2).sum(-1) <= 5.991 * sigma2_r[j])
          & (z1 > 1e-4))
    depth = torch.where(ok, z1, -1.0)
    return depth, p3d, torch.where(ok, m_idx, -1)
