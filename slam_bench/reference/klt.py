"""Plain reference of the optical-flow stage's forward-backward pyramidal
Lucas-Kanade track (what K3's fused launch, lk_pyramid, computes for each
stream).

A frozen copy of the plain versions in geoflowslam_tpu_torch/ops/klt.py
(build_lk_pyramid, _floor_index, _extract_patches, _bilinear_patch,
_track_level, klt_track, fb_klt_track) and ops/pyramid.py (gaussian_blur),
in plain PyTorch. It imports nothing of the program.
`lowp=True` rounds the pyramid levels, the template, its gradients and
each Gauss-Newton estimate to bfloat16: the comparison's control.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_INDEX_BOUND = float(2 ** 20)


def gaussian_blur(img, ksize, sigma):
    """Separable Gaussian blur, reflect padding (BORDER_REFLECT_101), the
    taps summed in order."""
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / np.sum(k)
    pad = ksize // 2
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, pad, pad), mode="reflect")[0, 0]
    out = None
    for i in range(ksize):
        term = x[i:i + h, :] * float(k[i])
        out = term if out is None else out + term
    x = F.pad(out[None, None], (pad, pad, 0, 0), mode="reflect")[0, 0]
    out = None
    for i in range(ksize):
        term = x[:, i:i + w] * float(k[i])
        out = term if out is None else out + term
    return out


def lk_pyramid(img, n_levels):
    """The flow's half-resolution pyramid: a 5x5 Gaussian (sigma 1.1)
    then every second pixel, per octave."""
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(gaussian_blur(levels[-1], 5, 1.1)[::2, ::2]
                      .contiguous())
    return levels


def _q(x, lowp):
    return x.to(torch.bfloat16).float() if lowp else x


def _floor_index(v):
    f = torch.nan_to_num(torch.floor(v), nan=0.0)
    return torch.clamp(f, -_INDEX_BOUND, _INDEX_BOUND).long()


def _extract_patches(img_padded, tl_xy, side):
    hp, wp = img_padded.shape
    ar = torch.arange(side, device=img_padded.device)

    def place(s, dim):
        return torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - side)

    sy = place(tl_xy[:, 1], hp)
    sx = place(tl_xy[:, 0], wp)
    return img_padded[(sy[:, None] + ar)[:, :, None],
                      (sx[:, None] + ar)[:, None, :]]


def _bilinear_patch(patch, frac_xy):
    fx = frac_xy[:, 0][:, None, None]
    fy = frac_xy[:, 1][:, None, None]
    return ((1 - fx) * (1 - fy) * patch[:, :-1, :-1]
            + fx * (1 - fy) * patch[:, :-1, 1:]
            + (1 - fx) * fy * patch[:, 1:, :-1]
            + fx * fy * patch[:, 1:, 1:])


def track_level(img_prev, img_next, pts_prev_lvl, guess_lvl, win, iters,
                min_eig, lowp=False):
    """One level for all points: (new guess [N, 2], ok [N], err [N])."""
    r = win // 2
    h, w = img_prev.shape
    pad = r + 2

    def edge_pad(img):
        return F.pad(_q(img, lowp)[None, None], (pad,) * 4,
                     mode="replicate")[0, 0]

    ip_prev, ip_next = edge_pad(img_prev), edge_pad(img_next)
    base_p = _floor_index(pts_prev_lvl)
    frac_p = pts_prev_lvl - torch.floor(pts_prev_lvl)
    patch_p = _extract_patches(ip_prev, base_p - (r + 1) + pad, win + 3)
    interp = _q(_bilinear_patch(patch_p, frac_p), lowp)
    tmpl = interp[:, 1:-1, 1:-1]
    ix = _q(0.5 * (interp[:, 1:-1, 2:] - interp[:, 1:-1, :-2]), lowp)
    iy = _q(0.5 * (interp[:, 2:, 1:-1] - interp[:, :-2, 1:-1]), lowp)
    gxx = torch.sum(ix * ix, dim=(1, 2))
    gxy = torch.sum(ix * iy, dim=(1, 2))
    gyy = torch.sum(iy * iy, dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp_min(tr * tr - 4 * det, 0.0)))
    good = eig_min / (win * win) > min_eig
    det_safe = torch.where(torch.abs(det) < 1e-9, 1e-9, det)

    def sample_cur(g):
        patch = _extract_patches(ip_next, _floor_index(g) - r + pad, win + 1)
        return _bilinear_patch(patch, g - torch.floor(g))

    g = guess_lvl
    for _ in range(iters):
        di = sample_cur(g) - tmpl
        bx = torch.sum(di * ix, dim=(1, 2))
        by = torch.sum(di * iy, dim=(1, 2))
        sx = -(gyy * bx - gxy * by) / det_safe
        sy = -(-gxy * bx + gxx * by) / det_safe
        g = _q(g + torch.where(good[:, None], torch.stack([sx, sy], dim=1),
                               0.0), lowp)
    err = torch.mean(torch.abs(sample_cur(g) - tmpl), dim=(1, 2))
    inb = ((g[:, 0] >= 0) & (g[:, 0] <= w - 1)
           & (g[:, 1] >= 0) & (g[:, 1] <= h - 1))
    return g, good & inb, err


def klt_track(pyr_prev, pyr_next, pts_prev, init_guess, scale_factor, win,
              iters, min_eig, n_levels, lowp=False):
    top = n_levels - 1
    g = init_guess * (1.0 / (scale_factor ** top))
    ok_all = torch.ones(pts_prev.shape[0], dtype=torch.bool,
                        device=pts_prev.device)
    err = torch.zeros(pts_prev.shape[0], device=pts_prev.device)
    for lvl in range(top, -1, -1):
        p_lvl = pts_prev * (1.0 / (scale_factor ** lvl))
        g, ok, err = track_level(pyr_prev[lvl], pyr_next[lvl], p_lvl, g, win,
                                 iters, min_eig, lowp)
        ok_all = ok_all & ok
        if lvl > 0:
            g = g * scale_factor
    return g, ok_all, err


def fb_track(pyr_prev, pyr_next, pts_prev, guess, n_levels, fb_levels,
             scale_factor, fb_thresh, win, iters, min_eig, lowp=False):
    """Forward over n_levels from `guess`, backward over the fb_levels finest
    levels from the forward estimate, the forward-backward gate:
    (pts [N, 2], status [N], err [N])."""
    n_levels = min(n_levels, len(pyr_prev))
    fpts, fok, ferr = klt_track(pyr_prev, pyr_next, pts_prev, guess,
                                scale_factor, win, iters, min_eig, n_levels,
                                lowp)
    bpts, bok, _ = klt_track(pyr_next, pyr_prev, fpts, fpts, scale_factor,
                             win, iters, min_eig, min(fb_levels, n_levels),
                             lowp)
    fb_err = torch.linalg.norm(bpts - pts_prev, dim=1)
    return fpts, fok & bok & (fb_err < fb_thresh), ferr
