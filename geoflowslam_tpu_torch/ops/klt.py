"""Pyramidal Lucas-Kanade optical flow, batched over points (port of
geoflowslam_tpu/ops/klt.py).

`_track_level` is the plain PyTorch version of one pyramid level: every
point runs the same fixed number of Gauss-Newton steps, and every patch is
a block of the edge-padded level whose start is placed as the reference's
jax.lax.dynamic_slice places it: a negative start counts from the far end of
the axis, then the start is clamped into the padded image. So a point left
of or above the image reads a block from the opposite side; such points
fail the in-image gate, but their Gauss-Newton path is the reference's.

`track_level` dispatches by device: a CUDA tensor goes to the hand-written
kernel (kernels/csrc/lk_level.cu), a CPU tensor to the plain version. The
kernel takes every level size and every window that fits in shared
memory. `fb_klt_track_streams` runs several forward-backward tracks of the
same points (each with its own guess and level count) at once: one launch
of the fused kernel for CUDA tensors, one `fb_klt_track` per stream, its
plain version, for CPU ones.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops.pyramid import gaussian_blur

# floor(g) is clamped to +-2^20 before the int cast: any value beyond the
# padded image gives the same clamped block start, and the cast stays in
# range for diverged guesses
_INDEX_BOUND = float(2 ** 20)


class KLTResult(NamedTuple):
    pts: torch.Tensor     # [N, 2] tracked positions (level-0 coords)
    status: torch.Tensor  # [N] bool
    err: torch.Tensor     # [N] mean abs residual over the window


def _floor_index(v: torch.Tensor) -> torch.Tensor:
    f = torch.nan_to_num(torch.floor(v), nan=0.0)
    return torch.clamp(f, -_INDEX_BOUND, _INDEX_BOUND).long()


def _extract_patches(img_padded: torch.Tensor, tl_xy: torch.Tensor,
                     side: int) -> torch.Tensor:
    """[N, side, side] blocks at top-left (x, y) corners, each start placed
    as jax.lax.dynamic_slice places it: a negative start counts from the end
    of the axis (once), then the start is clamped into [0, dim - side]."""
    hp, wp = img_padded.shape
    ar = torch.arange(side, device=img_padded.device)

    def place(s, dim):
        return torch.clamp(torch.where(s < 0, s + dim, s), 0, dim - side)

    sy = place(tl_xy[:, 1], hp)
    sx = place(tl_xy[:, 0], wp)
    return img_padded[(sy[:, None] + ar)[:, :, None],
                      (sx[:, None] + ar)[:, None, :]]


def _bilinear_patch(patch: torch.Tensor, frac_xy: torch.Tensor):
    """[N, P, P] blocks resampled at per-point fractional offsets ->
    [N, P-1, P-1] (four shifted views blended elementwise)."""
    fx = frac_xy[:, 0][:, None, None]
    fy = frac_xy[:, 1][:, None, None]
    return ((1 - fx) * (1 - fy) * patch[:, :-1, :-1]
            + fx * (1 - fy) * patch[:, :-1, 1:]
            + (1 - fx) * fy * patch[:, 1:, :-1]
            + fx * fy * patch[:, 1:, 1:])


def _track_level(img_prev, img_next, pts_prev_lvl, guess_lvl, win: int,
                 iters: int, min_eig: float):
    """One pyramid level of LK for all points (plain version of the
    kernel). Returns (new guess [N, 2], ok [N], err [N])."""
    r = win // 2
    h, w = img_prev.shape
    pad = r + 2

    def edge_pad(img):
        return F.pad(img[None, None], (pad, pad, pad, pad),
                     mode="replicate")[0, 0]

    ip_prev, ip_next = edge_pad(img_prev), edge_pad(img_next)
    # template + gradients at samples -(r+1)..(r+1) around pts_prev
    base_p = _floor_index(pts_prev_lvl)
    frac_p = pts_prev_lvl - torch.floor(pts_prev_lvl)
    patch_p = _extract_patches(ip_prev, base_p - (r + 1) + pad, win + 3)
    interp = _bilinear_patch(patch_p, frac_p)              # [N, win+2, win+2]
    tmpl = interp[:, 1:-1, 1:-1]
    ix = 0.5 * (interp[:, 1:-1, 2:] - interp[:, 1:-1, :-2])
    iy = 0.5 * (interp[:, 2:, 1:-1] - interp[:, :-2, 1:-1])
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
        return _bilinear_patch(patch, g - torch.floor(g))   # [N, win, win]

    g = guess_lvl
    for _ in range(iters):
        di = sample_cur(g) - tmpl
        bx = torch.sum(di * ix, dim=(1, 2))
        by = torch.sum(di * iy, dim=(1, 2))
        sx = -(gyy * bx - gxy * by) / det_safe
        sy = -(-gxy * bx + gxx * by) / det_safe
        g = g + torch.where(good[:, None], torch.stack([sx, sy], dim=1), 0.0)
    err = torch.mean(torch.abs(sample_cur(g) - tmpl), dim=(1, 2))
    inb = ((g[:, 0] >= 0) & (g[:, 0] <= w - 1)
           & (g[:, 1] >= 0) & (g[:, 1] <= h - 1))
    return g, good & inb, err


def track_level(img_prev, img_next, pts_lvl, guess_lvl, win: int, iters: int,
                min_eig: float):
    """One LK level: the CUDA kernel for CUDA tensors, the plain version for
    CPU ones. Returns (pts [N, 2], ok [N], err [N])."""
    if img_prev.is_cuda:
        return kernels.lk_level(img_prev.contiguous(), img_next.contiguous(),
                                pts_lvl.contiguous(), guess_lvl.contiguous(),
                                win, iters, min_eig)
    if img_prev.device.type != "cpu":
        raise ValueError(f"track_level: unsupported device {img_prev.device}")
    return _track_level(img_prev, img_next, pts_lvl, guess_lvl, win, iters,
                        min_eig)


def klt_track(pyr_prev: List[torch.Tensor], pyr_next: List[torch.Tensor],
              pts_prev: torch.Tensor,
              init_guess: Optional[torch.Tensor] = None,
              scale_factor: float = 2.0, win: int = 21, iters: int = 10,
              min_eig: float = 1e-4,
              max_levels: Optional[int] = None,
              level_fn=None) -> KLTResult:
    """Track pts_prev (level-0 coords) from pyr_prev to pyr_next, coarse to
    fine; `init_guess` (level-0 coords) seeds the search. Each level goes
    through `level_fn` (default: track_level, which dispatches by device).
    `level_fn=_track_level` holds a CUDA tensor to the plain version: it is
    for checks of a kernel against its plain version only, and no module of
    this package passes it."""
    if level_fn is None:
        level_fn = track_level
    n_levels = (len(pyr_prev) if max_levels is None
                else min(max_levels, len(pyr_prev)))
    if init_guess is None:
        init_guess = pts_prev
    top = n_levels - 1
    g = init_guess * (1.0 / (scale_factor ** top))
    ok_all = torch.ones(pts_prev.shape[0], dtype=torch.bool,
                        device=pts_prev.device)
    err = torch.zeros(pts_prev.shape[0], device=pts_prev.device)
    for lvl in range(top, -1, -1):
        p_lvl = pts_prev * (1.0 / (scale_factor ** lvl))
        g, ok, err = level_fn(pyr_prev[lvl], pyr_next[lvl], p_lvl, g, win,
                              iters, min_eig)
        ok_all = ok_all & ok
        if lvl > 0:
            g = g * scale_factor
    return KLTResult(pts=g, status=ok_all, err=err)


def fb_klt_track(pyr_prev, pyr_next, pts_prev, init_guess=None,
                 fb_thresh: float = 1.0, fb_levels: int = 1,
                 **kw) -> KLTResult:
    """Forward-backward LK with a consistency gate; the backward pass starts
    at the forward estimate and runs only the `fb_levels` finest levels."""
    fwd = klt_track(pyr_prev, pyr_next, pts_prev, init_guess, **kw)
    kw_b = dict(kw)
    kw_b["max_levels"] = min(fb_levels, kw.get("max_levels", fb_levels))
    bwd = klt_track(pyr_next, pyr_prev, fwd.pts, fwd.pts, **kw_b)
    fb_err = torch.linalg.norm(bwd.pts - pts_prev, dim=1)
    status = fwd.status & bwd.status & (fb_err < fb_thresh)
    return KLTResult(pts=fwd.pts, status=status, err=fwd.err)


def fb_klt_track_streams(pyr_prev, pyr_next, pts_prev: torch.Tensor,
                         init_guesses: Sequence[Optional[torch.Tensor]],
                         max_levels: Sequence[Optional[int]],
                         fb_thresh: float = 1.0, fb_levels: int = 1,
                         scale_factor: float = 2.0, win: int = 21,
                         iters: int = 10,
                         min_eig: float = 1e-4) -> List[KLTResult]:
    """fb_klt_track of pts_prev for several streams: stream s starts at
    init_guesses[s] (None: at pts_prev) and runs max_levels[s] levels (None:
    the whole pyramid). One launch of the fused CUDA kernel for CUDA tensors,
    one fb_klt_track per stream for CPU ones."""
    if len(init_guesses) != len(max_levels):
        raise ValueError("fb_klt_track_streams: one guess and one level "
                         "count per stream")
    levels = [len(pyr_prev) if m is None else min(m, len(pyr_prev))
              for m in max_levels]
    dev = pts_prev.device
    if dev.type == "cuda":
        used = max(levels)
        guess = torch.stack([pts_prev if g is None else g
                             for g in init_guesses])
        pts = pts_prev.expand(len(levels), -1, -1).contiguous()
        out, status, err = kernels.lk_pyramid(
            [x.contiguous() for x in pyr_prev[:used]],
            [x.contiguous() for x in pyr_next[:used]], pts, guess, levels,
            fb_levels, scale_factor, fb_thresh, win, iters, min_eig)
        return [KLTResult(pts=out[s], status=status[s], err=err[s])
                for s in range(len(levels))]
    if dev.type != "cpu":
        raise ValueError(f"fb_klt_track_streams: unsupported device {dev}")
    return [fb_klt_track(pyr_prev, pyr_next, pts_prev, g, fb_thresh=fb_thresh,
                         fb_levels=fb_levels, scale_factor=scale_factor,
                         win=win, iters=iters, min_eig=min_eig, max_levels=m)
            for g, m in zip(init_guesses, levels)]


def build_lk_pyramid(img: torch.Tensor, n_levels: int) -> List[torch.Tensor]:
    """Half-resolution pyramid with 5x5 Gaussian smoothing per octave
    (cv::buildOpticalFlowPyramid analogue)."""
    levels = [img]
    for _ in range(1, n_levels):
        levels.append(
            gaussian_blur(levels[-1], 5, 1.1)[::2, ::2].contiguous())
    return levels
