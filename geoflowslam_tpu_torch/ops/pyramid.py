"""Image pyramid, separable Gaussian blur and CLAHE (port of
geoflowslam_tpu/ops/pyramid.py). Images are float32 [H, W] in [0, 255].

`resize_bilinear` antialiases when it downsamples, as jax.image.resize
does; the two agree to about 5e-3 grey levels, not bit for bit, so FAST
keypoints on levels >= 1 can differ at threshold edges. CLAHE uses integer
histograms and a gather LUT in place of the reference's bf16 one-hot
matmuls; both are exact, and the LUT's float32 cumsum is exact too (its
terms are binary fractions well inside float32's mantissa).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int,
                   scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (h, w), matching cv::resize rounding in the reference."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize, antialiased on downsampling (jax.image.resize)."""
    return F.interpolate(img[None, None], size=(out_h, out_w), mode="bilinear",
                         antialias=True, align_corners=False)[0, 0]


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """List of [h_l, w_l] float32 levels; each level is resized from the
    previous one, as the reference does."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], *shapes[lvl]))
    return levels


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding (BORDER_REFLECT_101),
    taps summed in the reference's order."""
    k = gaussian_kernel1d(ksize, sigma)
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


def clahe(img: torch.Tensor, clip_limit: float = 3.0, grid: int = 8,
          n_bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization, the equivalent of
    cv::createCLAHE(3.0, (8, 8)). Requires H, W divisible by `grid`."""
    h, w = img.shape
    th, tw = h // grid, w // grid
    n_tiles = grid * grid
    p = th * tw
    x = torch.clamp(img, 0, 255)
    tiles = (x.reshape(grid, th, grid, tw).permute(0, 2, 1, 3)
             .reshape(n_tiles, p))
    idx = torch.clamp(torch.round(tiles), 0, 255).long()
    hist = torch.zeros((n_tiles, n_bins), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(tiles))

    # clip and redistribute the excess uniformly (OpenCV semantics)
    limit = max(clip_limit * p / n_bins, 1.0)
    clipped = torch.clamp_max(hist, limit)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / n_bins, dim=1)
    lut = torch.clamp(torch.round(cdf * (255.0 / p)), 0, 255)
    lut2d = lut.reshape(grid, grid, n_bins)

    ty = torch.arange(grid, device=img.device)

    def shifted(dy, dx):
        """Per-pixel LUT value of the tile shifted by (dy, dx), [T, P]."""
        yy = torch.clamp(ty + dy, 0, grid - 1)
        xx = torch.clamp(ty + dx, 0, grid - 1)
        sel = lut2d[yy[:, None], xx[None, :]].reshape(n_tiles, n_bins)
        return torch.gather(sel, 1, idx)

    def t2d(v):  # [T, P] -> [H, W]
        return (v.reshape(grid, grid, th, tw).permute(0, 2, 1, 3)
                .reshape(h, w))

    # bilinear weights within each tile (pixel at local (py, px))
    py = (torch.arange(th, dtype=torch.float32, device=img.device) + 0.5) \
        / th - 0.5
    px = (torch.arange(tw, dtype=torch.float32, device=img.device) + 0.5) \
        / tw - 0.5
    wy_up = torch.clamp_min(-py, 0.0)[:, None].repeat(grid, 1)
    wy_dn = torch.clamp_min(py, 0.0)[:, None].repeat(grid, 1)
    wy_c = 1.0 - wy_up - wy_dn
    wx_lf = torch.clamp_min(-px, 0.0)[None, :].repeat(1, grid)
    wx_rt = torch.clamp_min(px, 0.0)[None, :].repeat(1, grid)
    wx_c = 1.0 - wx_lf - wx_rt

    return (
        t2d(shifted(0, 0)) * wy_c * wx_c
        + t2d(shifted(-1, 0)) * wy_up * wx_c
        + t2d(shifted(1, 0)) * wy_dn * wx_c
        + t2d(shifted(0, -1)) * wy_c * wx_lf
        + t2d(shifted(0, 1)) * wy_c * wx_rt
        + t2d(shifted(-1, -1)) * wy_up * wx_lf
        + t2d(shifted(-1, 1)) * wy_up * wx_rt
        + t2d(shifted(1, -1)) * wy_dn * wx_lf
        + t2d(shifted(1, 1)) * wy_dn * wx_rt
    )
