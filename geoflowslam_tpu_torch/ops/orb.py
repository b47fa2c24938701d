"""ORB orientation + steered BRIEF-256 on per-keypoint patches (port of the
patch path of geoflowslam_tpu/ops/orb.py, `orient_and_describe`).

One 45x45 patch per keypoint is cut from the reflect-padded level image;
orientation is the intensity centroid over the reference's 31x31 disc,
descriptors are the seeded Gaussian pair pattern (numpy RandomState(12345),
the same pattern as the reference) sampled on the 7x7, sigma 2 blurred
patch. Descriptors are [N, 8] int32 words holding the reference's uint32
bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from geoflowslam_tpu_torch.ops.pyramid import gaussian_kernel1d
from geoflowslam_tpu_torch.utils.device_const import device_constant

PATCH_SIZE = 31
HALF_PATCH = 15
N_BITS = 256
BLUR_K = 7
BLUR_MARGIN = BLUR_K // 2
# max |rotated pattern offset| = 13*sqrt(2) ~ 18.39, +0.5 rounding -> 19;
# +3 blur margin -> raw patch half-width 22.
RAW_PATCH = 45
BLUR_PATCH = RAW_PATCH - 2 * BLUR_MARGIN   # 39


def _umax_per_row():
    """Half-width of the centroid disc per |dy| (the reference's umax)."""
    r = HALF_PATCH
    return [int(np.floor(np.sqrt(max(r * r + r * 0.5 - v * v, 0.0))))
            for v in range(r + 1)]


def circular_masks():
    """x- and y-weighted 31x31 disc masks for the intensity centroid."""
    umax = _umax_per_row()
    vs, us = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    rows = np.array([umax[abs(v)] for v in range(-HALF_PATCH, HALF_PATCH + 1)])
    disc = np.abs(us) <= rows[:, None]
    return (us * disc).astype(np.float32), (vs * disc).astype(np.float32)


def get_pattern() -> np.ndarray:
    """Deterministic Gaussian BRIEF pattern [256, 4] int32 (x1, y1, x2, y2),
    points ~ N(0, (patch/5)^2) clipped to the patch (BRIEF paper G-II)."""
    rng = np.random.RandomState(12345)
    sigma = PATCH_SIZE / 5.0
    pts = rng.randn(N_BITS, 4) * sigma
    pts = np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts.astype(np.int32)


def _slices(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor, size: int):
    """[N, size, size] windows of img [B?, H, W] starting at (y0, x0)."""
    ar = torch.arange(size, device=img.device)
    yy = (y0[:, None] + ar)[:, :, None]
    xx = (x0[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return img[yy, xx]
    n = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[n, yy, xx]


def extract_patches(img: torch.Tensor, xy: torch.Tensor,
                    patch: int = RAW_PATCH, margin: int = BLUR_MARGIN):
    """One patch per keypoint from the reflect-padded level image: returns
    (patches [N, patch, patch], fx [N], fy [N]) with (fx, fy) the keypoint in
    patch coordinates. The padding makes the valid blur of a patch equal to
    a window of the full-image blur, borders included."""
    h, w = img.shape
    imgp = F.pad(img[None, None], (margin,) * 4, mode="reflect")[0, 0]
    ix = torch.round(xy[:, 0]).long() + margin
    iy = torch.round(xy[:, 1]).long() + margin
    x0 = torch.clamp(ix - patch // 2, 0, w + 2 * margin - patch)
    y0 = torch.clamp(iy - patch // 2, 0, h + 2 * margin - patch)
    fx = xy[:, 0] + margin - x0.to(xy.dtype)
    fy = xy[:, 1] + margin - y0.to(xy.dtype)
    return _slices(imgp, y0, x0, patch), fx, fy


def orientation_from_patches(patches, fx, fy) -> torch.Tensor:
    """Intensity-centroid angles from the 31x31 disc around each keypoint
    (start clamped into the patch, as lax.dynamic_slice clamps)."""
    dev = patches.device
    mx = device_constant("orb_mask_x", lambda: circular_masks()[0], dev)
    my = device_constant("orb_mask_y", lambda: circular_masks()[1], dev)
    d = 2 * HALF_PATCH + 1
    lim = patches.shape[1] - d
    cx = torch.clamp(torch.round(fx).long() - HALF_PATCH, 0, lim)
    cy = torch.clamp(torch.round(fy).long() - HALF_PATCH, 0, lim)
    disc = _slices(patches, cy, cx, d)
    m10 = torch.einsum("nrc,rc->n", disc, mx.to(disc.dtype))
    m01 = torch.einsum("nrc,rc->n", disc, my.to(disc.dtype))
    return torch.atan2(m01, m10)


def blur_patches(patches: torch.Tensor, ksize: int = BLUR_K,
                 sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian (valid) on raw patches, taps in the
    reference's order."""
    k = gaussian_kernel1d(ksize, sigma)
    p = patches.shape[1]
    o = p - 2 * (ksize // 2)
    out = None
    for i in range(ksize):
        term = patches[:, i:i + o, :] * float(k[i])
        out = term if out is None else out + term
    x = out
    out = None
    for i in range(ksize):
        term = x[:, :, i:i + o] * float(k[i])
        out = term if out is None else out + term
    return out


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 words (bit j of word w = element
    32 w + j), built in int64 and wrapped to int32 explicitly."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(-1, 8, 32).long() << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def descriptors_from_patches(blurred: torch.Tensor, fx, fy,
                             angles: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 from blurred patches [N, 39, 39] -> [N, 8] int32:
    sample = round(R(angle) pattern + in-patch position) - margin, clipped
    to the blurred patch."""
    bp = BLUR_PATCH
    pat = device_constant("orb_pattern", get_pattern, blurred.device)
    ca, sa = torch.cos(angles), torch.sin(angles)
    pp = torch.cat([pat[:, 0:2], pat[:, 2:4]], dim=0)            # [512, 2]
    rx = pp[None, :, 0] * ca[:, None] - pp[None, :, 1] * sa[:, None]
    ry = pp[None, :, 0] * sa[:, None] + pp[None, :, 1] * ca[:, None]
    xi = torch.clamp(torch.round(rx + fx[:, None]).long() - BLUR_MARGIN,
                     0, bp - 1)
    yi = torch.clamp(torch.round(ry + fy[:, None]).long() - BLUR_MARGIN,
                     0, bp - 1)
    s = torch.gather(blurred.reshape(blurred.shape[0], -1), 1, yi * bp + xi)
    return pack_bits(s[:, :256] < s[:, 256:])


def orient_and_describe(img: torch.Tensor, xy: torch.Tensor):
    """Patches -> (angles [N], descriptors [N, 8] int32) for one level."""
    patches, fx, fy = extract_patches(img, xy)
    ang = orientation_from_patches(patches, fx, fy)
    desc = descriptors_from_patches(blur_patches(patches), fx, fy, ang)
    return ang, desc
