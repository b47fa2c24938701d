"""Plain reference of the frame build's feature stage: CLAHE, the image
pyramid, two-threshold FAST-9 with 3x3 NMS and the border mask, the per-cell
and global keypoint selection, the intensity-centroid orientation and
steered BRIEF-256.

A frozen copy of the plain versions in geoflowslam_tpu_torch/ops/pyramid.py
(clahe, build_pyramid, gaussian_kernel1d), ops/fast.py (fast_score_maps,
nms3x3, fast_nms_levels_plain, detect_level), ops/indexing.py (topk_stable),
ops/orb.py (orient_and_describe and its pattern and masks) and
ops/extractor.py (extract), in plain PyTorch. It imports nothing of the
program. `lowp=True` rounds every image the stage makes (the CLAHE output,
each pyramid level, the FAST ring differences, the blurred patches) to
bfloat16: the comparison's control.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
          (-3, -1))
PATCH_SIZE, HALF_PATCH, N_BITS = 31, 15, 256
BLUR_K = 7
BLUR_MARGIN = BLUR_K // 2
RAW_PATCH = 45
BLUR_PATCH = RAW_PATCH - 2 * BLUR_MARGIN


def _q(x: torch.Tensor, lowp: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if lowp else x


def topk_stable(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def per_level_quota(n_features, scale_factor, n_levels):
    inv = 1.0 / scale_factor
    n_desired = n_features * (1 - inv) / (1 - inv ** n_levels)
    quotas, total = [], 0
    for lvl in range(n_levels - 1):
        q = int(round(n_desired * inv ** lvl))
        quotas.append(q)
        total += q
    quotas.append(max(n_features - total, 0))
    return quotas


def pyramid_shapes(h, w, n_levels, scale_factor):
    return [(int(round(h / scale_factor ** lvl)),
             int(round(w / scale_factor ** lvl))) for lvl in range(n_levels)]


def build_pyramid(img, n_levels, scale_factor, lowp=False):
    shapes = pyramid_shapes(*img.shape, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(_q(F.interpolate(
            levels[-1][None, None], size=shapes[lvl], mode="bilinear",
            antialias=True, align_corners=False)[0, 0], lowp))
    return levels


def gaussian_kernel1d(ksize, sigma):
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float32) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / np.sum(k)


def clahe(img, clip_limit=3.0, grid=8, n_bins=256):
    """cv::createCLAHE(3.0, (8, 8)) with integer histograms and a LUT."""
    h, w = img.shape
    th, tw = h // grid, w // grid
    n_tiles, p = grid * grid, th * tw
    x = torch.clamp(img, 0, 255)
    tiles = (x.reshape(grid, th, grid, tw).permute(0, 2, 1, 3)
             .reshape(n_tiles, p))
    idx = torch.clamp(torch.round(tiles), 0, 255).long()
    hist = torch.zeros((n_tiles, n_bins), dtype=torch.float32,
                       device=img.device)
    hist.scatter_add_(1, idx, torch.ones_like(tiles))
    limit = max(clip_limit * p / n_bins, 1.0)
    clipped = torch.clamp_max(hist, limit)
    excess = torch.sum(hist - clipped, dim=1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / n_bins, dim=1)
    lut2d = torch.clamp(torch.round(cdf * (255.0 / p)), 0, 255).reshape(
        grid, grid, n_bins)
    ty = torch.arange(grid, device=img.device)

    def shifted(dy, dx):
        yy = torch.clamp(ty + dy, 0, grid - 1)
        xx = torch.clamp(ty + dx, 0, grid - 1)
        sel = lut2d[yy[:, None], xx[None, :]].reshape(n_tiles, n_bins)
        return (torch.gather(sel, 1, idx).reshape(grid, grid, th, tw)
                .permute(0, 2, 1, 3).reshape(h, w))

    f32 = dict(dtype=torch.float32, device=img.device)
    py = (torch.arange(th, **f32) + 0.5) / th - 0.5
    px = (torch.arange(tw, **f32) + 0.5) / tw - 0.5
    wy_up = torch.clamp_min(-py, 0.0)[:, None].repeat(grid, 1)
    wy_dn = torch.clamp_min(py, 0.0)[:, None].repeat(grid, 1)
    wy_c = 1.0 - wy_up - wy_dn
    wx_lf = torch.clamp_min(-px, 0.0)[None, :].repeat(1, grid)
    wx_rt = torch.clamp_min(px, 0.0)[None, :].repeat(1, grid)
    wx_c = 1.0 - wx_lf - wx_rt
    return (shifted(0, 0) * wy_c * wx_c
            + shifted(-1, 0) * wy_up * wx_c
            + shifted(1, 0) * wy_dn * wx_c
            + shifted(0, -1) * wy_c * wx_lf
            + shifted(0, 1) * wy_c * wx_rt
            + shifted(-1, -1) * wy_up * wx_lf
            + shifted(-1, 1) * wy_up * wx_rt
            + shifted(1, -1) * wy_dn * wx_lf
            + shifted(1, 1) * wy_dn * wx_rt)


def _arc_ok(bits):
    m = bits | (bits << 16)
    t = m & (m >> 1)
    t = t & (t >> 2)
    t = t & (t >> 4)
    t = t & (m >> 8)
    return (t & 0xFFFF) != 0


def fast_score_maps(img, thresholds, lowp=False):
    h, w = img.shape
    r = 3
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    diffs = [_q(pad[r + dy: r + dy + h, r + dx: r + dx + w] - img, lowp)
             for dy, dx in CIRCLE]
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inside = (ys >= r) & (ys < h - r) & (xs >= r) & (xs < w - r)
    out = []
    for threshold in thresholds:
        bright = torch.zeros((h, w), dtype=torch.int64, device=img.device)
        dark = torch.zeros_like(bright)
        sb = torch.zeros_like(img)
        sd = torch.zeros_like(img)
        for k, d in enumerate(diffs):
            bright = bright | ((d > threshold).long() << k)
            dark = dark | ((d < -threshold).long() << k)
            sb = sb + torch.clamp_min(d - threshold, 0.0)
            sd = sd + torch.clamp_min(-d - threshold, 0.0)
        score = (torch.where(_arc_ok(bright), sb, 0.0)
                 + torch.where(_arc_ok(dark), sd, 0.0))
        out.append(torch.where(inside, score, 0.0))
    return out


def nms3x3(score):
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.maximum(m, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return torch.where(score >= m, score, 0.0)


def fast_nms_levels(levels, th_lo, th_hi, border=16, lowp=False):
    """Per level the (low, high) threshold maps after NMS and the border
    mask: what the fused K1 (fast_nms_levels) computes."""
    out = []
    for img in levels:
        h, w = img.shape
        ys = torch.arange(h, device=img.device)[:, None]
        xs = torch.arange(w, device=img.device)[None, :]
        inb = ((ys >= border) & (ys < h - border)
               & (xs >= border) & (xs < w - border))
        out.append(tuple(torch.where(inb, nms3x3(s), 0.0)
                         for s in fast_score_maps(img, [th_lo, th_hi], lowp)))
    return out


def detect_level(score_low, score_high, n_keypoints, cell_size=32,
                 per_cell_cap=8):
    h, w = score_low.shape
    dev = score_low.device
    ph = (h + cell_size - 1) // cell_size * cell_size
    pw = (w + cell_size - 1) // cell_size * cell_size
    ncy, ncx = ph // cell_size, pw // cell_size

    def cells(s):
        s = F.pad(s, (0, pw - w, 0, ph - h))
        return (s.reshape(ncy, cell_size, ncx, cell_size).permute(0, 2, 1, 3)
                .reshape(ncy * ncx, cell_size * cell_size))

    cl, ch = cells(score_low), cells(score_high)
    eligible = torch.where(torch.any(ch > 0, dim=1, keepdim=True), ch, cl)
    top_s, top_i = topk_stable(eligible, per_cell_cap)
    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    gy = ((cell_ids // ncx) * cell_size + top_i // cell_size).reshape(-1)
    gx = ((cell_ids % ncx) * cell_size + top_i % cell_size).reshape(-1)
    flat_s = top_s.reshape(-1)
    n = min(n_keypoints, flat_s.shape[0])
    sel_s, sel_i = topk_stable(flat_s, n)
    xy = torch.stack([gx[sel_i], gy[sel_i]], dim=-1).float()
    valid = sel_s > 0
    if n < n_keypoints:
        padn = n_keypoints - n
        xy = torch.cat([xy, xy.new_zeros((padn, 2))])
        sel_s = torch.cat([sel_s, sel_s.new_zeros((padn,))])
        valid = torch.cat([valid, valid.new_zeros((padn,))])
    return xy, sel_s, valid


def _circular_masks():
    r = HALF_PATCH
    umax = [int(np.floor(np.sqrt(max(r * r + r * 0.5 - v * v, 0.0))))
            for v in range(r + 1)]
    vs, us = np.mgrid[-r:r + 1, -r:r + 1]
    rows = np.array([umax[abs(v)] for v in range(-r, r + 1)])
    disc = np.abs(us) <= rows[:, None]
    return (us * disc).astype(np.float32), (vs * disc).astype(np.float32)


def _pattern():
    rng = np.random.RandomState(12345)
    pts = rng.randn(N_BITS, 4) * (PATCH_SIZE / 5.0)
    pts = np.clip(np.round(pts), -(HALF_PATCH - 2), HALF_PATCH - 2)
    same = (pts[:, 0] == pts[:, 2]) & (pts[:, 1] == pts[:, 3])
    pts[same, 2] += 1
    return pts.astype(np.int32)


def _slices(img, y0, x0, size):
    ar = torch.arange(size, device=img.device)
    yy = (y0[:, None] + ar)[:, :, None]
    xx = (x0[:, None] + ar)[:, None, :]
    if img.dim() == 2:
        return img[yy, xx]
    n = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[n, yy, xx]


def orient_and_describe(img, xy, lowp=False):
    """(angles [N], descriptors [N, 8] int32) of one level's keypoints."""
    h, w = img.shape
    m = BLUR_MARGIN
    imgp = F.pad(img[None, None], (m,) * 4, mode="reflect")[0, 0]
    ix = torch.round(xy[:, 0]).long() + m
    iy = torch.round(xy[:, 1]).long() + m
    x0 = torch.clamp(ix - RAW_PATCH // 2, 0, w + 2 * m - RAW_PATCH)
    y0 = torch.clamp(iy - RAW_PATCH // 2, 0, h + 2 * m - RAW_PATCH)
    fx = xy[:, 0] + m - x0.to(xy.dtype)
    fy = xy[:, 1] + m - y0.to(xy.dtype)
    patches = _slices(imgp, y0, x0, RAW_PATCH)
    # orientation: intensity centroid over the 31x31 disc
    mx, my = (torch.from_numpy(a).to(img.device) for a in _circular_masks())
    d = 2 * HALF_PATCH + 1
    lim = patches.shape[1] - d
    cx = torch.clamp(torch.round(fx).long() - HALF_PATCH, 0, lim)
    cy = torch.clamp(torch.round(fy).long() - HALF_PATCH, 0, lim)
    disc = _slices(patches, cy, cx, d)
    ang = torch.atan2(torch.einsum("nrc,rc->n", disc, my),
                      torch.einsum("nrc,rc->n", disc, mx))
    # 7x7 sigma-2 blur (valid), taps in order, then the steered pattern
    k = gaussian_kernel1d(BLUR_K, 2.0)
    o = RAW_PATCH - 2 * m
    out = None
    for i in range(BLUR_K):
        term = patches[:, i:i + o, :] * float(k[i])
        out = term if out is None else out + term
    x, out = out, None
    for i in range(BLUR_K):
        term = x[:, :, i:i + o] * float(k[i])
        out = term if out is None else out + term
    blurred = _q(out, lowp)
    pat = torch.from_numpy(_pattern()).to(img.device)
    ca, sa = torch.cos(ang), torch.sin(ang)
    pp = torch.cat([pat[:, 0:2], pat[:, 2:4]], dim=0)
    rx = pp[None, :, 0] * ca[:, None] - pp[None, :, 1] * sa[:, None]
    ry = pp[None, :, 0] * sa[:, None] + pp[None, :, 1] * ca[:, None]
    xi = torch.clamp(torch.round(rx + fx[:, None]).long() - m, 0, o - 1)
    yi = torch.clamp(torch.round(ry + fy[:, None]).long() - m, 0, o - 1)
    s = torch.gather(blurred.reshape(blurred.shape[0], -1), 1, yi * o + xi)
    bits = s[:, :256] < s[:, 256:]
    shifts = torch.arange(32, device=img.device, dtype=torch.int64)
    words = (bits.reshape(-1, 8, 32).long() << shifts).sum(dim=-1)
    desc = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return ang, desc.to(torch.int32)


def extract(gray, orb: dict, use_clahe: bool, lowp=False):
    """The feature set of one image: (uv [N, 2] level-0 pixels, level [N],
    desc [N, 8] int32, valid [N]), N = n_features, the levels in order."""
    img = gray.float()
    img = _q(clahe(img), lowp) if use_clahe else _q(img, lowp)
    levels = build_pyramid(img, orb["n_levels"], orb["scale_factor"], lowp)
    maps = fast_nms_levels(levels, orb["min_th_fast"], orb["ini_th_fast"],
                           lowp=lowp)
    quotas = per_level_quota(orb["n_features"], orb["scale_factor"],
                             orb["n_levels"])
    uvs, lvls, descs, valids = [], [], [], []
    for lvl, (lv_img, (s_lo, s_hi), quota) in enumerate(
            zip(levels, maps, quotas)):
        if quota == 0:
            continue
        xy, _, valid = detect_level(s_lo, s_hi, quota,
                                    cell_size=orb.get("cell_size", 32),
                                    per_cell_cap=orb.get("per_cell_cap", 8))
        _, desc = orient_and_describe(lv_img, xy, lowp)
        uvs.append(xy * orb["scale_factor"] ** lvl)
        lvls.append(torch.full((quota,), lvl, dtype=torch.int32,
                               device=img.device))
        descs.append(desc)
        valids.append(valid)
    return (torch.cat(uvs), torch.cat(lvls), torch.cat(descs),
            torch.cat(valids))
