"""FAST corner detection + grid keypoint distribution (port of
geoflowslam_tpu/ops/fast.py).

`fast_score_maps` is the plain PyTorch version of the two-threshold FAST-9
stencil; `fast_scores_two` dispatches by device: CUDA tensors go to the
hand-written kernel (kernels/csrc/fast_scores.cu), CPU tensors to the plain
version. `fast_nms_levels` gives every pyramid level's two score maps after
non-maximum suppression and the border mask: one launch of the fused kernel
for CUDA tensors, `fast_nms_levels_plain` (the stencil, `nms3x3` and the
mask per level) for CPU ones. `detect_level` takes a level's two finished
maps and keeps the reference's per-cell top-k followed by a global top-k,
with ties broken by the lowest index as XLA's top_k does.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.ops.indexing import topk_stable

# Bresenham circle of radius 3: 16 (dy, dx) offsets, standard FAST-9/16 ring.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9: need >= 9 contiguous pixels


def _arc_ok(bits: torch.Tensor) -> torch.Tensor:
    """bits: int64 with ring membership in bits 0..15. Contiguous run >= 9
    on the circular ring by shift-AND folding."""
    m = bits | (bits << 16)
    t = m & (m >> 1)
    t = t & (t >> 2)
    t = t & (t >> 4)
    t = t & (m >> 8)
    return (t & 0xFFFF) != 0


def fast_score_maps(img: torch.Tensor, thresholds) -> list:
    """Dense FAST-9 responses of img [H, W] for several thresholds, sharing
    the 16-ring stencil: the sum over the ring of max(|diff| - t, 0) on the
    side whose contiguous arc passes, zero elsewhere and on a 3 px border."""
    h, w = img.shape
    r = 3
    pad = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    diffs = [pad[r + dy: r + dy + h, r + dx: r + dx + w] - img
             for dy, dx in _CIRCLE]
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


def fast_scores_two(img: torch.Tensor, th_lo: float, th_hi: float):
    """Two-threshold FAST responses: the CUDA kernel for a CUDA tensor (bit
    for bit equal to fast_score_maps), the plain version for a CPU one."""
    if img.is_cuda:
        return kernels.fast_scores(img.contiguous(), th_lo, th_hi)
    if img.device.type != "cpu":
        raise ValueError(f"fast_scores_two: unsupported device {img.device}")
    lo, hi = fast_score_maps(img, [th_lo, th_hi])
    return lo, hi


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (keeps scores >= all 8 neighbours)."""
    h, w = score.shape
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            m = torch.maximum(m, p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return torch.where(score >= m, score, 0.0)


def fast_nms_levels_plain(levels: Sequence[torch.Tensor], th_lo: float,
                          th_hi: float, border: int = 16
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Plain version of the fused kernel: per level the (low, high)
    threshold maps where(inside `border`, nms3x3(FAST score), 0)."""
    out = []
    for img in levels:
        h, w = img.shape
        ys = torch.arange(h, device=img.device)[:, None]
        xs = torch.arange(w, device=img.device)[None, :]
        inb = ((ys >= border) & (ys < h - border)
               & (xs >= border) & (xs < w - border))
        out.append(tuple(torch.where(inb, nms3x3(s), 0.0)
                         for s in fast_score_maps(img, [th_lo, th_hi])))
    return out


def fast_nms_levels(levels: Sequence[torch.Tensor], th_lo: float,
                    th_hi: float, border: int = 16
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Finished score maps of all pyramid levels: one launch of the fused
    CUDA kernel for CUDA tensors (bit for bit equal to the plain version),
    the plain version for CPU ones."""
    dev = levels[0].device
    if dev.type == "cuda":
        return kernels.fast_nms_levels([img.contiguous() for img in levels],
                                       th_lo, th_hi, border)
    if dev.type != "cpu":
        raise ValueError(f"fast_nms_levels: unsupported device {dev}")
    return fast_nms_levels_plain(levels, th_lo, th_hi, border)


class LevelKeypoints(NamedTuple):
    xy: torch.Tensor        # [N, 2] float32 (x, y) in level coords
    score: torch.Tensor     # [N]
    valid: torch.Tensor     # [N] bool


def detect_level(score_low: torch.Tensor, score_high: torch.Tensor,
                 n_keypoints: int, cell_size: int = 32,
                 per_cell_cap: int = 8) -> LevelKeypoints:
    """Up to n_keypoints FAST corners of one level with spatial balancing,
    from its finished maps at the low and the high threshold (a level's pair
    from fast_nms_levels): per-cell fallback to the low threshold where a
    cell has no strong corner, per-cell top-`per_cell_cap`, then global
    top-n."""
    h, w = score_low.shape
    dev = score_low.device
    ph = (h + cell_size - 1) // cell_size * cell_size
    pw = (w + cell_size - 1) // cell_size * cell_size
    sl = F.pad(score_low, (0, pw - w, 0, ph - h))
    sh = F.pad(score_high, (0, pw - w, 0, ph - h))
    ncy, ncx = ph // cell_size, pw // cell_size

    def cells(s):
        return (s.reshape(ncy, cell_size, ncx, cell_size)
                .permute(0, 2, 1, 3)
                .reshape(ncy * ncx, cell_size * cell_size))

    cl, ch = cells(sl), cells(sh)
    cell_has_high = torch.any(ch > 0, dim=1, keepdim=True)
    eligible = torch.where(cell_has_high, ch, cl)

    top_s, top_i = topk_stable(eligible, per_cell_cap)
    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    gy = (cell_ids // ncx) * cell_size + top_i // cell_size
    gx = (cell_ids % ncx) * cell_size + top_i % cell_size

    flat_s = top_s.reshape(-1)
    flat_y = gy.reshape(-1)
    flat_x = gx.reshape(-1)

    n = min(n_keypoints, flat_s.shape[0])
    sel_s, sel_i = topk_stable(flat_s, n)
    xy = torch.stack([flat_x[sel_i], flat_y[sel_i]], dim=-1).float()
    valid = sel_s > 0
    if n < n_keypoints:
        padn = n_keypoints - n
        xy = torch.cat([xy, xy.new_zeros((padn, 2))])
        sel_s = torch.cat([sel_s, sel_s.new_zeros((padn,))])
        valid = torch.cat([valid, valid.new_zeros((padn,))])
    return LevelKeypoints(xy=xy, score=sel_s, valid=valid)
