"""GMS (grid-based motion statistics) match verification as dense grid
votes (port of geoflowslam_tpu/ops/gms.py).

20x20 grids on both images at 4 half-cell shifts; per shift the matches
vote into a [G^4] cell-pair table (one scatter-add), the aligned 3x3
neighbourhood score is 9 shifted adds of the [G, G, G, G] table, the
threshold is THRESH_FACTOR * sqrt(mean support), and the pass mask is
dilated by one cell on the right image. A match survives if it passes on
any shift. Votes are float counts, exact as in the reference.
"""
from __future__ import annotations

import torch

GRID = 20
THRESH_FACTOR = 6.0


def _cell_ids(uv, w, h, shift_x, shift_y):
    """Cell index per keypoint on one of the 4 half-cell-shifted grids."""
    cw, ch = w / GRID, h / GRID
    cx = torch.clamp(((uv[:, 0] + shift_x * cw / 2) / cw).to(torch.int32),
                     0, GRID - 1)
    cy = torch.clamp(((uv[:, 1] + shift_y * ch / 2) / ch).to(torch.int32),
                     0, GRID - 1)
    return (cy * GRID + cx).long()


def _shift_axis(x, d, axis):
    """x[..., i + d, ...] along `axis`, zero past the border."""
    if d == 0:
        return x
    n = x.shape[axis]
    idx = torch.arange(n, device=x.device)
    ok = (idx + d >= 0) & (idx + d < n)
    shape = [1] * x.dim()
    shape[axis] = n
    return torch.roll(x, -d, axis) * ok.reshape(shape).to(x.dtype)


def gms_filter(uv_a: torch.Tensor, uv_b: torch.Tensor, match_idx: torch.Tensor,
               size_a, size_b) -> torch.Tensor:
    """Filter matches by grid motion statistics.

    uv_a [N, 2] keypoints of image A, uv_b [M, 2] of image B, match_idx [N]
    into B or -1, size_a and size_b (w, h). Returns match_idx with -1 where
    rejected."""
    wa, ha = size_a
    wb, hb = size_b
    g2 = GRID * GRID
    valid = match_idx >= 0
    vf = valid.float()
    uvb = uv_b[torch.clamp_min(match_idx, 0).long()]
    keep_any = torch.zeros_like(valid)
    for shift in range(4):
        sx, sy = shift % 2, shift // 2
        ca = _cell_ids(uv_a, wa, ha, sx, sy)
        cb = _cell_ids(uvb, wb, hb, sx, sy)
        pair = ca * g2 + cb
        votes = torch.zeros((g2 * g2,), device=uv_a.device).index_add_(
            0, pair, vf)
        v4 = votes.reshape(GRID, GRID, GRID, GRID)            # [ay,ax,by,bx]
        f2 = torch.zeros((g2,), device=uv_a.device).index_add_(
            0, ca, vf).reshape(GRID, GRID)
        score = torch.zeros_like(v4)
        support = torch.zeros_like(f2)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                s4 = v4
                for axis, d in ((0, dy), (1, dx), (2, dy), (3, dx)):
                    s4 = _shift_axis(s4, d, axis)
                score = score + s4
                support = support + _shift_axis(_shift_axis(f2, dy, 0), dx, 1)
        thresh = THRESH_FACTOR * torch.sqrt(support / 9.0)
        cell_pass = (score > thresh[:, :, None, None]).float()
        dil = torch.zeros_like(cell_pass, dtype=torch.bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                dil = dil | _shift_axis(_shift_axis(cell_pass, dy, 2),
                                        dx, 3).bool()
        keep_any = keep_any | (dil.reshape(-1)[pair] & valid)
    return torch.where(keep_any, match_idx, -1)
