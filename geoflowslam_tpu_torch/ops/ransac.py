"""Batched fundamental-matrix RANSAC (port of the F part of
geoflowslam_tpu/ops/ransac.py): a fixed batch of hypotheses from 8-point
minimal sets, each solved by SVD and scored over all points at once, with
the reference's chi-square scoring.

Minimal sets are drawn by Gumbel top-k from an explicit torch.Generator;
ties go to the lowest index, as jax.lax.top_k breaks them. The draws cannot
equal jax.random's, so `ransac_fundamental` also takes the sets themselves
(`sample_sets`) and `_sample_minimal_sets` the Gumbel noise, for tests that
hand both packages the same draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoflowslam_tpu_torch.ops.indexing import topk_stable


class RansacResult(NamedTuple):
    model: torch.Tensor      # best model parameters
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int
    score: torch.Tensor      # [] float (model score)


def _sample_minimal_sets(gen: Optional[torch.Generator], valid: torch.Tensor,
                         n_hyp: int, set_size: int,
                         noise: Optional[torch.Tensor] = None):
    """[n_hyp, set_size] distinct indices drawn from the valid entries by
    per-hypothesis Gumbel top-k; `noise` [n_hyp, N] replaces the draw."""
    if noise is None:
        u = torch.rand((n_hyp, valid.shape[0]), generator=gen,
                       device=valid.device)
        noise = -torch.log(-torch.log(
            torch.clamp_min(u, torch.finfo(torch.float32).tiny)))
    g = torch.where(valid[None, :], noise, float("-inf"))
    return topk_stable(g, set_size)[1]


def _normalize_2d(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: zero mean, mean distance sqrt(2). Returns the
    normalized points and the 3x3 transform."""
    w = valid.to(pts.dtype)
    n = torch.clamp_min(torch.sum(w), 1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    d = torch.linalg.norm(pts - mean, dim=1)
    md = torch.sum(d * w) / n
    s = (2.0 ** 0.5) / torch.clamp_min(md, 1e-9)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    t = torch.stack([torch.stack([s, zero, -s * mean[0]]),
                     torch.stack([zero, s, -s * mean[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, t


def _solve_f_8pt(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point F from [K, 8, 2] x [K, 8, 2] normalized points, rank 2
    enforced. Returns [K, 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)            # [K, 8, 9]
    vt = torch.linalg.svd(a, full_matrices=True)[2]
    f = vt[..., 8, :].reshape(-1, 3, 3)
    u, s, vt2 = torch.linalg.svd(f)
    s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=1)
    return u @ torch.diag_embed(s) @ vt2


def _epipolar_dist2(f: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Squared epipolar transfer distances (image 1, image 2), pixels^2, of
    [N] point pairs under [K, 3, 3] models -> two [K, N]."""
    ones = torch.ones((p1.shape[0], 1), dtype=p1.dtype, device=p1.device)
    h1 = torch.cat([p1, ones], dim=1)
    h2 = torch.cat([p2, ones], dim=1)
    l2 = h1 @ f.transpose(-1, -2)       # epilines in image 2, [K, N, 3]
    l1 = h2 @ f                         # epilines in image 1
    num = torch.sum(h2 * l2, dim=-1) ** 2
    d2 = num / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d1 = num / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return d1, d2


def ransac_fundamental(gen: Optional[torch.Generator], uv1: torch.Tensor,
                       uv2: torch.Tensor, valid: torch.Tensor,
                       n_hyp: int = 128, threshold: float = 3.84,
                       sigma: float = 1.0,
                       sample_sets: Optional[torch.Tensor] = None
                       ) -> RansacResult:
    """F-RANSAC with TwoViewReconstruction::CheckFundamental's scoring:
    per point th_score - chi2 for chi2 < threshold * sigma^2, both
    directions. `sample_sets` [n_hyp, 8] replaces the draw from `gen`."""
    uv1n, t1 = _normalize_2d(uv1, valid)
    uv2n, t2 = _normalize_2d(uv2, valid)
    idx = (sample_sets if sample_sets is not None
           else _sample_minimal_sets(gen, valid, n_hyp, 8))
    fs_n = _solve_f_8pt(uv1n[idx], uv2n[idx])
    fs = t2.T @ fs_n @ t1                       # F = T2^T Fn T1
    th = threshold * sigma * sigma
    th_score = 5.991 * sigma * sigma
    d1, d2 = _epipolar_dist2(fs, uv1, uv2)
    in1 = (d1 < th) & valid
    in2 = (d2 < th) & valid
    inls = in1 & in2
    scores = torch.sum(torch.where(in1, th_score - d1, 0.0)
                       + torch.where(in2, th_score - d2, 0.0), dim=1)
    best = torch.argmax(scores)
    return RansacResult(fs[best], inls[best], torch.sum(inls[best]),
                        scores[best])
