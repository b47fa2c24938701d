"""Descriptor matching (port of geoflowslam_tpu/ops/matching.py).

Descriptors are [N, 8] int32 tensors holding the 256 bits of the reference's
[N, 8] uint32 words (torch's uint32 supports few ops; the bits are the
same). `hamming_matrix` is the plain dense version. Two searches dispatch
by device, CUDA tensors to a hand-written kernel and CPU tensors to the
plain version:
* `search_by_projection`'s gated best/second search: the kernel
  kernels/csrc/gated_hamming.cu, the plain `gated_hamming_plain` (the mask
  path of the reference's XLA branch: spatial_mask, level_mask,
  match_descriptors(mutual=False));
* `match_descriptors_many` (and `match_descriptors` without a mask, its
  one-pair case): the best/second search of every pair and, with `mutual`,
  the swapped search whose argbest is the mutual check, all in one launch
  of the kernel kernels/csrc/hamming_best2.cu; the plain
  `hamming_best2_plain` per search. With a mask `match_descriptors` stays
  on the plain path on either device: no TPU kernel computes it.
The ratio, max-distance and mutual tests stay here around either.
"""
from __future__ import annotations

import math

import torch

from geoflowslam_tpu_torch import kernels
from geoflowslam_tpu_torch.config import TH_HIGH, TH_LOW
from geoflowslam_tpu_torch.ops.indexing import topk_stable

BIG = 1 << 20   # distance of a pair that no gate lets through
HISTO_LENGTH = 30


def unpack_bits_pm1(desc: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] float32 in {-1, +1} (bit j of word w is
    element 32 w + j)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    bits = (desc.long()[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).float() * 2.0 - 1.0


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N,8] x [M,8] -> [N,M] int32 Hamming distances. With a, b in
    {-1,+1}^256, dot = 256 - 2 hamming; the float32 sums of +-1 are exact."""
    a = unpack_bits_pm1(desc_a)
    b = unpack_bits_pm1(desc_b)
    return ((256.0 - a @ b.T) * 0.5).to(torch.int32)


def _best_two(dist: torch.Tensor):
    """Per-row best and second-best distance and the best's index, ties to
    the lowest index (jax.lax.top_k(-dist, 2))."""
    m = dist.shape[1]
    best = dist.min(dim=1).values
    cols = torch.arange(m, device=dist.device)
    bidx = torch.where(dist == best[:, None], cols, m).min(dim=1).values
    second = torch.where(cols[None, :] == bidx[:, None], BIG,
                         dist).min(dim=1).values
    return best, second, bidx


def hamming_best2_plain(desc_q, valid_q, desc_t, valid_t):
    """Plain version of the ungated best-two kernel: (best, second, idx)
    int32 per query row, a pair with an invalid side at BIG, ties to the
    lowest index, (BIG, BIG, 0) for a row with no valid pair."""
    invalid = (~valid_q[:, None]) | (~valid_t[None, :])
    dist = torch.where(invalid, BIG, hamming_matrix(desc_q, desc_t))
    best, second, bidx = _best_two(dist)
    return best.to(torch.int32), second.to(torch.int32), bidx.to(torch.int32)


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """x as a contiguous `dtype` tensor, converted only where it is not."""
    if x.dtype is not dtype or not x.is_contiguous():
        x = x.to(dtype).contiguous()
    return x


def hamming_best2_many(searches):
    """Device dispatch of ungated searches [(desc_q, valid_q, desc_t,
    valid_t), ...]: one kernel launch on CUDA, the plain version search by
    search on CPU. Returns one (best, second, idx) per search."""
    dev = searches[0][0].device
    if dev.type == "cuda":
        return kernels.hamming_best2_many(
            [(_as(dq, torch.int32), _as(vq, torch.bool),
              _as(dt, torch.int32), _as(vt, torch.bool))
             for dq, vq, dt, vt in searches], BIG)
    if dev.type != "cpu":
        raise ValueError(f"hamming_best2_many: unsupported device {dev}")
    return [hamming_best2_plain(*s) for s in searches]


def hamming_best2(desc_q, valid_q, desc_t, valid_t):
    """One ungated search: hamming_best2_many's one-search case."""
    return hamming_best2_many([(desc_q, valid_q, desc_t, valid_t)])[0]


def _ratio_mutual(best, second, bidx, b_best_a, max_dist, ratio):
    """The max-distance and ratio tests and, where b_best_a (B's best A per
    B row) is given, the mutual check. Returns (match_idx, match_dist)."""
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    if b_best_a is not None:
        rows = torch.arange(best.shape[0], device=best.device)
        ok = ok & (b_best_a[bidx.long()] == rows)
    return (torch.where(ok, bidx, -1).to(torch.int32),
            torch.where(ok, best, BIG).to(torch.int32))


def match_descriptors_many(pairs, max_dist=TH_LOW, ratio: float = 0.9,
                           mutual: bool = True):
    """match_descriptors without a mask for every (desc_a, valid_a, desc_b,
    valid_b) of `pairs`, with the searches of all pairs and both directions
    in one kernel launch on CUDA. Returns one (match_idx, match_dist) per
    pair, equal to match_descriptors on that pair."""
    pairs = list(pairs)
    searches = pairs + ([(b, vb, a, va) for a, va, b, vb in pairs]
                        if mutual else [])
    res = hamming_best2_many(searches)
    return [_ratio_mutual(*res[p], res[len(pairs) + p][2] if mutual else None,
                          max_dist, ratio)
            for p in range(len(pairs))]


def match_descriptors(desc_a, valid_a, desc_b, valid_b, max_dist=TH_LOW,
                      ratio: float = 0.9, mutual: bool = True, mask=None):
    """Nearest-neighbour Hamming match with the ratio test and an optional
    mutual check (B's best A must be this row). Returns (match_idx [N] into
    B or -1, match_dist [N])."""
    if mask is None:
        return match_descriptors_many([(desc_a, valid_a, desc_b, valid_b)],
                                      max_dist, ratio, mutual)[0]
    invalid = (~valid_a[:, None]) | (~valid_b[None, :]) | (~mask)
    dist = torch.where(invalid, BIG, hamming_matrix(desc_a, desc_b))
    best, second, bidx = _best_two(dist)
    b_best_a = torch.argmin(dist.T, dim=1) if mutual else None
    return _ratio_mutual(best, second, bidx, b_best_a, max_dist, ratio)


def rotation_consistency(angles_a, angles_b, match_idx, n_keep: int = 3):
    """Keep matches whose angle difference falls in the top-`n_keep` bins of
    a HISTO_LENGTH-bin rotation histogram (ORBmatcher's CheckOrientation)."""
    valid = match_idx >= 0
    idx_safe = torch.clamp_min(match_idx, 0).long()
    rot = torch.remainder(angles_a - angles_b[idx_safe], 2 * math.pi)
    bins = torch.clamp((rot * (HISTO_LENGTH / (2 * math.pi))).to(torch.int32),
                       0, HISTO_LENGTH - 1).long()
    hist = torch.zeros((HISTO_LENGTH,), dtype=torch.int32,
                       device=match_idx.device)
    hist = hist.index_add(0, bins, valid.to(torch.int32))
    top_vals, top_idx = topk_stable(hist, n_keep)
    keep_bin = torch.zeros((HISTO_LENGTH,), dtype=torch.bool,
                           device=match_idx.device)
    keep_bin[top_idx] = top_vals > 0
    return torch.where(valid & keep_bin[bins], match_idx, -1)


def spatial_mask(uv_query, uv_target, radius):
    """[N,2] query centres vs [M,2] targets, per-query radius [N] -> [N,M]."""
    d = uv_query[:, None, :] - uv_target[None, :, :]
    r = radius[:, None]
    return (torch.abs(d[..., 0]) <= r) & (torch.abs(d[..., 1]) <= r)


def level_mask(level_query, level_target, min_off: int = 0, max_off: int = 1):
    """Octave gate: target level within [pred + min_off, pred + max_off]."""
    d = level_target[None, :] - level_query[:, None]
    return (d >= min_off) & (d <= max_off)


def gated_hamming_plain(uv_q, level_q, valid_q, desc_q, radius,
                        uv_t, level_t, valid_t, desc_t,
                        min_off: int, max_off: int):
    """Plain version of the gated search kernel: (best, second, idx) int32,
    (BIG, BIG, -1) where no target passes the gates."""
    mask = spatial_mask(uv_q, uv_t, radius)
    mask = mask & level_mask(level_q, level_t, min_off, max_off)
    mask = mask & valid_q[:, None] & valid_t[None, :]
    dist = torch.where(mask, hamming_matrix(desc_q, desc_t), BIG)
    best, second, bidx = _best_two(dist)
    idx = torch.where(best < BIG, bidx, -1)
    return best.to(torch.int32), second.to(torch.int32), idx.to(torch.int32)


def gated_hamming(uv_q, level_q, valid_q, desc_q, radius,
                  uv_t, level_t, valid_t, desc_t, min_off: int, max_off: int):
    """Device dispatch of the gated search: kernel on CUDA, plain on CPU."""
    if uv_q.is_cuda:
        f32, i32, b = torch.float32, torch.int32, torch.bool
        return kernels.gated_hamming_search(
            _as(uv_q, f32), _as(level_q, i32), _as(valid_q, b),
            _as(desc_q, i32), _as(radius, f32), _as(uv_t, f32),
            _as(level_t, i32), _as(valid_t, b), _as(desc_t, i32),
            min_off, max_off, BIG)
    if uv_q.device.type != "cpu":
        raise ValueError(f"gated_hamming: unsupported device {uv_q.device}")
    return gated_hamming_plain(uv_q, level_q, valid_q, desc_q, radius,
                               uv_t, level_t, valid_t, desc_t,
                               min_off, max_off)


def search_by_projection(uv_proj, level_pred, valid_proj, desc_query, feat_uv,
                         feat_level, feat_desc, feat_valid, radius,
                         max_dist=TH_HIGH, ratio=0.9,
                         min_off: int = -1, max_off: int = 1):
    """Search by projection (ORBmatcher::SearchByProjection): the gated
    best/second search, then the max-distance and ratio tests.
    Returns (match_idx [N] into the target features or -1, dist [N])."""
    best, second, bidx = gated_hamming(
        uv_proj, level_pred, valid_proj, desc_query, radius,
        feat_uv, feat_level, feat_valid, feat_desc, min_off, max_off)
    ok = ((bidx >= 0) & (best <= max_dist)
          & (best.float() <= ratio * second.float()))
    return (torch.where(ok, bidx, -1).to(torch.int32),
            torch.where(ok, best, BIG).to(torch.int32))
