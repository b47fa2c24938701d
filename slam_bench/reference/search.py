"""Plain reference of the gated best/second descriptor search by
projection (what K2, gated_hamming_search, computes).

A frozen copy of the plain versions in geoflowslam_tpu_torch/ops/
matching.py (hamming_matrix, _best_two, gated_hamming_plain), in plain
PyTorch, the distances by a popcount table. It imports nothing of the
program. `lowp=True` rounds the query and target positions and the radii
to bfloat16 before the spatial gate: the comparison's control.
"""
from __future__ import annotations

import torch

BIG = 1 << 20


def _q(x, lowp):
    return x.to(torch.bfloat16).float() if lowp else x


def hamming_matrix(desc_a, desc_b):
    """[N, 8] x [M, 8] int32 words -> [N, M] int32 Hamming distances: the
    popcount of each XOR byte from a table, 256 query rows at a time."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int32, device=desc_a.device)
    a = desc_a.contiguous().view(torch.uint8).long()
    b = desc_b.contiguous().view(torch.uint8).long()
    rows = [lut[a[i:i + 256, None, :] ^ b[None, :, :]].sum(dim=-1)
            for i in range(0, a.shape[0], 256)]
    if not rows:
        return torch.zeros((0, b.shape[0]), dtype=torch.int32,
                           device=desc_a.device)
    return torch.cat(rows).to(torch.int32)


def best_two(dist):
    """Per row (best, second, index of best), ties to the lowest index."""
    m = dist.shape[1]
    best = dist.min(dim=1).values
    cols = torch.arange(m, device=dist.device)
    bidx = torch.where(dist == best[:, None], cols, m).min(dim=1).values
    second = torch.where(cols[None, :] == bidx[:, None], BIG,
                         dist).min(dim=1).values
    return best, second, bidx


def gated_search(uv_q, level_q, valid_q, desc_q, radius, uv_t, level_t,
                 valid_t, desc_t, min_off, max_off, lowp=False):
    """(best, second, idx) int32 per query row; (BIG, BIG, -1) where no
    target passes the spatial, octave and validity gates."""
    d = _q(uv_q, lowp)[:, None, :] - _q(uv_t, lowp)[None, :, :]
    r = _q(radius, lowp)[:, None]
    mask = (torch.abs(d[..., 0]) <= r) & (torch.abs(d[..., 1]) <= r)
    dl = level_t.long()[None, :] - level_q.long()[:, None]
    mask &= (dl >= min_off) & (dl <= max_off)
    mask &= valid_q[:, None] & valid_t[None, :]
    dist = torch.where(mask, hamming_matrix(desc_q, desc_t), BIG)
    best, second, bidx = best_two(dist)
    idx = torch.where(best < BIG, bidx, -1)
    return best.to(torch.int32), second.to(torch.int32), idx.to(torch.int32)
