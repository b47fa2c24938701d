"""Symmetric eigendecompositions that never synchronise with the host.

`torch.linalg.eigh` and `torch.linalg.svd` check their solver's status on
CUDA, which waits for the device. The frame step needs them where it must
not wait, so it takes these instead:

* `eigvals3`: the eigenvalues of [..., 3, 3] by the trigonometric method
  (also the lidar planes' and the loop closer's);
* `eigh3`: [..., 3, 3] in closed form (eigvals3 in float64, eigenvectors
  from cross products of the shifted matrix's columns, the better-separated
  end first, the rest completed orthonormally, so repeated eigenvalues
  still give a basis);
* `eigh_jacobi`: [..., n, n] by a fixed number of parallel cyclic Jacobi
  sweeps (round-robin pair order: every round rotates n/2 disjoint pairs at
  once, n - 1 rounds a sweep); n odd is padded with a decoupled zero row;
* `null_vector`: the right singular vector of the smallest singular value
  of [..., m, n] batches (the smallest eigenvector of A^T A, in float64);
* `drop_smallest_singular3`: the nearest rank-2 matrix of [..., 3, 3];
* `svd3`: the SVD of [..., 3, 3] from the closed form of m^T m.

All return ascending eigenvalues with eigenvectors as columns, as eigh does.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

JACOBI_SWEEPS = 8     # float64: eigenvalues within 1e-14 of eigh's (of the
                      # norm) for n <= 12 and ~1e-8 for n = 15 at cond 1e8
                      # (tests/test_torch_sym_eig.py)

_SCHEDULES: Dict[Tuple[int, str], tuple] = {}


def _det3(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2]
                            - b[..., 1, 2] * b[..., 2, 1])
            - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2]
                              - b[..., 1, 2] * b[..., 2, 0])
            + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1]
                              - b[..., 1, 1] * b[..., 2, 0]))


def eigvals3(a: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues [..., 3] of symmetric [..., 3, 3] (the
    trigonometric method)."""
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    p1 = a[..., 0, 1] ** 2 + a[..., 0, 2] ** 2 + a[..., 1, 2] ** 2
    d = torch.stack([a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]], dim=-1)
    p2 = torch.sum((d - q[..., None]) ** 2, dim=-1) + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    b = (a - q[..., None, None] * eye) / p[..., None, None]
    phi = torch.arccos(torch.clamp(0.5 * _det3(b), -1.0, 1.0)) / 3.0
    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return torch.stack([lam_min, lam_mid, lam_max], dim=-1)


def kernel_direction3(m: torch.Tensor) -> torch.Tensor:
    """The largest cross product of two columns of [..., 3, 3] (a vector
    of m's null space when m has rank 2; not normalized)."""
    c0, c1, c2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    cands = torch.stack([torch.linalg.cross(c0, c1),
                         torch.linalg.cross(c0, c2),
                         torch.linalg.cross(c1, c2)], dim=-2)
    best = torch.argmax(torch.linalg.norm(cands, dim=-1), dim=-1,
                        keepdim=True)
    return torch.gather(cands, -2, best[..., None].expand(
        *best.shape[:-1], 1, 3)).squeeze(-2)


def _unit(v: torch.Tensor, fallback: torch.Tensor, tiny: float):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return torch.where(n > tiny, v / torch.clamp_min(n, tiny), fallback)


def _orthogonal_to(u: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to the unit vector u: u x e_k with e_k the
    axis least aligned with u."""
    k = torch.argmin(torch.abs(u), dim=-1, keepdim=True)
    e = torch.zeros_like(u).scatter_(-1, k, 1.0)
    w = torch.linalg.cross(u, e)
    return w / torch.clamp_min(torch.linalg.norm(w, dim=-1, keepdim=True),
                               1e-30)


def eigh3(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ascending eigenvalues [..., 3], eigenvectors [..., 3, 3] as columns)
    of symmetric [..., 3, 3], closed form. The eigenvector of the end
    eigenvalue with the wider gap comes from its shifted matrix's null
    space, the other end's is made orthogonal to it, the middle one is
    their cross product; isotropic inputs give the identity. Computed in
    float64 (the trigonometric method loses ~sqrt(eps) near a double
    eigenvalue), returned in a's dtype."""
    dtype = a.dtype
    a = a.to(torch.float64)
    vals = eigvals3(a)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    tiny = 1e-150
    lo, hi = vals[..., 0], vals[..., 2]
    v_lo = kernel_direction3(a - lo[..., None, None] * eye)
    v_hi = kernel_direction3(a - hi[..., None, None] * eye)
    v_lo = _unit(v_lo, eye[2].expand_as(v_lo), tiny)
    v_hi = _unit(v_hi, eye[0].expand_as(v_hi), tiny)
    # trust the end whose eigenvalue is farther from the middle one
    hi_first = (hi - vals[..., 1]) >= (vals[..., 1] - lo)
    first = torch.where(hi_first[..., None], v_hi, v_lo)
    other = torch.where(hi_first[..., None], v_lo, v_hi)
    other = other - torch.sum(other * first, -1, keepdim=True) * first
    other = _unit(other, _orthogonal_to(first), 1e-3)
    v_hi = torch.where(hi_first[..., None], first, other)
    v_lo = torch.where(hi_first[..., None], other, first)
    v_mid = torch.linalg.cross(v_hi, v_lo)
    vecs = torch.stack([v_lo, v_mid, v_hi], dim=-1)
    iso = (hi - lo) <= 1e-12 * torch.clamp_min(
        torch.maximum(torch.abs(hi), torch.abs(lo)), tiny)
    vecs = torch.where(iso[..., None, None], eye.expand_as(vecs), vecs)
    return vals.to(dtype), vecs.to(dtype)


def _schedule(m: int, device) -> tuple:
    """Round-robin pairs of m (even) indices, cached per device: (index of
    [p, p], [q, q], [p, q] in the flattened matrix per round [R, 3 m/2],
    index of [p, p], [q, q], [p, q], [q, p] per round [R, 2 m])."""
    key = (m, str(device))
    if key not in _SCHEDULES:
        players = list(range(m))
        gather, scatter = [], []
        for _ in range(m - 1):
            p = [players[i] for i in range(m // 2)]
            q = [players[m - 1 - i] for i in range(m // 2)]
            gather.append([i * m + i for i in p] + [j * m + j for j in q]
                          + [i * m + j for i, j in zip(p, q)])
            scatter.append([i * m + i for i in p] + [j * m + j for j in q]
                           + [i * m + j for i, j in zip(p, q)]
                           + [j * m + i for i, j in zip(p, q)])
            players = [players[0], players[-1]] + players[1:-1]
        # one copy at first use per device and size: the frame step's
        # sizes are all warmed before it runs on the card
        _SCHEDULES[key] = (torch.tensor(gather).to(device),
                           torch.tensor(scatter).to(device))
    return _SCHEDULES[key]


def eigh_jacobi(a: torch.Tensor, sweeps: int = JACOBI_SWEEPS
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ascending eigenvalues [..., n], eigenvectors [..., n, n] as columns)
    of symmetric [..., n, n] by `sweeps` parallel cyclic Jacobi sweeps in
    torch ops, in a's dtype. Each rotation zeroes its pair's off-diagonal
    entry with the inner angle (|theta| <= pi / 4)."""
    n = a.shape[-1]
    m = n + (n % 2)
    batch = a.shape[:-2]
    a = 0.5 * (a + a.transpose(-1, -2))
    if m != n:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    a = a.reshape(-1, m, m)
    b = a.shape[0]
    gidx, sidx = _schedule(m, a.device)
    eye = torch.eye(m, dtype=a.dtype, device=a.device).expand(b, m, m)
    v = eye
    eye_flat = eye.reshape(b, m * m)
    h = m // 2
    for _ in range(sweeps):
        for r in range(m - 1):
            g = a.reshape(b, m * m).index_select(1, gidx[r])
            app, aqq, apq = g[:, :h], g[:, h:2 * h], g[:, 2 * h:]
            # tan(2 theta) = 2 a_pq / (a_qq - a_pp) zeroes a_pq; the inner
            # angle (|theta| <= pi / 4), which cyclic Jacobi needs to
            # converge: atan2 over |a_qq - a_pp|, the sign moved up
            d = aqq - app
            theta = 0.5 * torch.atan2(
                2.0 * apq * torch.copysign(torch.ones_like(d), d),
                torch.abs(d))
            c, s = torch.cos(theta), torch.sin(theta)
            j = eye_flat.index_copy(
                1, sidx[r], torch.cat([c, c, s, -s], dim=1)).reshape(b, m, m)
            a = j.transpose(1, 2) @ a @ j
            v = v @ j
    vals = torch.diagonal(a, dim1=1, dim2=2)
    if m != n:
        # the padded coordinate never couples: drop its row, column and
        # eigenpair (the one whose vector sits on it)
        keep = torch.argsort(torch.abs(v[:, n, :]), dim=1, stable=True)[:, :n]
        vals = torch.gather(vals, 1, keep)
        v = torch.gather(v[:, :n, :], 2, keep[:, None, :].expand(b, n, n))
    order = torch.argsort(vals, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    v = torch.gather(v, 2, order[:, None, :].expand(b, n, n))
    return vals.reshape(*batch, n), v.reshape(*batch, n, n)


def null_vector(a: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Unit right singular vector [..., n] of the smallest singular value of
    [..., m, n] (sign as the eigensolver leaves it), from A^T A in float64;
    returned in a's dtype."""
    a64 = a.to(torch.float64)
    _, vecs = eigh_jacobi(a64.transpose(-1, -2) @ a64, sweeps)
    return vecs[..., :, 0].to(a.dtype)


def drop_smallest_singular3(f: torch.Tensor) -> torch.Tensor:
    """The nearest rank-2 matrix of [..., 3, 3] (Frobenius): f (I - v v^T)
    with v the right singular vector of the smallest singular value, the
    smallest eigenvector of f^T f, in float64."""
    f64 = f.to(torch.float64)
    _, vecs = eigh3(f64.transpose(-1, -2) @ f64)
    v = vecs[..., :, 0]
    return (f64 - (f64 @ v[..., :, None]) * v[..., None, :]).to(f.dtype)


def svd3(m: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, s, V^T) of [..., 3, 3] as torch.linalg.svd returns them (s >= 0,
    descending), in float64 from m^T m = V diag(s^2) V^T: u_i = m v_i / s_i,
    the second made orthogonal to the first, the third their cross product
    with the sign that keeps s_3 >= 0."""
    m64 = m.to(torch.float64)
    vals, v = eigh3(m64.transpose(-1, -2) @ m64)
    v = torch.flip(v, dims=[-1])                       # descending
    s = torch.sqrt(torch.clamp_min(torch.flip(vals, dims=[-1]), 0.0))
    mv = m64 @ v
    e = torch.eye(3, dtype=mv.dtype, device=mv.device)[0]
    u0 = _unit(mv[..., :, 0], e.expand_as(mv[..., :, 0]), 1e-300)
    u1 = mv[..., :, 1] - torch.sum(mv[..., :, 1] * u0, -1, keepdim=True) * u0
    u1 = _unit(u1, _orthogonal_to(u0), 1e-300)
    u2 = torch.linalg.cross(u0, u1)
    u2 = torch.where(torch.sum(u2 * mv[..., :, 2], -1, keepdim=True) < 0,
                     -u2, u2)
    u = torch.stack([u0, u1, u2], dim=-1)
    return (u.to(m.dtype), s.to(m.dtype),
            v.transpose(-1, -2).to(m.dtype))
