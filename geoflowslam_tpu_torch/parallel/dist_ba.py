"""Landmark-sharded global bundle adjustment over a device mesh (port of
geoflowslam_tpu/parallel/dist_ba.py).

The reference's global BA is one Gauss-Newton problem; scaled out it is the
distributed Schur trick:

* the landmarks (and their columns of the [K, M] observation grid) are cut
  into `mesh.size` contiguous shards, one per mesh device; the KF poses are
  replicated;
* each shard builds its landmarks' Hll blocks and its partial reduced
  camera system S = Hpp - Hpl Hll^-1 Hpl^T with its rhs, on its device;
* the one reduction: the partial [6K, 6K] systems and [6K] rhs are summed
  on the mesh's first device, in device order (a fixed order, so the result
  is deterministic), where the dense solve runs once;
* the pose step goes back to every shard device for the landmarks'
  back-substitution.

Like the JAX package, it is one process driving every device of the mesh
(`LandMesh`), not a process group: a SLAM system is one process, and the
mesh may name one device several times (N shards on one card run the same
sharded step and reduction). Solves use the *_ex variants and non-finite
steps are dropped on the device: no host read inside the loop. The
contractions are plain torch.einsum products, as the JAX package computes
them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch

from geoflowslam_tpu_torch.math import lie
from geoflowslam_tpu_torch.solvers.local_ba import BAProblem, chi2, residuals
from geoflowslam_tpu_torch.solvers.pose_opt import (HUBER_MONO, HUBER_STEREO,
                                                    huber_w)

AXIS = "land"

# BAProblem fields with a landmark dimension: its index in each
_LAND_DIM = dict(pts=0, pt_valid=0, uv=1, u_right=1, is_stereo=1,
                 inv_sigma2=1, obs_valid=1)


class LandMesh:
    """The devices that hold the landmark shards, in reduction order (the
    first one reduces and solves). A device may repeat."""

    def __init__(self, devices: Sequence[torch.device | str],
                 axis: str = AXIS):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("LandMesh needs at least one device")
        if (any(d.type == "cuda" for d in self.devices)
                and not torch.cuda.is_available()):
            raise RuntimeError("LandMesh: CUDA device requested but "
                               "torch.cuda.is_available() is False")
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"LandMesh({[str(d) for d in self.devices]}, {self.axis!r})"


def shard(prob: BAProblem, mesh: LandMesh) -> list:
    """The problem cut into the mesh's landmark shards, each on its device
    (KF fields replicated). M must be divisible by the mesh size."""
    m = prob.pts.shape[0]
    if m % mesh.size:
        raise ValueError(f"the landmark dimension {m} is not divisible by "
                         f"the mesh size {mesh.size}")
    ms = m // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        fields = {}
        for name, val in prob._asdict().items():
            dim = _LAND_DIM.get(name)
            if dim is not None:
                val = val.narrow(dim, i * ms, ms)
            fields[name] = val.to(dev)
        out.append(BAProblem(**fields))
    return out


def gather(shards: list, device) -> BAProblem:
    """The shards joined back along the landmark dimension on `device`
    (the KF fields from the first shard)."""
    fields = {}
    for name in BAProblem._fields:
        dim = _LAND_DIM.get(name)
        if dim is None:
            fields[name] = getattr(shards[0], name).to(device)
        else:
            fields[name] = torch.cat([getattr(s, name).to(device)
                                      for s in shards], dim)
    return BAProblem(**fields)


def _shard_partial(prob: BAProblem, fx, fy, cx, cy, bf, damping):
    """One shard's half of the GN step: its partial reduced system and rhs,
    and what its back-substitution needs."""
    r, jp, jl, behind = residuals(prob, fx, fy, cx, cy, bf)
    c2 = chi2(r, prob)
    delta = torch.where(prob.is_stereo, HUBER_STEREO, HUBER_MONO)
    active = prob.obs_valid & prob.pt_valid[None, :] & prob.kf_valid[:, None]
    w = huber_w(c2, delta) * prob.inv_sigma2 * (active & ~behind).float()
    row_mask = torch.stack([torch.ones_like(w), torch.ones_like(w),
                            prob.is_stereo.float()], dim=-1)
    wr = w[..., None] * row_mask

    k = prob.kf_rot.shape[0]
    hpp_local = torch.einsum("kmri,kmr,kmrj->kij", jp, wr, jp)
    hll = torch.einsum("kmri,kmr,kmrj->mij", jl, wr, jl)
    hpl = torch.einsum("kmri,kmr,kmrj->kmij", jp, wr, jl)
    bp_local = -torch.einsum("kmri,kmr->ki", jp, wr * r)
    bl = -torch.einsum("kmri,kmr->mi", jl, wr * r)

    tr = torch.diagonal(hll, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    hll = hll + (1e-3 * tr / 3.0 + damping) * torch.eye(
        3, dtype=hll.dtype, device=hll.device)
    hll_inv, _ = torch.linalg.inv_ex(hll)
    pt_active = (torch.sum(w, dim=0) > 0) & prob.pt_valid
    hll_inv = hll_inv * pt_active[:, None, None]

    s_local = hpp_local_to_s(hpp_local, hpl, hll_inv, k)
    rhs_local = bp_local - torch.einsum("kmij,mjl,ml->ki", hpl, hll_inv, bl)
    return s_local, rhs_local, (hpl, hll_inv, bl, pt_active)


def hpp_local_to_s(hpp_local, hpl, hll_inv, k):
    """A shard's partial reduced system [K, 6, K, 6]: its landmarks' Schur
    term, plus Hpp of its own observations on the diagonal blocks (so the
    shards' partials sum to the full S)."""
    s = -torch.einsum("kmij,mjl,qmrl->kiqr", hpl, hll_inv, hpl)
    ar = torch.arange(k, device=s.device)
    s[ar, :, ar, :] = s[ar, :, ar, :] + hpp_local
    return s


def _solve_poses(s, rhs, prob: BAProblem, damping):
    """The reduced system's solve on the reducing device: fixed and invalid
    KFs masked out with a unit diagonal, the step dropped when non-finite.
    Returns dp [K, 6]."""
    k = prob.kf_rot.shape[0]
    dev = s.device
    free = (prob.kf_valid & ~prob.kf_fixed).float()
    fm = free[:, None]
    s = s * fm[:, :, None, None] * free[None, None, :, None]
    sd = s.reshape(k * 6, k * 6)
    diag_fix = (1.0 - fm * torch.ones((k, 6), device=dev)).reshape(-1)
    sd = sd + torch.diag(diag_fix) + damping * torch.eye(k * 6, device=dev)
    rhs = (rhs * fm).reshape(-1)
    dp, _ = torch.linalg.solve_ex(sd, rhs)
    dp = dp.reshape(k, 6) * fm
    return torch.where(torch.all(torch.isfinite(dp)), dp, 0.0)


def _sharded_gn_step(shards: list, mesh: LandMesh, fx, fy, cx, cy, bf,
                     damping=1e-6) -> list:
    """One GN step over the shards (each on its mesh device); returns the
    updated shards."""
    parts = [_shard_partial(p, fx, fy, cx, cy, bf, damping) for p in shards]
    red = mesh.devices[0]
    # the one reduction, in device order
    s = parts[0][0].to(red)
    rhs = parts[0][1].to(red)
    for s_i, rhs_i, _ in parts[1:]:
        s = s + s_i.to(red)
        rhs = rhs + rhs_i.to(red)
    p0 = shards[0]
    dp = _solve_poses(s, rhs, p0, damping)
    dr_rot, dr_t = lie.se3_exp(dp)
    new_rot = lie.normalize_rotation(
        torch.einsum("kij,kjl->kil", dr_rot, p0.kf_rot))
    new_t = torch.einsum("kij,kj->ki", dr_rot, p0.kf_t) + dr_t
    out = []
    for p, (_, _, (hpl, hll_inv, bl, pt_active)) in zip(shards, parts):
        dev = p.pts.device
        dp_i = dp.to(dev)
        dl = torch.einsum("mij,mj->mi", hll_inv,
                          bl - torch.einsum("kmij,ki->mj", hpl, dp_i))
        # per shard, as the JAX package's shard_map checks its local block
        dl = torch.where(torch.all(torch.isfinite(dl)), dl, 0.0)
        out.append(p._replace(kf_rot=new_rot.to(dev), kf_t=new_t.to(dev),
                              pts=p.pts + dl * pt_active[:, None]))
    return out


def make_distributed_ba(mesh: LandMesh, fx, fy, cx, cy, bf=0.0,
                        iters: int = 10):
    """fn(prob) -> prob: `iters` landmark-sharded GN steps over `mesh`
    (Huber kernel on every step, the fixed KFs held). The input's landmark
    dimension must be divisible by the mesh size; the result is gathered
    onto the input's device."""

    def fn(prob: BAProblem) -> BAProblem:
        shards = shard(prob, mesh)
        for _ in range(iters):
            shards = _sharded_gn_step(shards, mesh, fx, fy, cx, cy, bf)
        return gather(shards, prob.pts.device)

    return fn


def reduced_bytes(k: int, mesh: LandMesh, itemsize: int = 4) -> int:
    """Bytes summed on the reducing device per iteration: every shard's
    partial [6K, 6K] system and [6K] rhs."""
    return mesh.size * (36 * k * k + 6 * k) * itemsize
